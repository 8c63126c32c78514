"""Training of the port: the LDM trainer, its LR schedules and checkpoints."""
