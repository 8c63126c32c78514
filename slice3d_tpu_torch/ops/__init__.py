"""Tensor ops of the main path (plain PyTorch) and the hand-written kernels."""
