"""The generation route's diffusion pieces: schedules, the DDIM sampler, the
latent-diffusion model and the slice sampler."""
