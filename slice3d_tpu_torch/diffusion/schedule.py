"""Diffusion noise schedules and DDIM subsequence parameters.

Matches the reference math exactly (gen_slices/ldm/modules/diffusionmodules/
util.py:21-75 and ddpm.py:118-170): the 'linear' schedule is a linspace in
sqrt(beta) space; DDIM uses the uniform timestep subset {0, c, 2c, ...}+1
with sigma_t = eta * sqrt((1-a_prev)/(1-a) * (1-a/a_prev)).

All tables are computed in float64 with numpy and stored as float32, as in
the JAX package (``slice3d_tpu/diffusion/schedule.py``, copied here so the
port imports nothing of it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["make_beta_schedule", "DiffusionSchedule", "DDIMParams"]


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    if schedule == "linear":
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                           dtype=np.float64) ** 2
    if schedule == "cosine":
        t = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(t / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        return np.clip(betas, 0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"unknown schedule '{schedule}'")


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    @classmethod
    def create(
        cls,
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
        v_posterior: float = 0.0,
    ) -> "DiffusionSchedule":
        betas = make_beta_schedule(
            beta_schedule, timesteps, linear_start, linear_end, cosine_s
        )
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = (1 - v_posterior) * betas * (1 - ac_prev) / (1 - ac) + v_posterior * betas
        with np.errstate(divide="ignore"):
            lvlb = betas ** 2 / (2 * post_var * alphas * (1 - ac))
        lvlb[0] = lvlb[1]  # post_var[0] == 0 -> inf; reference patches it too
        f32 = lambda x: np.asarray(x, np.float32)
        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(ac),
            alphas_cumprod_prev=f32(ac_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1 - ac)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1 / ac)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1 / ac - 1)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(np.log(np.maximum(post_var, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1 - ac)),
            posterior_mean_coef2=f32((1 - ac_prev) * np.sqrt(alphas) / (1 - ac)),
            lvlb_weights=f32(lvlb),
        )


@dataclass(frozen=True)
class DDIMParams:
    timesteps: np.ndarray  # ascending ddpm step indices used by DDIM
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_steps: int, eta: float = 0.0,
               discretize: str = "uniform") -> "DDIMParams":
        t = schedule.num_timesteps
        if discretize == "uniform":
            c = t // num_steps
            steps = np.arange(0, t, c)
        elif discretize == "quad":
            steps = (np.linspace(0, np.sqrt(t * 0.8), num_steps) ** 2).astype(int)
        else:
            raise ValueError(discretize)
        steps = steps + 1  # reference shift (util.py:58)
        ac = schedule.alphas_cumprod.astype(np.float64)
        alphas = ac[steps]
        alphas_prev = np.concatenate([[ac[0]], ac[steps[:-1]]])
        sigmas = eta * np.sqrt(
            (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev)
        )
        f32 = lambda x: np.asarray(x, np.float32)
        return cls(
            timesteps=np.asarray(steps, np.int32),
            alphas=f32(alphas),
            alphas_prev=f32(alphas_prev),
            sqrt_one_minus_alphas=f32(np.sqrt(1 - alphas)),
            sigmas=f32(sigmas),
        )
