"""``sample_slices`` and the image-logging chains of the tiny latent-diffusion
model, the port's against the JAX ``LDMTrainer``'s (CPU, fp32).

Every sampler at guidance 1 and 3 (``sample_slices``, with the 2B-batched
UNet call of guidance checked), the progressive-denoise rows and the
forward-diffusion rows, every weight redrawn from a seed and carried into
the port by ``convert``, JAX's draws replayed (posterior noise, x_T and
``jax.random.normal`` of ``split(rng, n)[i]`` after the initial split).
Tolerance: atol 5e-4 (fp32, another summation order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jax_weights import redraw
from slice3d_tpu.diffusion.latent import LatentDiffusion as JaxLatentDiffusion
from slice3d_tpu.train.train_ldm import LDMTrainer as JaxLDMTrainer
from slice3d_tpu_torch.convert import latent_diffusion_state_dict
from slice3d_tpu_torch.diffusion.ancestral import _log_slots
from slice3d_tpu_torch.diffusion.latent import LatentDiffusion
from slice3d_tpu_torch.diffusion.sampler import sample_slices
from slice3d_tpu_torch.models import ldm_unet

ATOL = 5e-4  # fp32 against fp32, another summation order


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _noises(rng, n, shape):
    """JAX's draws after the initial split: (x_T, [normal(split(rest, n)[i])])."""
    rest, init_key = jax.random.split(rng)
    x_T = np.array(jax.random.normal(init_key, shape, jnp.float32))
    return x_T, [torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
                 for k in jax.random.split(rest, n)]


IMG, B, T_TINY = 16, 2, 20
TINY = dict(timesteps=T_TINY, vae_ch=32, vae_mult=(1, 2), vae_nres=1, unet_channels=32,
            unet_mult=(1, 2), unet_nres=1, unet_attention_ds=(1, 2),
            unet_inject_blocks=(0, 3), cond_widths=(32, 64), latent_size=IMG // 2)
STEPS = {"ddim": 4, "dpm": 4, "plms": 4, "ancestral": None}  # 20 // 4: 4 nodes


@pytest.fixture(scope="module")
def tiny_ldm():
    """(JAX trainer, its state, the port's model with the same weights, the
    batch): every weight redrawn, scale factor 0.8."""
    trainer = JaxLDMTrainer(img_size=IMG, batch_size=B, timesteps=T_TINY,
                            module=JaxLatentDiffusion(**TINY))
    state = trainer.init_state(seed=0)
    variables = redraw({"params": state.params, "batch_stats": state.batch_stats}, 41)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]),
                          scale_factor=jnp.float32(0.8))
    ldm = LatentDiffusion(**TINY).eval()
    ldm.load_state_dict(latent_diffusion_state_dict(variables, 0.8))
    views = np.random.default_rng(42).uniform(-1, 1, (B, 13, IMG, IMG, 3)).astype(np.float32)
    return trainer, state, ldm, {"image": views, "img_ipt_view": views[:, 12]}


@pytest.mark.parametrize("scale", [1.0, 3.0])
@pytest.mark.parametrize("sampler", ["ddim", "dpm", "plms", "ancestral"])
def test_sample_slices_matches_jax(tiny_ldm, monkeypatch, sampler, scale):
    """The port's ``sample_slices`` against the JAX trainer's with JAX's draws
    (posterior noise, x_T, DDIM's or the chain's step noises); under guidance
    every UNet call takes the 2B batch cat([uncond, cond]) once a step, and
    the attention wrapper sees batch 2B; atol 5e-4 on the decoded slices."""
    trainer, state, ldm, batch = tiny_ldm
    steps = STEPS[sampler]
    eta = 0.0 if sampler == "plms" else 1.0
    key = jax.random.PRNGKey(43)
    want = trainer.sample_slices(state, batch, ddim_steps=steps or 1, eta=eta, rng=key,
                                 use_ema=False, sampler=sampler, guidance_scale=scale)
    rest, enc_key = jax.random.split(key)
    h = IMG // 2
    post = np.array(jax.random.normal(enc_key, (B * 13, h, h, 4), jnp.float32))
    n_noise = {"ddim": steps, "ancestral": T_TINY}.get(sampler, 0)
    x_T, noises = _noises(rest, max(n_noise, 1), (B, 4 * h, 4 * h, 4))

    unet_batches, attn_batches = [], []
    hook = ldm.model.diffusion_model.register_forward_pre_hook(
        lambda mod, args: unet_batches.append(args[0].shape[0]))
    real = ldm_unet.spatial_attention
    monkeypatch.setattr(ldm_unet, "spatial_attention",
                        lambda q, *a: attn_batches.append(q.shape[0]) or real(q, *a))
    try:
        got = sample_slices(ldm, torch.from_numpy(batch["img_ipt_view"]), sampler=sampler,
                            ddim_steps=steps or 1, eta=eta, guidance_scale=scale,
                            posterior_noise=torch.from_numpy(
                                post.reshape(B, 13, h, h, 4)[:, 12]),
                            x_T=torch.from_numpy(x_T),
                            step_noises=noises if n_noise else None, device="cpu")
    finally:
        hook.remove()
    calls = {"ddim": steps, "dpm": steps, "plms": (steps or 0) + 1,
             "ancestral": T_TINY}[sampler]
    batch_size = B if scale == 1.0 else 2 * B
    assert unet_batches == [batch_size] * calls
    # ds 1 of the 32 px atlas: 1 input and 2 output blocks a UNet call
    assert attn_batches == [batch_size] * (3 * calls)
    assert tuple(got.shape) == (B, 12, IMG, IMG, 3) and float(np.std(want)) > 1e-2
    _close(got, want)


def _port_trainer(ldm):
    from slice3d_tpu_torch.train.train_ldm import LDMTrainer

    trainer = LDMTrainer(img_size=IMG, batch_size=B, timesteps=T_TINY, module=ldm,
                         device="cpu")
    return trainer, trainer.init_state()


def test_sample_progressive_matches_jax(tiny_ldm):
    """The full-T chain with the running x0 estimate logged every 6 steps and
    each row decoded, JAX's draws replayed; atol 5e-4."""
    trainer, state, ldm, batch = tiny_ldm
    key = jax.random.PRNGKey(44)
    want_final, want_rows = trainer.sample_progressive(state, batch, log_every_t=6, rng=key,
                                                       use_ema=False, temperature=0.8)
    rest, enc_key = jax.random.split(key)
    h = IMG // 2
    post = np.array(jax.random.normal(enc_key, (B * 13, h, h, 4), jnp.float32))
    x_T, noises = _noises(rest, T_TINY, (B, 4 * h, 4 * h, 4))
    port, pstate = _port_trainer(ldm)
    final, rows = port.sample_progressive(
        pstate, batch["img_ipt_view"], log_every_t=6, use_ema=False, temperature=0.8,
        posterior_noise=torch.from_numpy(post.reshape(B, 13, h, h, 4)[:, 12]),
        x_T=torch.from_numpy(x_T), step_noises=noises)
    assert tuple(rows.shape) == (_log_slots(T_TINY, 6)[1], B, 12, IMG, IMG, 3)
    _close(final, want_final)
    _close(rows, want_rows)


def test_diffusion_row_matches_jax(tiny_ldm):
    """The clean atlas of the 12 slices noised to each logged t and decoded,
    JAX's posterior noise and per-row noises replayed; atol 5e-4."""
    trainer, state, ldm, batch = tiny_ldm
    key = jax.random.PRNGKey(45)
    want = trainer.diffusion_row(state, batch, log_every_t=6, rng=key)
    rng, enc_key = jax.random.split(key)
    h = IMG // 2
    post = np.array(jax.random.normal(enc_key, (B * 13, h, h, 4), jnp.float32))
    noises = []
    for _ in range(len(want)):
        rng, sub = jax.random.split(rng)
        noises.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (B, 4 * h, 4 * h, 4), jnp.float32))))
    port, pstate = _port_trainer(ldm)
    got = port.diffusion_row(pstate, batch["image"], log_every_t=6, noises=noises,
                             posterior_noise=torch.from_numpy(post.reshape(B, 13, h, h, 4)))
    assert tuple(got.shape) == (5, B, 12, IMG, IMG, 3)  # t = 0, 6, 12, 18 and 19
    _close(got, want)
