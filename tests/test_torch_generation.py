"""The whole generation slice, tiny, against the JAX package (CPU, fp32).

Input views -> JAX ``LDMTrainer.sample_slices`` (ddim, 2 steps over 20
timesteps, eta 1) -> GTSlice ``Reconstructor``, against the port's
``sample_slices`` -> its ``Reconstructor``.  Every weight is redrawn from a
seed; the port gets JAX's own random draws (posterior noise of the input
view, x_T, the per-step noises).  The 16 px views give an 8 px latent tile
and a 32 px atlas, so the UNet's ds-1 attention runs over T = 1024 tokens
through ``spatial_attention``.  Tolerances: the slices agree at atol 1e-3 /
rtol 1e-3 (fp32, another summation order through VAE, UNet and DDIM), the
logit grids at atol 2e-3 with identical point counts.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jax_weights import redraw
from slice3d_tpu.diffusion.latent import LatentDiffusion as JaxLatentDiffusion
from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.gtslice import GTSliceModel as JaxGTSlice
from slice3d_tpu.pipeline import Reconstructor as JaxReconstructor
from slice3d_tpu.train.train_ldm import LDMTrainer
from slice3d_tpu_torch import camera
from slice3d_tpu_torch.convert import gtslice_state_dict, latent_diffusion_state_dict
from slice3d_tpu_torch.diffusion.latent import LatentDiffusion
from slice3d_tpu_torch.diffusion.sampler import sample_slices
from slice3d_tpu_torch.models import ldm_unet
from slice3d_tpu_torch.models.gtslice import GTSliceModel
from slice3d_tpu_torch.pipeline import Reconstructor

IMG, B, STEPS, SCALE_FACTOR = 16, 2, 2, 0.8
TINY = dict(timesteps=20, vae_ch=32, vae_mult=(1, 2), vae_nres=1, unet_channels=32,
            unet_mult=(1, 2), unet_nres=1, unet_attention_ds=(1, 2),
            unet_inject_blocks=(0, 3), cond_widths=(32, 64), latent_size=IMG // 2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def generated():
    trainer = LDMTrainer(img_size=IMG, batch_size=B, timesteps=20,
                         module=JaxLatentDiffusion(**TINY))
    state = trainer.init_state(seed=0)
    variables = redraw({"params": state.params, "batch_stats": state.batch_stats}, 30)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]),
                          scale_factor=jnp.float32(SCALE_FACTOR))
    rng = np.random.default_rng(31)
    views = rng.uniform(-1, 1, (B, 13, IMG, IMG, 3)).astype(np.float32)
    batch = {"image": views, "img_ipt_view": views[:, 12]}  # as data/ldm_data.py
    key = jax.random.PRNGKey(32)
    want = trainer.sample_slices(state, batch, ddim_steps=STEPS, eta=1.0, rng=key,
                                 use_ema=False)

    # JAX's draws: the posterior noise of the 13-image stack (the port encodes
    # only the input view, tile 12), then x_T and one noise per DDIM step
    rest, enc_key = jax.random.split(key)
    h = IMG // 2
    post = np.array(jax.random.normal(enc_key, (B * 13, h, h, 4), jnp.float32))
    rest, init_key = jax.random.split(rest)
    shape = (B, 4 * h, 4 * h, 4)
    x_T = np.array(jax.random.normal(init_key, shape, jnp.float32))
    noises = [torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
              for k in jax.random.split(rest, STEPS)]

    ldm = LatentDiffusion(**TINY).eval()
    ldm.load_state_dict(latent_diffusion_state_dict(variables, SCALE_FACTOR))
    got = sample_slices(ldm, torch.from_numpy(batch["img_ipt_view"]), ddim_steps=STEPS,
                        eta=1.0, posterior_noise=torch.from_numpy(
                            post.reshape(B, 13, h, h, 4)[:, 12]),
                        x_T=torch.from_numpy(x_T), step_noises=noises, device="cpu")
    return np.asarray(want), got


def test_sample_slices_matches_jax(generated):
    want, got = generated
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 12, IMG, IMG, 3)
    assert float(np.std(want)) > 1e-2  # not a constant image
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


def test_sampler_routes_long_attention_through_the_kernel_wrapper(monkeypatch):
    calls = []
    real = ldm_unet.spatial_attention
    monkeypatch.setattr(ldm_unet, "spatial_attention",
                        lambda q, *a: calls.append(tuple(q.shape)) or real(q, *a))
    ldm = LatentDiffusion(**TINY).eval()
    sample_slices(ldm, torch.zeros((1, IMG, IMG, 3)), ddim_steps=STEPS, eta=1.0,
                  generator=torch.Generator().manual_seed(0), device="cpu")
    # ds 1 of the 32 px atlas: 1 input + 2 output blocks per UNet call
    assert calls == [(1, 8, 1024, 4)] * (3 * STEPS)


def test_sampler_runs_on_cuda_unless_asked_otherwise(monkeypatch):
    """A model built on the CPU and given no device is not sampled on the
    CPU: the sampler asks for CUDA and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ldm = LatentDiffusion(**TINY).eval()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_slices(ldm, torch.zeros((1, IMG, IMG, 3)), ddim_steps=STEPS, eta=1.0,
                      generator=torch.Generator().manual_seed(0))


def test_generated_slices_reconstruct_like_jax(generated):
    want, got = generated
    jmodel = JaxGTSlice(n_slices=12)
    variables = redraw(init_variables(jmodel, types.SimpleNamespace(
        img_size=IMG, n_slices=12), seed=0), 33)
    model = GTSliceModel().eval()
    model.load_state_dict(gtslice_state_dict(variables))
    _, proj = camera.camera_matrices(0.0, 0.0, 1.2)
    trans = proj.astype(np.float32)
    port_feed = {"img_slices": got[0].numpy(), "trans_mat_wo_rot_tp": trans}
    jax_feed = {"img_slices": want[0], "trans_mat_wo_rot_tp": trans}
    grid0, _ = Reconstructor(model, resolution0=16, upsampling_steps=0,
                             device="cpu").build_grid(port_feed)
    kw = dict(resolution0=16, upsampling_steps=1, chunk_size=1024,
              threshold=float(1.0 / (1.0 + np.exp(-np.median(grid0)))))
    jrec = JaxReconstructor(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                            transport_dtype="float32", **kw)
    j_grid, _, j_stats = jrec._build_grid(jax_feed)
    grid, stats = Reconstructor(model, device="cpu", **kw).build_grid(port_feed)
    np.testing.assert_allclose(grid, np.asarray(j_grid), atol=2e-3, rtol=0)
    assert stats["n_points_evaluated"] == j_stats["n_points_evaluated"] > 17 ** 3
