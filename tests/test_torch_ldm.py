"""The port's generation-route modules against the JAX package (CPU, fp32).

Every weight is redrawn from a seed (tests/jax_weights.py), the layers the
JAX modules zero-initialise included, and carried into the port by
``slice3d_tpu_torch.convert``.  Modules agree at atol 5e-4 / rtol 1e-3 (the
style of tests/test_ldm_unet_parity.py); the schedule tables are equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jax_weights import redraw
from slice3d_tpu.diffusion import schedule as jax_schedule
from slice3d_tpu.diffusion.ddim import ddim_sample as jax_ddim_sample
from slice3d_tpu.models.cond_encoder import CondImageEncoder as JaxCond
from slice3d_tpu.models.ldm_unet import LDMUNet as JaxUNet
from slice3d_tpu.models.ldm_unet import timestep_embedding as jax_timestep_embedding
from slice3d_tpu.models.vae import AutoencoderKL as JaxVAE
from slice3d_tpu.ops.atlas import tile_slices_to_atlas as jax_tile
from slice3d_tpu.ops.atlas import untile_atlas as jax_untile
from slice3d_tpu_torch.convert import (cond_encoder_state_dict, ldm_unet_state_dict,
                                       vae_state_dict)
from slice3d_tpu_torch.diffusion import schedule
from slice3d_tpu_torch.diffusion.ddim import ddim_sample
from slice3d_tpu_torch.models import ldm_unet
from slice3d_tpu_torch.models.cond_encoder import CondImageEncoder
from slice3d_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussian
from slice3d_tpu_torch.ops.atlas import tile_slices_to_atlas, untile_atlas
from slice3d_tpu_torch.ops.resize import resize_nearest

TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


# -- schedule, DDIM tables, atlas, resize -----------------------------------------


@pytest.mark.parametrize("steps,eta,discretize", [(200, 1.0, "uniform"), (50, 0.0, "uniform"),
                                                  (20, 0.5, "quad")])
def test_schedule_and_ddim_tables_equal(steps, eta, discretize):
    args = (1000, "linear", 0.0015, 0.0155)
    mine, ref = schedule.DiffusionSchedule.create(*args), jax_schedule.DiffusionSchedule.create(*args)
    for name in ref.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name), err_msg=name)
    d_mine = schedule.DDIMParams.create(mine, steps, eta, discretize)
    d_ref = jax_schedule.DDIMParams.create(ref, steps, eta, discretize)
    for name in d_ref.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(d_mine, name), getattr(d_ref, name),
                                      err_msg=name)


def test_atlas_round_trip_matches_jax():
    z = np.random.default_rng(0).normal(size=(2, 12, 3, 5, 4)).astype(np.float32)
    atlas = tile_slices_to_atlas(torch.from_numpy(z))
    np.testing.assert_array_equal(atlas.numpy(), np.asarray(jax_tile(jnp.asarray(z))))
    np.testing.assert_array_equal(untile_atlas(atlas, keep=13).numpy(),
                                  np.asarray(jax_untile(jnp.asarray(atlas.numpy()), keep=13)))
    np.testing.assert_array_equal(untile_atlas(atlas, keep=12).numpy(), z)


@pytest.mark.parametrize("size_in", [128, 64, 32, 16, 8])
def test_resize_nearest_matches_interpolate(size_in):
    """The JAX index rule equals F.interpolate's at the conditioner's sizes."""
    x = torch.from_numpy(np.random.default_rng(size_in).normal(
        size=(2, size_in, size_in, 3)).astype(np.float32))
    for size_out in (16, 8, 4, 2, 1):
        want = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(size_out,) * 2,
                                               mode="nearest").permute(0, 2, 3, 1)
        assert torch.equal(resize_nearest(x, (size_out, size_out)), want)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 57, 999], np.int64)
    got = ldm_unet.timestep_embedding(torch.from_numpy(t), 32)
    _close(got, jax_timestep_embedding(jnp.asarray(t, jnp.int32), 32), atol=1e-5, rtol=0)


# -- networks ---------------------------------------------------------------------


def test_vae_matches_jax():
    cfg = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jvae = JaxVAE(**cfg)
    variables = redraw(jvae.init(jax.random.PRNGKey(0), jnp.asarray(x), None, False), 2)
    vae = AutoencoderKL(**cfg)
    vae.load_state_dict(vae_state_dict(variables["params"]))
    moments = jvae.apply(variables, jnp.asarray(x), method=JaxVAE.encode_moments)
    z = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    imgs = jvae.apply(variables, jnp.asarray(z), method=JaxVAE.decode)
    with torch.no_grad():
        got_m = vae.encode_moments(torch.from_numpy(x))
        got_i = vae.decode(torch.from_numpy(z))
    assert tuple(got_m.shape) == (2, 16, 16, 8) and tuple(got_i.shape) == (2, 32, 32, 3)
    _close(got_m, moments)
    _close(got_i, imgs)
    post = DiagonalGaussian(got_m)
    noise = torch.from_numpy(rng.normal(size=(2, 16, 16, 4)).astype(np.float32))
    torch.testing.assert_close(post.sample(noise), post.mean + post.std * noise)


def test_cond_encoder_matches_jax():
    widths, latent = (32, 64, 64, 128, 128), 4
    img = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jcond = JaxCond(widths=widths, latent_size=latent)
    variables = redraw(jcond.init(jax.random.PRNGKey(0), jnp.asarray(img)), 4)
    want = jcond.apply(variables, jnp.asarray(img))
    cond = CondImageEncoder(widths, latent).eval()
    cond.load_state_dict(cond_encoder_state_dict(variables, prefix=""))
    with torch.no_grad():
        got = cond(torch.from_numpy(img))
    assert sorted(got) == sorted(want) == ["f1", "f2", "f3", "f4", "f5"]
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        _close(got[key], want[key])


# ds-1 attention over a 32x32 map: T = 1024, the kernel-eligible branch
UNET = dict(in_channels=8, out_channels=4, model_channels=96, channel_mult=(1, 2),
            num_res_blocks=1, attention_ds=(1, 2), n_heads=4, fmap_inject_blocks=(0, 3))


def test_unet_matches_jax_with_eligible_attention(monkeypatch):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, 32, 8)).astype(np.float32)
    t = np.array([3, 17], np.int64)
    fmaps = {"f1": rng.normal(size=(2, 32, 32, 96)).astype(np.float32),
             "f2": rng.normal(size=(2, 16, 16, 192)).astype(np.float32)}
    jnet = JaxUNet(**UNET)
    jargs = (jnp.asarray(x), jnp.asarray(t, jnp.int32),
             {k: jnp.asarray(v) for k, v in fmaps.items()})
    variables = redraw(jnet.init(jax.random.PRNGKey(0), *jargs), 6)
    want = jnet.apply(variables, *jargs)

    net = ldm_unet.LDMUNet(**UNET).eval()
    net.load_state_dict(ldm_unet_state_dict(variables["params"]))
    calls = []
    real = ldm_unet.spatial_attention
    monkeypatch.setattr(ldm_unet, "spatial_attention",
                        lambda q, *a: calls.append(q.shape) or real(q, *a))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t),
                  {k: torch.from_numpy(v) for k, v in fmaps.items()})
    # the three ds-1 blocks (T = 1024, DH 24) take spatial_attention; the ds-2
    # and middle blocks (T 256, 64) the einsum path
    assert calls == [(2, 4, 1024, 24)] * 3
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 32, 32, 4)
    assert float(np.abs(np.asarray(want)).mean()) > 1e-2  # the output layers are live
    _close(got, want)


# -- DDIM -------------------------------------------------------------------------


def _eps(x, t, lib):
    """A smooth stand-in for the UNet that depends on x and t."""
    return 0.3 * lib.sin(x) + 1e-3 * t.reshape(-1, 1, 1, 1)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_sample_matches_jax(eta):
    shape = (2, 8, 8, 4)
    sched = jax_schedule.DiffusionSchedule.create(1000, "linear", 0.0015, 0.0155)
    params = jax_schedule.DDIMParams.create(sched, 10, eta)
    key = jax.random.PRNGKey(7)
    want = jax_ddim_sample(lambda x, t: _eps(x, t.astype(jnp.float32), jnp), params, key,
                           shape)
    # JAX's draws (ddim.py): split off the initial noise, then one key per step
    rest, init_key = jax.random.split(key)
    x_T = np.array(jax.random.normal(init_key, shape, jnp.float32))
    noises = [torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
              for k in jax.random.split(rest, params.num_steps)]
    port_params = schedule.DDIMParams.create(
        schedule.DiffusionSchedule.create(1000, "linear", 0.0015, 0.0155), 10, eta)
    got = ddim_sample(lambda x, t: _eps(x, t.to(torch.float32), torch), port_params, shape,
                      x_T=torch.from_numpy(x_T), noises=noises if eta else None)
    assert got.dtype == torch.float32
    _close(got, want, atol=1e-4, rtol=1e-4)


def test_ddim_sample_draws_from_the_generator():
    sched = schedule.DiffusionSchedule.create(1000, "linear", 0.0015, 0.0155)
    params = schedule.DDIMParams.create(sched, 4, 1.0)
    run = lambda seed: ddim_sample(lambda x, t: 0.1 * x, params, (1, 4, 4, 4),
                                   generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
