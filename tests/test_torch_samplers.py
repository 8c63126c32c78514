"""The port's samplers against the JAX package's (CPU, fp32).

PLMS, DPM-Solver++(2M), the ancestral DDPM chain and guided DDIM run on the
same eps models (a tiny ADM UNet with weights redrawn from a seed and carried
into the port by ``convert``, or a smooth stand-in) from the same x_T, the
stochastic ones with JAX's own per-step draws replayed (``jax.random.normal``
of ``split(rng, n)[i]`` after the initial split).  ``sample_slices`` of the
whole latent-diffusion model is tests/test_torch_sample_slices.py.
Tolerance: atol 5e-4 (fp32, another summation order; stated at each
comparison).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jax_weights import redraw
from slice3d_tpu.diffusion import schedule as jax_schedule
from slice3d_tpu.diffusion.ancestral import _log_slots as jax_log_slots
from slice3d_tpu.diffusion.ancestral import ddpm_sample as jax_ddpm_sample
from slice3d_tpu.diffusion.ddim import ddim_sample as jax_ddim_sample
from slice3d_tpu.diffusion.dpm import dpm_solver_sample as jax_dpm_sample
from slice3d_tpu.diffusion.plms import plms_sample as jax_plms_sample
from slice3d_tpu.models.ldm_unet import LDMUNet as JaxUNet
from slice3d_tpu_torch.convert import ldm_unet_state_dict
from slice3d_tpu_torch.diffusion import schedule
from slice3d_tpu_torch.diffusion.ancestral import _log_slots, ddpm_sample
from slice3d_tpu_torch.diffusion.ddim import ddim_sample
from slice3d_tpu_torch.diffusion.dpm import dpm_solver_sample
from slice3d_tpu_torch.diffusion.plms import plms_sample
from slice3d_tpu_torch.models import ldm_unet

ATOL = 5e-4  # fp32 against fp32, another summation order
LIN = ("linear", 0.0015, 0.0155)
SHAPE = (2, 8, 8, 4)


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


def _schedules(t_total):
    return (jax_schedule.DiffusionSchedule.create(t_total, *LIN),
            schedule.DiffusionSchedule.create(t_total, *LIN))


def _toy(x, t, lib, phase=0.0):
    """A smooth stand-in for the UNet that depends on x and t."""
    return 0.3 * lib.sin(x + phase) + 1e-3 * t.reshape(-1, 1, 1, 1)


def _toy_pair(phase=0.0):
    return (lambda x, t: _toy(x, t.astype(jnp.float32), jnp, phase),
            lambda x, t: _toy(x, t.to(torch.float32), torch, phase))


@pytest.fixture(scope="module")
def unet_pair():
    """(JAX eps fn, port eps fn) of one tiny ADM UNet (attention at ds 2)."""
    cfg = dict(in_channels=4, out_channels=4, model_channels=32, channel_mult=(1, 2),
               num_res_blocks=1, attention_ds=(2,), n_heads=4, fmap_inject_blocks=())
    jnet = JaxUNet(**cfg)
    variables = redraw(jnet.init(jax.random.PRNGKey(0), jnp.zeros(SHAPE),
                                 jnp.zeros((2,), jnp.int32), None), 40)
    net = ldm_unet.LDMUNet(**cfg).eval()
    net.load_state_dict(ldm_unet_state_dict(variables["params"]))
    jfn = jax.jit(lambda x, t: jnet.apply(variables, x, t, None))

    def port(x, t):
        with torch.no_grad():
            return net(x, t, {})

    return jfn, port


def _x_T(seed=11):
    return np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)


def _noises(rng, n, shape=SHAPE):
    """JAX's draws after the initial split: (x_T, [normal(split(rest, n)[i])])."""
    rest, init_key = jax.random.split(rng)
    x_T = np.array(jax.random.normal(init_key, shape, jnp.float32))
    return x_T, [torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
                 for k in jax.random.split(rest, n)]


# -- PLMS -------------------------------------------------------------------------


@pytest.mark.parametrize("model,scale,steps", [("unet", 1.0, 10), ("toy", 3.0, 10),
                                               ("unet", 1.0, 1)])
def test_plms_matches_jax(unet_pair, model, scale, steps):
    """Every order of the multistep update (step 0's corrector, AB2, AB3,
    AB4) and n = 1, on the UNet or, with guidance against another stand-in,
    on the toy model; atol 5e-4."""
    jsch, sch = _schedules(100)
    jfn, pfn = unet_pair if model == "unet" else _toy_pair()
    ju, pu = _toy_pair(phase=0.5)
    x_T = _x_T()
    want = jax_plms_sample(jfn, jax_schedule.DDIMParams.create(jsch, steps, 0.0),
                           jax.random.PRNGKey(0), SHAPE, x_T=jnp.asarray(x_T),
                           guidance_scale=scale, eps_fn_uncond=ju if scale != 1.0 else None)
    calls = []
    counted = lambda x, t: calls.append(1) or pfn(x, t)  # noqa: E731
    got = plms_sample(counted, schedule.DDIMParams.create(sch, steps, 0.0), SHAPE,
                      x_T=torch.from_numpy(x_T), guidance_scale=scale,
                      eps_fn_uncond=pu if scale != 1.0 else None)
    assert got.dtype == torch.float32 and len(calls) == steps + 1  # step 0 evaluates twice
    _close(got, want)


def test_plms_refuses_eta():
    _, sch = _schedules(100)
    with pytest.raises(ValueError, match="eta must be 0"):
        plms_sample(lambda x, t: x, schedule.DDIMParams.create(sch, 10, 1.0), (1, 4, 4, 4))


# -- DPM-Solver++(2M) ---------------------------------------------------------------


@pytest.mark.parametrize("model,steps", [("unet", 10), ("toy", 20)])
def test_dpm_matches_jax(unet_pair, model, steps):
    """The same x_T through both solvers (first step first order, then the
    2M update); atol 5e-4."""
    jsch, sch = _schedules(1000)
    jfn, pfn = unet_pair if model == "unet" else _toy_pair()
    x_T = _x_T(12)
    want = jax_dpm_sample(jfn, jax_schedule.DDIMParams.create(jsch, steps, 0.0),
                          jax.random.PRNGKey(0), SHAPE, x_T=jnp.asarray(x_T))
    got = dpm_solver_sample(pfn, schedule.DDIMParams.create(sch, steps, 0.0), SHAPE,
                            x_T=torch.from_numpy(x_T))
    assert got.dtype == torch.float32
    _close(got, want)


def _matched_params(sch, n, t_max=996):
    """Node sets with one start time for every n (tests/test_dpm.py)."""
    steps = np.unique(np.round(np.linspace(1, t_max, n)).astype(int))
    ac = sch.alphas_cumprod.astype(np.float64)
    alphas, alphas_prev = ac[steps], np.concatenate([[ac[0]], ac[steps[:-1]]])
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return schedule.DDIMParams(timesteps=np.asarray(steps, np.int32), alphas=f32(alphas),
                               alphas_prev=f32(alphas_prev),
                               sqrt_one_minus_alphas=f32(np.sqrt(1 - alphas)),
                               sigmas=f32(np.zeros_like(alphas)))


def test_dpm_converges_to_the_ddim_ode():
    """DPM-Solver++ and DDIM with eta 0 discretise one ODE: 30 DPM steps land
    within 2% of a 200-step DDIM, closer than 30 DDIM steps and than 10 DPM
    steps (the JAX package's tests/test_dpm.py)."""
    _, sch = _schedules(1000)
    w = torch.from_numpy(np.random.default_rng(7).normal(size=(4, 4, 3, 3))
                         .astype(np.float32)) * 0.3

    def eps_fn(x, t):
        h = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
        return torch.tanh(h) + 0.1 * torch.sin(t.float() / 100.0)[:, None, None, None] * x

    x_T = torch.from_numpy(_x_T(1)[:1])
    ref = ddim_sample(eps_fn, _matched_params(sch, 200), tuple(x_T.shape), x_T=x_T)

    def err(x):
        return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))

    e30 = err(dpm_solver_sample(eps_fn, _matched_params(sch, 30), tuple(x_T.shape), x_T=x_T))
    e10 = err(dpm_solver_sample(eps_fn, _matched_params(sch, 10), tuple(x_T.shape), x_T=x_T))
    e_ddim30 = err(ddim_sample(eps_fn, _matched_params(sch, 30), tuple(x_T.shape), x_T=x_T))
    assert e30 < 0.02 and e30 < e_ddim30 and e30 < e10, (e30, e_ddim30, e10)


# -- ancestral ------------------------------------------------------------------------


@pytest.mark.parametrize("timesteps,every", [(20, 6), (1000, 200), (50, 1), (7, 10)])
def test_log_slots_match_jax(timesteps, every):
    got, want = _log_slots(timesteps, every), jax_log_slots(timesteps, every)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("record", ["x", "pred_x0"])
def test_ddpm_sample_matches_jax(unet_pair, clip, record):
    """The full chain with JAX's per-step noises replayed, the intermediates
    by the reference's logging rule (record "x": x_T as row 0), the noise at
    t = 0 unused; with clipping the UNet's x0 estimates leave [-1, 1]; atol
    5e-4."""
    jsch, sch = _schedules(20)
    jfn, pfn = unet_pair
    rng = jax.random.PRNGKey(5)
    x_T, noises = _noises(rng, 20)
    want, want_rows = jax_ddpm_sample(jfn, jsch, rng, SHAPE, clip_denoised=clip,
                                      temperature=0.7, log_every_t=6, record=record)
    calls = []
    got, rows = ddpm_sample(lambda x, t: calls.append(int(t[0])) or pfn(x, t), sch, SHAPE,
                            x_T=torch.from_numpy(x_T), noises=noises, clip_denoised=clip,
                            temperature=0.7, log_every_t=6, record=record)
    assert calls == list(range(19, -1, -1))
    n_log = _log_slots(20, 6)[1]
    assert tuple(rows.shape) == ((n_log + 1,) if record == "x" else (n_log,)) + SHAPE
    if record == "x":
        np.testing.assert_array_equal(rows[0].numpy(), x_T)
    _close(got, want)
    _close(rows, want_rows)


def test_ddpm_sample_walks_only_the_lowest_timesteps():
    jsch, sch = _schedules(50)
    jfn, pfn = _toy_pair()
    rng = jax.random.PRNGKey(6)
    x_T, noises = _noises(rng, 12)
    want, _ = jax_ddpm_sample(jfn, jsch, rng, SHAPE, timesteps=12)
    calls = []
    got, rows = ddpm_sample(lambda x, t: calls.append(int(t[0])) or pfn(x, t), sch, SHAPE,
                            x_T=torch.from_numpy(x_T), noises=noises, timesteps=12)
    assert rows is None and calls == list(range(11, -1, -1))
    _close(got, want)


def test_ddpm_sample_draws_from_the_generator_and_none_at_t0():
    _, sch = _schedules(10)
    g = torch.Generator().manual_seed(0)
    ddpm_sample(lambda x, t: 0.1 * x, sch, (1, 2, 2, 4), generator=g)
    # x_T and one noise per step above t = 0
    g2 = torch.Generator().manual_seed(0)
    for _ in range(10):
        torch.randn((1, 2, 2, 4), generator=g2)
    assert torch.equal(torch.randn(3, generator=g), torch.randn(3, generator=g2))


# -- DDIM with guidance and temperature ------------------------------------------------


def test_ddim_guidance_matches_jax(unet_pair):
    """eps = e_u + 3 (e_c - e_u) with the injected noise times 0.5, JAX's
    step noises replayed; atol 5e-4."""
    jsch, sch = _schedules(1000)
    jfn, pfn = unet_pair
    ju, pu = _toy_pair(phase=0.3)
    rng = jax.random.PRNGKey(8)
    x_T, noises = _noises(rng, 10)
    want = jax_ddim_sample(jfn, jax_schedule.DDIMParams.create(jsch, 10, 1.0), rng, SHAPE,
                           temperature=0.5, guidance_scale=3.0, eps_fn_uncond=ju)
    got = ddim_sample(pfn, schedule.DDIMParams.create(sch, 10, 1.0), SHAPE,
                      x_T=torch.from_numpy(x_T), noises=noises, temperature=0.5,
                      guidance_scale=3.0, eps_fn_uncond=pu)
    assert float(np.abs(np.asarray(want)).max()) > 0.5
    _close(got, want)
