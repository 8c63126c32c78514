"""The pieces of the port's LDM training against the JAX package (CPU, fp32).

Train-mode BatchNorm (output and running statistics) against flax's
``BatchNorm`` at atol 1e-5; the conditioner in train mode against the JAX
``CondImageEncoder(train=True)`` (maps at atol 5e-4 / rtol 1e-3, statistics
at 1e-5); ``ema_update``, the LR schedules and ``p_losses`` (with JAX's t
and noise) against their JAX twins; torch's AdamW with optax's defaults
against ``optax.adamw`` on identical gradients; checkpoints; and the guard
that keeps the inference-only encoder kernel out of autograd.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from jax_weights import redraw
from slice3d_tpu.diffusion import latent as jax_latent
from slice3d_tpu.diffusion.schedule import DiffusionSchedule as JaxSchedule
from slice3d_tpu.models import ema as jax_ema
from slice3d_tpu.models.cond_encoder import CondImageEncoder as JaxCond
from slice3d_tpu.models.layers import BatchNorm as JaxBatchNorm
from slice3d_tpu.train import lr_schedules as jax_lr
from slice3d_tpu_torch.convert import cond_encoder_state_dict, ldm_unet_state_dict
from slice3d_tpu_torch.diffusion.latent import LatentDiffusion, p_losses
from slice3d_tpu_torch.diffusion.schedule import DiffusionSchedule
from slice3d_tpu_torch.models import ema
from slice3d_tpu_torch.models.cond_encoder import CondImageEncoder
from slice3d_tpu_torch.models.layers import BatchNorm2d
from slice3d_tpu_torch.ops import fused_encoder as fe
from slice3d_tpu_torch.train import lr_schedules
from slice3d_tpu_torch.train.checkpoint import (TopKCheckpointer, latest_checkpoint,
                                                restore_checkpoint, save_checkpoint)

TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores, and a thread pool per worker spends its time waiting for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


# -- BatchNorm and the conditioner in train mode ---------------------------------------


@pytest.mark.parametrize("shift", [0.0, 3.0], ids=["centred", "offset"])
def test_train_batchnorm_matches_flax(shift):
    rng = np.random.default_rng(int(shift) + 1)
    c = 6
    x = (rng.normal(size=(4, 5, 7, c)) * 1.5 + shift).astype(np.float32)  # NHWC
    p = {"scale": rng.uniform(0.9, 1.1, c), "bias": rng.uniform(-0.1, 0.1, c)}
    s = {"mean": rng.uniform(-0.1, 0.1, c), "var": rng.uniform(0.5, 1.5, c)}
    p, s = ({k: v.astype(np.float32) for k, v in d.items()} for d in (p, s))
    bn = JaxBatchNorm(use_running_average=False)
    want, mutated = bn.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                             mutable=["batch_stats"])
    port = BatchNorm2d(c)
    port.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                          "bias": torch.from_numpy(p["bias"]),
                          "running_mean": torch.from_numpy(s["mean"]),
                          "running_var": torch.from_numpy(s["var"]),
                          "num_batches_tracked": torch.tensor(0)})
    port.eval()  # the argument decides, not the module's mode
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    _close(got, want, atol=1e-5, rtol=0)
    new = mutated["batch_stats"]
    _close(port.running_mean, new["mean"], atol=1e-5, rtol=0)
    _close(port.running_var, new["var"], atol=1e-5, rtol=0)
    # the biased variance moves the statistics, not torch's unbiased one
    xt = torch.from_numpy(x)
    assert not np.allclose(port.running_var.numpy(),
                           0.9 * s["var"] + 0.1 * xt.var((0, 1, 2)).numpy(), atol=1e-5)
    # inference (the module's eval mode) reads the updated statistics
    with torch.no_grad():
        inf = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want_inf = JaxBatchNorm(use_running_average=True).apply(
        {"params": p, "batch_stats": new}, jnp.asarray(x))
    _close(inf, want_inf, atol=1e-5, rtol=0)


def test_cond_encoder_train_mode_matches_jax():
    widths, latent = (32, 64, 64, 128, 128), 4
    img = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jcond = JaxCond(widths=widths, latent_size=latent)
    variables = redraw(jcond.init(jax.random.PRNGKey(0), jnp.asarray(img)), 4)
    want, mutated = jcond.apply(variables, jnp.asarray(img), train=True,
                                mutable=["batch_stats"])
    cond = CondImageEncoder(widths, latent).eval()
    cond.load_state_dict(cond_encoder_state_dict(variables, prefix=""))
    got = cond(torch.from_numpy(img), train=True)
    for key in want:
        _close(got[key], want[key])
    stats = cond_encoder_state_dict({"params": variables["params"],
                                     "batch_stats": mutated["batch_stats"]}, prefix="")
    before = cond_encoder_state_dict(variables, prefix="")
    for name, value in cond.state_dict().items():
        if not name.endswith(("running_mean", "running_var")):
            continue
        if name.startswith("conv_last."):
            # the BatchNorm after the last tap feeds no output: the JAX
            # backbone still runs it and moves its statistics, the port does
            # not run it
            assert torch.equal(value, before[name])
            assert not torch.equal(stats[name], before[name])
            continue
        assert not torch.equal(value, before[name]), name
        _close(value, stats[name].numpy(), atol=1e-5, rtol=0)


# -- EMA, LR schedules, loss ---------------------------------------------------------


@pytest.mark.parametrize("step", [0, 3, 10 ** 6])
def test_ema_update_matches_jax(step):
    rng = np.random.default_rng(step % 97)
    e = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in e.items()}
    want = jax_ema.ema_update(e, p, jnp.int32(step))
    got = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
    ema.ema_update(got, {k: torch.from_numpy(v) for k, v in p.items()}, step)
    for k in e:
        _close(got[k], want[k], atol=1e-7, rtol=1e-6)
    assert ema.ema_decay(0) == pytest.approx(0.1) and ema.ema_decay(10 ** 6) == pytest.approx(
        0.9999)


_SCHEDULES = {
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler": dict(
        warm_up_steps=10, lr_min=0.1, lr_max=1.0, lr_start=0.01, max_decay_steps=100),
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler2": dict(
        warm_up_steps=[5, 3], f_min=[0.1, 0.2], f_max=[1.0, 0.8], f_start=[0.0, 0.1],
        cycle_lengths=[20, 30]),
    "ldm.lr_scheduler.LambdaLinearScheduler": dict(
        warm_up_steps=[100], f_min=[1.0], f_max=[1.0], f_start=[1e-6],
        cycle_lengths=[10000000000000], verbosity_interval=0),
}


@pytest.mark.parametrize("target", sorted(_SCHEDULES), ids=lambda t: t.rsplit(".", 1)[1])
def test_lr_schedules_match_jax(target):
    cfg = {"target": target, "params": _SCHEDULES[target]}
    mine, ref = lr_schedules.from_scheduler_config(cfg), jax_lr.from_scheduler_config(cfg)
    steps = list(range(0, 130)) + [1000, 123456]
    got = np.array([mine(s) for s in steps])
    want = np.array([float(ref(s)) for s in steps])
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)
    assert lr_schedules.from_scheduler_config(None) is None
    with pytest.raises(KeyError):
        lr_schedules.from_scheduler_config({"target": "nope"})


TINY = dict(timesteps=20, vae_ch=32, vae_mult=(1, 2), vae_nres=1, unet_channels=32,
            unet_mult=(1, 2), unet_nres=1, unet_attention_ds=(1,),
            unet_inject_blocks=(0, 3), cond_widths=(32, 64), latent_size=8)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_p_losses_matches_jax(loss_type):
    """JAX's p_losses and the port's with JAX's t and noise, a random logvar
    and a 32 px atlas (the UNet's ds-1 attention at T = 1024)."""
    rng = np.random.default_rng(7)
    b = 2
    x0 = rng.normal(size=(b, 32, 32, 4)).astype(np.float32)
    cond = {"c_concat": rng.normal(size=(b, 32, 32, 4)).astype(np.float32),
            "c_fmaps": {"f1": rng.normal(size=(b, 32, 32, 32)).astype(np.float32),
                        "f2": rng.normal(size=(b, 16, 16, 64)).astype(np.float32)}}
    logvar = rng.uniform(-0.5, 0.5, 20).astype(np.float32)
    jcond = jax.tree_util.tree_map(jnp.asarray, cond)
    module = jax_latent.LatentDiffusion(**TINY)
    variables = redraw(module.init(jax.random.PRNGKey(0), jnp.asarray(x0),
                                   jnp.zeros((b,), jnp.int32), jcond,
                                   method=jax_latent.LatentDiffusion.apply_model), 8)
    sched = JaxSchedule.create(20, "linear", 0.0015, 0.0155)
    key = jax.random.PRNGKey(9)
    want_loss, want = jax_latent.p_losses(module, variables, sched, key, jnp.asarray(x0),
                                          jcond, logvar=jnp.asarray(logvar),
                                          loss_type=loss_type)
    # JAX's draws (latent.py p_losses): t, then the noise
    key_t, key_n = jax.random.split(key)
    t = np.array(jax.random.randint(key_t, (b,), 0, 20))
    noise = np.array(jax.random.normal(key_n, x0.shape, jnp.float32))

    ldm = LatentDiffusion(**TINY).eval()
    ldm.model.diffusion_model.load_state_dict(ldm_unet_state_dict(variables["params"]["model"]))
    tcond = {"c_concat": torch.from_numpy(cond["c_concat"]),
             "c_fmaps": {k: torch.from_numpy(v) for k, v in cond["c_fmaps"].items()}}
    loss, logs = p_losses(ldm, DiffusionSchedule.create(20, "linear", 0.0015, 0.0155),
                          torch.from_numpy(x0), tcond, logvar=torch.from_numpy(logvar),
                          loss_type=loss_type, t=torch.from_numpy(t),
                          noise=torch.from_numpy(noise))
    assert sorted(logs) == sorted(want) == ["loss", "loss_simple", "loss_vlb"]
    assert loss is logs["loss"]
    for k in want:
        _close(logs[k], want[k], atol=1e-5, rtol=1e-5)
    _close(loss, want_loss, atol=1e-5, rtol=1e-5)


def test_p_losses_draws_t_then_noise_from_the_generator():
    ldm = LatentDiffusion(**TINY).eval()
    sched = DiffusionSchedule.create(20, "linear", 0.0015, 0.0155)
    x0 = torch.zeros((1, 32, 32, 4))
    cond = {"c_concat": torch.zeros((1, 32, 32, 4)), "c_fmaps": {
        "f1": torch.zeros((1, 32, 32, 32)), "f2": torch.zeros((1, 16, 16, 64))}}
    g = torch.Generator().manual_seed(3)
    got = p_losses(ldm, sched, x0, cond, generator=g)[1]
    g.manual_seed(3)
    t = torch.randint(0, 20, (1,), generator=g)
    noise = torch.randn(x0.shape, generator=g)
    want = p_losses(ldm, sched, x0, cond, t=t, noise=noise)[1]
    assert all(torch.equal(got[k], want[k]) for k in want)


# -- the optimizer ------------------------------------------------------------------------


def test_adamw_matches_optax_on_identical_gradients():
    """torch's AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, weight
    decay 1e-4) gives optax.adamw's updates for the same gradients, near-zero
    ones included (Adam's first step is ~lr sign(g) there)."""
    rng = np.random.default_rng(11)
    lr = 4e-4
    params = {"w": rng.normal(size=(16, 8)).astype(np.float32),
              "b": rng.normal(size=(8,)).astype(np.float32)}
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("w", "b")]
    opt = torch.optim.AdamW(tparams, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    tx = optax.adamw(lr)
    state = tx.init(params)
    jp = dict(params)
    for step in range(3):
        grads = {k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-10, 0, v.shape))
                 .astype(np.float32) for k, v in params.items()}
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, k in zip(tparams, ("w", "b")):
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for p, k in zip(tparams, ("w", "b")):
            _close(p, jp[k], atol=1e-7, rtol=1e-6)


# -- checkpoints ----------------------------------------------------------------------------


def test_checkpoint_round_trip_and_latest(tmp_path):
    state = {"model": {"w": torch.arange(6.0).reshape(2, 3)}, "step": 7,
             "ema": {"w": torch.ones(2)}}
    a = save_checkpoint(str(tmp_path / "sub" / "a.ckpt"), state)
    back = restore_checkpoint(a)
    assert back["step"] == 7 and torch.equal(back["model"]["w"], state["model"]["w"])
    b = save_checkpoint(str(tmp_path / "sub" / "b.ckpt"), state)
    os.utime(a, (1, 1))
    assert latest_checkpoint(str(tmp_path / "sub")) == b
    assert latest_checkpoint(str(tmp_path / "none")) is None
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path / "sub"))


def test_topk_checkpointer(tmp_path):
    ck = TopKCheckpointer(str(tmp_path), monitor="val/loss_simple_ema", k=2)
    assert ck.update(1.0, 1, {"step": 1}) is not None
    assert ck.update(2.0, 2, {"step": 2}) is not None
    assert ck.update(3.0, 3, {"step": 3}) is None  # worse than the k kept
    p = ck.update(0.5, 4, {"step": 4})
    assert p is not None and "0.50000" in p
    kept = sorted(os.listdir(tmp_path))
    assert len(kept) == 2
    assert any("step=000004" in k for k in kept) and any("step=000001" in k for k in kept)


def test_topk_checkpointer_seeds_from_disk(tmp_path):
    """A new instance seeds its list from the files on disk, so a resumed
    run keeps pruning past k."""
    ck = TopKCheckpointer(str(tmp_path), monitor="val/loss_simple_ema", k=2)
    ck.update(1.0, 1, {"step": 1})
    ck.update(2.0, 2, {"step": 2})
    ck2 = TopKCheckpointer(str(tmp_path), monitor="val/loss_simple_ema", k=2)
    assert len(ck2.best) == 2
    assert ck2.update(3.0, 3, {"step": 3}) is None
    assert ck2.update(0.5, 4, {"step": 4}) is not None
    assert len(os.listdir(tmp_path)) == 2
    assert restore_checkpoint(ck2.best[0][1])["step"] == 4


# -- the inference-only encoder kernel ----------------------------------------------------


def test_fused_encoder_kernel_refuses_autograd(monkeypatch):
    """On the card (the device check forced on) the kernel raises when grad
    mode is on and an input or weight requires grad, instead of returning a
    tensor cut from the graph; under no_grad it goes on to its own checks."""
    from slice3d_tpu_torch.models.layers import TransformerEncoderLayer

    layer = TransformerEncoderLayer()
    params = dict(layer.named_parameters())
    x = torch.zeros((1, 2, 13, 128))
    monkeypatch.setattr(fe, "_on_card", lambda x: True)
    with pytest.raises(RuntimeError, match="inference only"):
        fe.fused_encoder_layer(x, params)  # the weights require grad
    with pytest.raises(RuntimeError, match="inference only"):
        fe.fused_encoder_layer(x.requires_grad_(), {k: v.detach() for k, v in params.items()})
    with torch.no_grad(), pytest.raises(TypeError, match="bf16 or fp32"):
        fe.fused_encoder_layer(x.half(), params)  # past the guard: fp16 has no kernel
    monkeypatch.undo()
    # on the CPU the plain version runs and is differentiable
    out = fe.fused_encoder_layer(torch.randn((1, 2, 13, 128)), params)
    out.sum().backward()
    assert params["linear1.weight"].grad is not None
