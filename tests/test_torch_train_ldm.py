"""One LDM training step of the port against the JAX package's (CPU, fp32).

The tiny configuration of tests/test_ldm.py with attention at ds 1 only, so
the UNet's ds-1 blocks attend over T = 1024 tokens of the 32 px atlas through
``spatial_attention`` (its autograd Function, plain versions on the CPU).
Every weight and BatchNorm statistic is redrawn from a seed, carried into
the port by ``convert.ldm_train_payload``, and the port replays the JAX
step's draws (posterior noise, t, noise) from its key.  One JAX trainer is
built per file (its init and each step's compile are the cost).

Tolerances: the logs and the gradients at atol 5e-4 / rtol 1e-3 (another
summation order through VAE, conditioner and UNet; the readings are far
below).  After AdamW's first step a parameter moves by about
``lr * g / (|g| + 1e-8)``, so where a gradient is within its error of zero
the two packages may move it by up to 2 lr apart: the parameters agree at
atol 1e-6 where |g| >= 1e-5 and within 2 lr + 1e-6 elsewhere, and so
does the EMA (decay (1 + 0) / (10 + 0) = 0.1 at the first update: it takes
0.9 of the new weights); the update
rule itself is held against optax on identical gradients in
tests/test_torch_train_parts.py.  BatchNorm statistics at atol 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from jax_weights import redraw
from slice3d_tpu.diffusion.latent import LatentDiffusion as JaxLatentDiffusion
from slice3d_tpu.train.train_ldm import LDMTrainer as JaxTrainer
from slice3d_tpu_torch.convert import (cond_encoder_state_dict, ldm_train_payload,
                                       ldm_unet_state_dict)
from slice3d_tpu_torch.diffusion.latent import LatentDiffusion
from slice3d_tpu_torch.models import ldm_unet
from slice3d_tpu_torch.train.train_ldm import LDMTrainer, trainable_parameters

IMG, B, T, LR = 16, 2, 20, 4e-4
TINY = dict(timesteps=T, vae_ch=32, vae_mult=(1, 2), vae_nres=1, unet_channels=32,
            unet_mult=(1, 2), unet_nres=1, unet_attention_ds=(1,),
            unet_inject_blocks=(0, 3), cond_widths=(32, 64), latent_size=IMG // 2)
TOL = dict(atol=5e-4, rtol=1e-3)
H = IMG // 2  # the latent tile


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores, and a thread pool per worker spends its time waiting for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax_trainer(**kw):
    return JaxTrainer(img_size=IMG, batch_size=B, timesteps=T, base_lr=LR, scale_lr=False,
                      module=JaxLatentDiffusion(**TINY), **kw)


def _capture_grads():
    """An optax transformation that applies nothing and keeps the gradients
    as its state: the JAX step's own gradients, read after the step."""
    return optax.GradientTransformation(
        lambda params: params,
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads),
                                           grads))


def _with_tx(trainer, state):
    """A copy of ``state`` with ``trainer``'s optimizer state (the step
    donates its input)."""
    state = jax.tree_util.tree_map(jnp.array, state)
    return state.replace(opt_state=trainer.tx.init({"net": state.params,
                                                    "logvar": state.logvar}))


def _draws(key):
    """The JAX step's draws from its key (train_ldm.py _step_impl, latent.py
    p_losses, vae.py DiagonalGaussian.sample)."""
    key_enc, key_loss = jax.random.split(key)
    key_t, key_n = jax.random.split(key_loss)
    post = jax.random.normal(key_enc, (B * 13, H, H, 4), jnp.float32)
    return {"posterior_noise": np.array(post).reshape(B, 13, H, H, 4),
            "t": np.array(jax.random.randint(key_t, (B,), 0, T)).astype(np.int64),
            "noise": np.array(jax.random.normal(key_n, (B, 4 * H, 4 * H, 4), jnp.float32))}


def _batch(seed):
    rng = np.random.default_rng(seed)
    views = rng.uniform(-1, 1, (B, 13, IMG, IMG, 3)).astype(np.float32)
    return {"image": views, "img_ipt_view": views[:, 12]}  # as data/ldm_data.py


def _named(net_tree):
    """JAX trainable params (or their gradients) -> the port's names."""
    out = ldm_unet_state_dict(net_tree["model"], "model.diffusion_model")
    out.update(cond_encoder_state_dict({"params": net_tree["cond_stage"]}))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side: one initial state, its scale factor, and one step from
    it with learn_logvar (AdamW on logvar too), with the gradients captured,
    and with the default learn_logvar=False; plus the EMA's eval losses."""
    trainer = _jax_trainer(learn_logvar=True)
    state = trainer.init_state(seed=0)
    variables = redraw({"params": state.params, "batch_stats": state.batch_stats}, 40)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = state.replace(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        ema_params={k: jax.tree_util.tree_map(jnp.array, v) for k, v in params.items()
                    if k != "first_stage"})
    batch = _batch(41)
    state = trainer.maybe_set_scale(state, batch)
    init = {"params": _np(state.params), "stats": _np(state.batch_stats),
            "ema": _np(state.ema_params), "logvar": np.array(state.logvar),
            "scale": float(state.scale_factor)}
    key = jax.random.PRNGKey(42)
    after, logs = trainer.train_step(_with_tx(trainer, state), batch, key)
    capture = _jax_trainer(learn_logvar=True)
    capture.tx = _capture_grads()
    grads = capture.train_step(_with_tx(capture, state), batch, key)[0].opt_state
    fixed = _jax_trainer()
    drift = fixed.train_step(_with_tx(fixed, state), batch, key)[0]
    eval_key = jax.random.PRNGKey(43)
    return {"init": init, "batch": batch, "key": key, "logs": _np(logs),
            "grads": _np(grads),
            "after": {"params": _np(after.params), "stats": _np(after.batch_stats),
                      "ema": _np(after.ema_params), "logvar": np.array(after.logvar)},
            "drift_logvar": np.array(drift.logvar),
            "eval_key": eval_key,
            "eval": trainer.eval_loss(after, batch, eval_key, use_ema=True)}


def _port(jax_run, **kw):
    trainer = LDMTrainer(img_size=IMG, batch_size=B, timesteps=T, base_lr=LR, scale_lr=False,
                         module=LatentDiffusion(**TINY).eval(), device="cpu", **kw)
    init = jax_run["init"]
    state = trainer.init_state()
    trainer.load_payload(state, ldm_train_payload(init["params"], init["stats"], init["ema"],
                                                  init["logvar"], init["scale"]))
    return trainer, state


@pytest.fixture(scope="module")
def port_step(jax_run):
    trainer, state = _port(jax_run, learn_logvar=True)
    before = {n: p.detach().clone() for n, p in state.ldm.named_parameters()}
    state, logs = trainer.train_step(state, jax_run["batch"], draws=_draws(jax_run["key"]))
    return trainer, state, logs, before


def test_maybe_set_scale_matches_jax(jax_run):
    trainer, state = _port(jax_run)
    state.ldm.scale_factor.fill_(1.0)
    post = jax.random.normal(jax.random.PRNGKey(0), (B * 13, H, H, 4), jnp.float32)
    trainer.maybe_set_scale(state, jax_run["batch"],
                            noise=np.array(post).reshape(B, 13, H, H, 4))
    assert float(state.ldm.scale_factor) == pytest.approx(jax_run["init"]["scale"], rel=1e-5)
    assert jax_run["init"]["scale"] != 1.0


def test_train_step_logs_and_gradients_match_jax(jax_run, port_step):
    _, state, logs, _ = port_step
    for k, want in jax_run["logs"].items():
        np.testing.assert_allclose(float(logs[k]), want, **TOL, err_msg=k)
    want = _named(jax_run["grads"]["net"])
    params = trainable_parameters(state.ldm)
    assert set(want) == set(params)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **TOL, err_msg=name)
    np.testing.assert_allclose(state.logvar.grad.numpy(), jax_run["grads"]["logvar"], **TOL)
    # the attention blocks' qkv convs and norms got their gradient
    assert float(params["model.diffusion_model.input_blocks.1.1.qkv.weight"].grad.abs().max()) > 0


def _moved_like(got, before, want, grad, lr, what):
    """Adam's first step: agreement at 1e-6 where |g| >= 1e-5, within 2 lr
    where g is near zero (either sign is within its error)."""
    err = np.abs(got - want)
    firm = np.abs(grad) >= 1e-5
    assert err[firm].max(initial=0) <= 1e-6 + 1e-6 * np.abs(want[firm]).max(initial=0), what
    assert err.max(initial=0) <= 2 * lr + 1e-6, what
    if np.abs(grad).max() > 0:  # weight decay alone moves a weight by < 1 fp32 ulp
        assert np.abs(got - before).max() > 0, what


def test_train_step_updates_like_jax(jax_run, port_step):
    trainer, state, _, before = port_step
    after = jax_run["after"]
    want = _named(after["params"])
    grads = _named(jax_run["grads"]["net"])
    for name, p in trainable_parameters(state.ldm).items():
        _moved_like(p.detach().numpy(), before[name].numpy(), want[name].numpy(),
                    grads[name].numpy(), LR, name)
    # the VAE is frozen: bitwise unchanged
    for name, p in state.ldm.first_stage_model.named_parameters():
        assert torch.equal(p, before[f"first_stage_model.{name}"]), name
    # EMA: decay min(0.9999, 1/10) at the first update, 0.9 of the new weights
    ema_want = _named(after["ema"])
    for name, e in state.ema.items():
        _moved_like(e.numpy(), before[name].numpy(), ema_want[name].numpy(),
                    grads[name].numpy(), LR, f"ema {name}")
    # the conditioner's BatchNorm statistics (but the one no output reads)
    stats = ldm_train_payload(after["params"], after["stats"], after["ema"], after["logvar"],
                              jax_run["init"]["scale"])["model"]
    n = 0
    for name, value in state.ldm.state_dict().items():
        if name.endswith(("running_mean", "running_var")) and ".conv_last." not in name:
            np.testing.assert_allclose(value.numpy(), stats[name].numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)
            n += 1
    assert n == 24
    # learned logvar: both packages move it, alike
    lv = state.logvar.detach().numpy()
    assert np.abs(lv).max() > 0
    np.testing.assert_allclose(lv, after["logvar"], atol=1e-6, rtol=0)


def test_logvar_stays_fixed_where_jax_drifts(jax_run):
    """With learn_logvar=False the JAX trainer's ``optax.masked`` passes the
    raw gradient through for the masked logvar (train_ldm.py:104-108, 232),
    so one step moves it by exactly that gradient; the port keeps it at 0."""
    drift = jax_run["drift_logvar"]
    assert np.abs(drift).max() > 1e-2
    np.testing.assert_allclose(drift, jax_run["grads"]["logvar"], atol=1e-6, rtol=0)
    trainer, state = _port(jax_run)
    state, _ = trainer.train_step(state, jax_run["batch"], draws=_draws(jax_run["key"]))
    assert not state.logvar.requires_grad and torch.count_nonzero(state.logvar) == 0


def test_eval_loss_with_ema_matches_jax(jax_run, port_step):
    trainer, state, _, _ = port_step
    params = {n: p.detach().clone() for n, p in state.ldm.named_parameters()}
    got = trainer.eval_loss(state, jax_run["batch"], draws=_draws(jax_run["eval_key"]))
    for k, want in jax_run["eval"].items():
        np.testing.assert_allclose(got[k], want, **TOL, err_msg=k)
    # the EMA was swapped in for the evaluation only
    for n, p in state.ldm.named_parameters():
        assert torch.equal(p, params[n]), n
    raw = trainer.eval_loss(state, jax_run["batch"], draws=_draws(jax_run["eval_key"]),
                            use_ema=False)
    assert raw["loss_simple"] != got["loss_simple"]


def test_accumulate_holds_then_applies_the_mean(jax_run):
    """accumulate=2: micro-step 1 only accumulates (parameters and EMA hold),
    micro-step 2 applies the mean of both micro-steps' gradients."""
    trainer, state = _port(jax_run, accumulate=2)
    batches = [_batch(50), _batch(51)]
    draws = [_draws(jax.random.PRNGKey(k)) for k in (52, 53)]
    singles = []
    for b, d in zip(batches, draws):  # each micro-step's gradient alone
        _, s = _port(jax_run, accumulate=2)
        trainer.loss_and_grads(s, b, draws=d)
        singles.append({n: p.grad.clone() for n, p in trainable_parameters(s.ldm).items()
                        if p.grad is not None})
    p0 = {n: p.detach().clone() for n, p in trainable_parameters(state.ldm).items()}
    e0 = {n: e.clone() for n, e in state.ema.items()}
    state, _ = trainer.train_step(state, batches[0], draws=draws[0])
    params = trainable_parameters(state.ldm)
    assert all(torch.equal(params[n], p0[n]) for n in p0)
    assert all(torch.equal(state.ema[n], e0[n]) for n in e0)
    state, _ = trainer.train_step(state, batches[1], draws=draws[1])
    assert state.step == 2
    assert all(not torch.equal(params[n], p0[n]) for n in singles[0])
    assert any(not torch.equal(state.ema[n], e0[n]) for n in e0)
    for n, g in singles[0].items():
        torch.testing.assert_close(params[n].grad, g + singles[1][n], atol=1e-7, rtol=1e-6)


def test_checkpoint_round_trip(jax_run, tmp_path):
    trainer, state = _port(jax_run, learn_logvar=True)
    batch = jax_run["batch"]
    state, _ = trainer.train_step(state, batch, draws=_draws(jax.random.PRNGKey(60)))
    path = trainer.save(state, str(tmp_path / "ldm.ckpt"))
    _, fresh = _port(jax_run, learn_logvar=True)
    restored = trainer.restore(fresh, path)
    assert restored.step == state.step == 1
    for (n, a), b in zip(state.ldm.state_dict().items(), restored.ldm.state_dict().values()):
        assert torch.equal(a, b), n
    assert all(torch.equal(state.ema[n], restored.ema[n]) for n in state.ema)
    assert torch.equal(state.logvar, restored.logvar)
    # the optimizer's moments came back too: the next step is the same
    d = _draws(jax.random.PRNGKey(61))
    trainer.train_step(state, batch, draws=d)
    trainer.train_step(restored, batch, draws=d)
    for (n, a), b in zip(state.ldm.named_parameters(), restored.ldm.parameters()):
        assert torch.equal(a, b), n


def test_train_step_routes_attention_through_the_function(jax_run, monkeypatch):
    """The ds-1 blocks (T = 1024) take spatial_attention with grad on: one
    forward per block, and the backward of each."""
    calls = []
    real = ldm_unet.spatial_attention
    monkeypatch.setattr(ldm_unet, "spatial_attention",
                        lambda q, *a: calls.append((tuple(q.shape), q.requires_grad))
                        or real(q, *a))
    trainer, state = _port(jax_run)
    trainer.train_step(state, jax_run["batch"], generator=torch.Generator().manual_seed(0))
    assert calls == [((B, 8, 1024, 4), True)] * 3


def test_trainer_lr_and_device():
    ldm = LatentDiffusion(**TINY)
    assert LDMTrainer(module=ldm, device="cpu").lr == pytest.approx(4e-4)  # 1 x 8 x 5e-5
    assert LDMTrainer(module=ldm, accumulate=2, batch_size=4, device="cpu").lr == (
        pytest.approx(4e-4))
    sched = {"target": "ldm.lr_scheduler.LambdaLinearScheduler",
             "params": {"warm_up_steps": [2], "f_min": [1.0], "f_max": [1.0],
                        "f_start": [1e-6], "cycle_lengths": [1000]}}
    tr = LDMTrainer(module=ldm, scheduler_config=sched, device="cpu")
    assert tr.current_lr(0) < tr.current_lr(2) * 1e-3
    assert tr.current_lr(2) == pytest.approx(tr.lr)


def test_trainer_runs_on_cuda_unless_asked_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LDMTrainer(module=LatentDiffusion(**TINY))
