"""The VAE finetune of the port against the JAX package's (CPU, fp32):
LPIPS, the PatchGAN discriminator, its losses, and ``VAEFinetuneTrainer``.

img 32, 2 images a batch, VAE ch 32 / mult (1, 2) / 1 res block, lr 1e-4.
The VAE's and the discriminator's weights and statistics are redrawn from a
seed on the JAX side and carried into the port by ``convert.py``; the
discriminator's output conv is scaled by 10, so the adaptive weight lies
inside its clip range (below 1e4) with and without LPIPS.  The LPIPS weights
are drawn as a taming LPIPS ``state_dict`` (``torch_refs.TLPIPS``) and read
by both packages (``torch_import.lpips_model`` and ``load_lpips``).  Each
JAX step is the trainer's own jitted step with optax replaced by a
transformation that keeps the gradients (one compile a trainer, three in
all), and the port replays its posterior draw; the JAX update is optax.adam
applied to those gradients.

Once the GAN is on, the JAX step differentiates through the adaptive weight
(``adaptive_disc_weight`` has no ``stop_gradient``); the port detaches it as
the reference does.  So the GAN-on steps are held against the JAX trainer
with ``slice3d_tpu.train.train_vae.adaptive_disc_weight`` wrapped in
``jax.lax.stop_gradient`` inside this test; the GAN-off step against the
JAX trainer as it is, and one test sizes the difference.

Tolerances: logs and gradients at atol 5e-4 / rtol 1e-3 (another summation
order through the VAE, LPIPS and the discriminator); LPIPS distances at
atol 2e-5 / rtol 1e-4 and discriminator logits at 1e-5, as
tests/test_lpips.py holds the JAX LPIPS to its torch twin; BatchNorm
statistics at atol 1e-5.  After Adam's step a parameter moves by about
``lr * m / (sqrt(v) + eps)``, so ``_moved_like`` (as
tests/test_torch_train_reg.py) holds the updated parameters within 1e-6 +
3e-3 lr where the gradient is firm and within 2 lr + 1e-6 elsewhere.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_weights import redraw
from torch_refs import TLPIPS
import slice3d_tpu.train.train_vae as jax_train_vae
from slice3d_tpu.convert.torch_import import lpips_model
from slice3d_tpu.models import discriminator as jax_disc
from slice3d_tpu.models.lpips import lpips_distance
from slice3d_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from slice3d_tpu_torch.convert import (discriminator_state_dict, lpips_state_dict,
                                       vae_state_dict)
from slice3d_tpu_torch.models import discriminator as port_disc
from slice3d_tpu_torch.models.lpips import LPIPS, load_lpips
from slice3d_tpu_torch.train.train_vae import VAEFinetuneTrainer, default_disc_layers

IMG, N, LR, H = 32, 2, 1e-4, 16
WIDTHS = dict(img_size=IMG, vae_ch=32, vae_mult=(1, 2), vae_nres=1, lr=LR)
TOL = dict(atol=5e-4, rtol=1e-3)
LOGS = ("rec_loss", "kl", "g_loss", "d_weight", "ae_loss", "disc_loss")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch in one thread, the module's fixtures included: the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _lpips_sd():
    """A taming LPIPS state_dict with positive heads, as the shipped file."""
    torch.manual_seed(3)
    model = TLPIPS().eval()
    with torch.no_grad():
        for k in range(5):
            getattr(model, f"lin{k}").model[1].weight.abs_()
    return model.state_dict()


def _images(seed, n=N, size=IMG):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


# -- LPIPS, the discriminator and the losses ---------------------------------------


def test_lpips_matches_jax():
    """Per-sample distances at 32 px from one taming-key file, read by
    ``torch_import.lpips_model`` and by ``load_lpips`` (strictly; the scaling
    constants checked, not loaded); ``lpips_state_dict`` maps the JAX
    params back to the file's keys."""
    sd = _lpips_sd()
    params = lpips_model(sd)["params"]
    x, y = _images(0), _images(1)
    want = np.asarray(lpips_distance(params, x, y))
    port = load_lpips(sd)
    got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (N,) and want.min() > 1e-3
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    assert float(port(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) < 1e-7
    assert not any(p.requires_grad for p in port.parameters())
    back = lpips_state_dict(params)
    assert set(back) == set(LPIPS().state_dict()) == set(sd) - {"shift", "scale"}
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    bad = dict(sd, shift=sd["shift"] + 1)
    with pytest.raises(ValueError, match="shift"):
        load_lpips(bad)


@pytest.mark.parametrize("size,n_layers", [(32, 3), (16, 2)])
def test_discriminator_matches_jax(size, n_layers):
    """Logits in train and eval mode, and the running statistics after a
    train pass, from redrawn JAX variables in taming's ``main.*`` names."""
    module = jax_disc.NLayerDiscriminator(n_layers=n_layers, train_bn=True)
    x = _images(2, size=size)
    v = redraw(module.init(jax.random.PRNGKey(0), x), 3)
    want_train, mut = module.apply(v, x, mutable=["batch_stats"])
    want_eval = jax_disc.NLayerDiscriminator(n_layers=n_layers).apply(v, x)
    port = port_disc.NLayerDiscriminator(n_layers=n_layers)
    port.load_state_dict(discriminator_state_dict(v["params"], v["batch_stats"]))
    got_eval = port(torch.from_numpy(x), train=False)
    stats = {k: b.clone() for k, b in port.named_buffers()}
    assert all(torch.equal(b, stats[k]) for k, b in port.named_buffers())  # eval: unmoved
    got_train = port(torch.from_numpy(x), train=True)
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        assert tuple(got.shape) == want.shape == (N, *(2 * (
            jax_disc.patchgan_logits_size(size, n_layers),)), 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    moved = discriminator_state_dict(v["params"], _np(mut["batch_stats"]))
    n = 0
    for k, b in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(b, stats[k]), k
            np.testing.assert_allclose(b.numpy(), moved[k].numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)
            n += 1
    assert n == 2 * n_layers


@pytest.mark.parametrize("size", [16, 32, 128])
def test_patchgan_logits_size_matches_jax(size):
    for n in (1, 2, 3):
        want = jax_disc.patchgan_logits_size(size, n)
        assert port_disc.patchgan_logits_size(size, n) == want
        if want >= 1:
            out = port_disc.NLayerDiscriminator(ndf=8, n_layers=n)(torch.zeros(1, size, size, 3))
            assert tuple(out.shape) == (1, want, want, 1)
    assert default_disc_layers(size) == jax_train_vae.VAEFinetuneTrainer(
        img_size=size, vae_ch=32, vae_mult=(1, 2), vae_nres=1).disc.n_layers
    with pytest.raises(ValueError, match="too small"):
        VAEFinetuneTrainer(img_size=4, device="cpu")


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    real, fake = rng.normal(size=(2, 5, 5, 1)), rng.normal(size=(2, 5, 5, 1))
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    np.testing.assert_allclose(float(port_disc.hinge_d_loss(t(real), t(fake))),
                               float(jax_disc.hinge_d_loss(real, fake)), rtol=1e-6)
    np.testing.assert_allclose(float(port_disc.generator_loss(t(fake))),
                               float(jax_disc.generator_loss(fake)), rtol=1e-6)
    for a, b in ((3.0, 0.5), (1e6, 1e-3), (0.0, 2.0)):
        got = port_disc.adaptive_disc_weight(torch.tensor(a), torch.tensor(b), 0.5)
        np.testing.assert_allclose(float(got), float(jax_disc.adaptive_disc_weight(
            jnp.float32(a), jnp.float32(b), 0.5)), rtol=1e-6)
    w = torch.tensor(3.0, requires_grad=True)
    assert not port_disc.adaptive_disc_weight(w, torch.tensor(1.0)).requires_grad


# -- the trainer's step ----------------------------------------------------------


def _capture():
    """An optax transformation that applies nothing and keeps the gradients
    as its state."""
    return optax.GradientTransformation(
        lambda params: params,
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads),
                                           grads))


def _detached(fn):
    return lambda *a, **k: jax.lax.stop_gradient(fn(*a, **k))


class _JaxSide:
    """A JAX trainer whose optimizers keep the gradients, one compile."""

    def __init__(self, lpips=None):
        self.trainer = jax_train_vae.VAEFinetuneTrainer(disc_start=1, lpips_params=lpips,
                                                        **WIDTHS)
        self.trainer.tx = self.trainer.tx_d = _capture()

    def step(self, init, step, batch, key):
        state = jax_train_vae.VAETrainState(
            step=jnp.int32(step), params=init["params"], disc_params=init["disc_params"],
            disc_stats=init["disc_stats"], opt_state=init["params"],
            disc_opt_state=init["disc_params"])
        state = jax.tree_util.tree_map(jnp.array, state)  # the step donates its input
        after, logs = self.trainer.train_step(state, batch, key)
        return {"logs": _np(logs), "grads": _np(after.opt_state),
                "disc_grads": _np(after.disc_opt_state), "stats": _np(after.disc_stats)}


def _adam_update(params, grads, opt_state=None):
    tx = optax.adam(LR, b1=0.5, b2=0.9)
    opt_state = tx.init(params) if opt_state is None else opt_state
    updates, opt_state = tx.update(grads, opt_state, params)
    return _np(optax.apply_updates(params, updates)), opt_state


def _noise(key):
    return np.array(jax.random.normal(key, (N, H, H, 4), jnp.float32))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX steps from one redrawn initial point: GAN off (step 0) and on
    (step 1) on the trainer as it is; GAN on, with and without LPIPS, with
    the adaptive weight detached; and from the detached step's result, saved
    as the JAX trainer's msgpack checkpoint, the next step."""
    template = jax.eval_shape(  # the state's shapes; every value is drawn below
        jax_train_vae.VAEFinetuneTrainer(disc_start=1, **WIDTHS).init_state, 0)
    disc = redraw({"params": template.disc_params, "batch_stats": template.disc_stats}, 11)
    disc["params"]["conv_out"]["kernel"] *= 10
    init = {"params": redraw({"params": template.params}, 10)["params"],
            "disc_params": disc["params"], "disc_stats": disc["batch_stats"]}
    batch, key = {"image": _images(12)}, jax.random.PRNGKey(13)
    lpips = _lpips_sd()
    raw = _JaxSide()
    runs = {"off": raw.step(init, 0, batch, key), "raw": raw.step(init, 1, batch, key)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train_vae, "adaptive_disc_weight",
                   _detached(jax_disc.adaptive_disc_weight))
        on = _JaxSide()
        runs["on"] = on.step(init, 1, batch, key)
        on_lpips = _JaxSide(lpips_model(lpips)["params"])
        runs["on_lpips"] = on_lpips.step(init, 1, batch, key)
        # the checkpoint after the detached step, and the step after it
        params, opt = _adam_update(init["params"], runs["on"]["grads"])
        dparams, dopt = _adam_update(init["disc_params"], runs["on"]["disc_grads"])
        resumed = {"params": params, "disc_params": dparams, "disc_stats": runs["on"]["stats"]}
        ckpt = str(tmp_path_factory.mktemp("vae_ckpt") / "last.ckpt")
        jax_save_checkpoint(ckpt, {"params": params, "disc_params": dparams,
                                   "disc_stats": runs["on"]["stats"], "opt_state": opt,
                                   "disc_opt_state": dopt, "step": 2})
        batch2, key2 = {"image": _images(14)}, jax.random.PRNGKey(15)
        runs["next"] = on.step(resumed, 2, batch2, key2)
    for name, lp in (("off", None), ("raw", None), ("on", None), ("on_lpips", lpips)):
        runs[name]["after"] = {"params": _adam_update(init["params"], runs[name]["grads"])[0],
                               "disc_params": _adam_update(init["disc_params"],
                                                           runs[name]["disc_grads"])[0]}
    runs["next"]["after"] = {"params": _adam_update(params, runs["next"]["grads"], opt)[0],
                             "disc_params": _adam_update(dparams, runs["next"]["disc_grads"],
                                                         dopt)[0]}
    return {"init": init, "batch": batch, "key": key, "lpips": lpips, "runs": runs,
            "ckpt": ckpt, "resumed": resumed, "batch2": batch2, "key2": key2,
            "lpips_trainer": on_lpips.trainer}


def _port(jax_run, lpips=None):
    trainer = VAEFinetuneTrainer(disc_start=1, lpips_params=lpips, device="cpu", **WIDTHS)
    state = trainer.init_state()
    init = jax_run["init"]
    state.vae.load_state_dict(vae_state_dict(init["params"]))
    state.disc.load_state_dict(discriminator_state_dict(init["disc_params"],
                                                        init["disc_stats"]))
    return trainer, state


def _moved_like(got, before, want, grad, grad_port, lr, what):
    """Adam's update, element-wise, within 1e-6 + 3e-3 lr where the gradient
    is firm (|g| beyond the gradients' atol, or both packages' gradients
    within 2e-3 of each other, relative, and |g| >= 1e-5); within 2 lr
    elsewhere, where either sign of a near-zero gradient is right."""
    err = np.abs(got - want)
    firm = (np.abs(grad) >= TOL["atol"]) | (
        (np.abs(grad_port - grad) <= 2e-3 * np.abs(grad)) & (np.abs(grad) >= 1e-5))
    assert err[firm].max(initial=0) <= 1e-6 + 3e-3 * lr, what
    assert err.max(initial=0) <= 2 * lr + 1e-6, what
    if np.abs(grad).max() > 0:
        assert np.abs(got - before).max() > 0, what


def _check_step(state, logs, before, run):
    """Logs, both networks' gradients and updates, and D's statistics."""
    for k in LOGS:
        np.testing.assert_allclose(float(logs[k]), run["logs"][k], **TOL, err_msg=k)
    for net, grads, after, key in (
            (state.vae, vae_state_dict(run["grads"]), vae_state_dict(run["after"]["params"]),
             "vae"),
            (state.disc, discriminator_state_dict(run["disc_grads"]),
             discriminator_state_dict(run["after"]["disc_params"]), "disc")):
        params = dict(net.named_parameters())
        assert set(params) == set(grads), key
        for name, p in params.items():
            g, want = grads[name].numpy(), after[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), g, **TOL, err_msg=f"{key} {name}")
            _moved_like(p.detach().numpy(), before[key][name], want, g, p.grad.numpy(), LR,
                        f"{key} {name}")
    stats = discriminator_state_dict(run["after"]["disc_params"], run["stats"])
    for name, b in state.disc.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), stats[name].numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)


def _snapshot(state):
    return {"vae": {n: p.detach().numpy().copy() for n, p in state.vae.named_parameters()},
            "disc": {n: p.detach().numpy().copy() for n, p in state.disc.named_parameters()},
            "stats": {n: b.clone() for n, b in state.disc.named_buffers()}}


@pytest.mark.parametrize("case", ["off", "on", "on_lpips"])
def test_train_step_matches_jax(jax_run, case):
    """One step: GAN off against the JAX trainer as it is (D's parameters
    stay, its statistics move), GAN on with and without LPIPS against the
    detached JAX step (the adaptive weight inside its clip range)."""
    trainer, state = _port(jax_run, jax_run["lpips"] if case == "on_lpips" else None)
    state.step = 0 if case == "off" else 1
    before = _snapshot(state)
    state, logs = trainer.train_step(state, jax_run["batch"],
                                     draws={"posterior_noise": _noise(jax_run["key"])})
    run = jax_run["runs"][case]
    _check_step(state, logs, before, run)
    assert 0 < float(logs["d_weight"]) < 0.5 * 1e4
    assert any(not torch.equal(b, before["stats"][n]) for n, b in state.disc.named_buffers()
               if "running" in n)
    if case == "off":
        assert float(logs["disc_loss"]) == 0.0
        for n, p in state.disc.named_parameters():
            assert np.array_equal(p.detach().numpy(), before["disc"][n]), n
    else:
        assert float(logs["disc_loss"]) > 0
        assert all(not np.array_equal(p.detach().numpy(), before["disc"][n])
                   for n, p in state.disc.named_parameters())
    if case == "on_lpips":
        assert float(logs["rec_loss"]) > 10.0  # pixel-summed


def test_undetached_jax_step_differs(jax_run):
    """The JAX trainer as it is differentiates through the adaptive weight:
    with the GAN on its VAE gradient differs from the detached step's (the
    port's) beyond the tolerance, the logs and D's gradient do not."""
    raw, on = jax_run["runs"]["raw"], jax_run["runs"]["on"]
    for k in LOGS:
        np.testing.assert_allclose(raw["logs"][k], on["logs"][k], rtol=1e-6, err_msg=k)
    for name, g in discriminator_state_dict(raw["disc_grads"]).items():
        np.testing.assert_allclose(g.numpy(), discriminator_state_dict(on["disc_grads"])[name]
                                   .numpy(), atol=1e-7, err_msg=name)
    a, b = vae_state_dict(raw["grads"]), vae_state_dict(on["grads"])
    beyond = {n: np.abs(a[n].numpy() - b[n].numpy())
              > TOL["atol"] + TOL["rtol"] * np.abs(b[n].numpy()) for n in a}
    n_beyond = sum(int(m.sum()) for m in beyond.values())
    worst = max(float(np.abs(a[n].numpy() - b[n].numpy()).max()) for n in a)
    total = sum(v.numel() for v in a.values())
    print(f"undetached JAX step: {n_beyond} of {total} VAE gradient elements beyond the "
          f"tolerance, by up to {worst:.4g}")
    assert n_beyond > 0 and worst > 10 * TOL["atol"]


def test_jax_msgpack_checkpoint_resumes_to_the_jax_next_step(jax_run):
    """The JAX trainer's msgpack checkpoint (both Adams' moments) restored
    by the port; the next step equals JAX's next step."""
    trainer, state = _port(jax_run)
    state = trainer.restore(state, jax_run["ckpt"])
    assert state.step == 2
    resumed = jax_run["resumed"]
    for name, v in vae_state_dict(resumed["params"]).items():
        np.testing.assert_array_equal(state.vae.state_dict()[name].numpy(), v.numpy())
    assert state.optimizer.state_dict()["state"][0]["step"] == 1
    before = _snapshot(state)
    state, logs = trainer.train_step(state, jax_run["batch2"],
                                     draws={"posterior_noise": _noise(jax_run["key2"])})
    _check_step(state, logs, before, jax_run["runs"]["next"])
    assert state.step == 3


def test_checkpoint_round_trip(jax_run, tmp_path):
    trainer, state = _port(jax_run)
    state, _ = trainer.train_step(state, jax_run["batch"], torch.Generator().manual_seed(0))
    path = trainer.save(state, str(tmp_path / "vae.ckpt"))
    _, fresh = _port(jax_run)
    restored = trainer.restore(fresh, path)
    assert restored.step == state.step == 1
    for net in ("vae", "disc"):
        for (n, a), b in zip(getattr(state, net).state_dict().items(),
                             getattr(restored, net).state_dict().values()):
            assert torch.equal(a, b), n
    for s in (state, restored):  # the moments came back too: the next step is the same
        s.step = 1
        trainer.train_step(s, jax_run["batch2"], torch.Generator().manual_seed(1))
    for net in ("vae", "disc"):
        for (n, a), b in zip(getattr(state, net).named_parameters(),
                             getattr(restored, net).parameters()):
            assert torch.equal(a, b), n


def test_eval_and_reconstruct_match_jax(jax_run):
    trainer, state = _port(jax_run, jax_run["lpips"])
    jt = jax_run["lpips_trainer"]  # eval_loss and reconstruct read the VAE's params only
    jstate = jax_train_vae.VAETrainState(
        step=0, params=jax.tree_util.tree_map(jnp.asarray, jax_run["init"]["params"]),
        disc_params=None, disc_stats=None, opt_state=None, disc_opt_state=None)
    key = jax.random.PRNGKey(16)
    # the JAX trainer's eval body, run eagerly (``eval_loss`` jits it)
    want = {k: float(v) for k, v in jt._eval_impl(jstate.params, jax_run["batch"], key).items()}
    got = trainer.eval_loss(state, jax_run["batch"], draws={"posterior_noise": _noise(key)})
    assert set(got) == set(want) == {"rec_loss", "kl", "lpips"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    rec = trainer.reconstruct(state, jax_run["batch"]["image"], noise=torch.from_numpy(
        _noise(key)))
    np.testing.assert_allclose(rec.numpy(), jt.reconstruct(jstate, jax_run["batch"]["image"],
                                                           key), **TOL)


def test_trainer_runs_on_cuda_unless_asked_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VAEFinetuneTrainer(img_size=16, vae_ch=32, vae_mult=(1, 2), vae_nres=1)
