"""Regression training (SliceNet with the VGG19 term, GTSlice) of the port
against the JAX package's ``RegressionTrainer`` (CPU, fp32).

img 32, batch 2, 16 queries, 12 slices.  Every weight and BatchNorm
statistic is redrawn from a seed on the JAX side and carried into the port
by ``convert.py``; the VGG19 weights are drawn in torchvision's layout and
fed to both packages (``torch_import.vgg19_features`` on the JAX side).  One
JAX run per model (its step compile is the cost): two steps of one jitted
function that returns the gradients beside the update, the first state saved
as the JAX trainer's msgpack checkpoint, and an evaluation.

Tolerances: logs and gradients at atol 5e-4 / rtol 1e-3 (another summation
order through the U-Net or VGG16-BN, the head and VGG19; the readings reach
1.1e-4 where the largest gradient is ~0.2), and each tensor's gradient to
2e-2 of its own norm (``_check_step``).  Where the two fp32 gradients still
disagree (a max-pool near-tie: 5 elements of one GTSlice conv, where JAX is
7.1e-4 off float64 and the port 6.3e-5), JAX's same step in float64 decides:
the port must agree with it.  After Adam's step a parameter moves by about
``lr * m / (sqrt(v) + eps)``, so where a gradient is within its error of
zero (a conv bias right before a train-mode BatchNorm) the two packages may
move it up to 2 lr apart: ``_moved_like`` holds the updated parameters
within 1e-6 + 3e-3 lr where the gradient is firm and within 2 lr + 1e-6
elsewhere.  BatchNorm statistics at atol 1e-5.
"""


import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jax_weights import redraw
from slice3d_tpu import camera as jax_camera
from slice3d_tpu.config import Options as JaxOptions
from slice3d_tpu.convert import torch_import
from slice3d_tpu.data.builders import create_synthetic_dataset as jax_synthetic
from slice3d_tpu.models.sdf_head import prepare_queries as jax_prepare_queries
from slice3d_tpu.models.perceptual import perceptual_loss as jax_perceptual
from slice3d_tpu.models.vgg import VGG19Features as JaxVGG19
from slice3d_tpu.train.train_reg import RegressionTrainer as JaxTrainer
from slice3d_tpu.train.train_reg import make_lr_schedule as jax_schedule
from slice3d_tpu_torch import convert
from slice3d_tpu_torch.config import Options
from slice3d_tpu_torch.data.builders import create_synthetic_dataset
from slice3d_tpu_torch.models.build import load_model
from slice3d_tpu_torch.models.perceptual import perceptual_loss
from slice3d_tpu_torch.models.sdf_head import prepare_queries
from slice3d_tpu_torch.models.vgg import VGG19Features, load_vgg19_features
from slice3d_tpu_torch.train import train_reg
from slice3d_tpu_torch.train.train_reg import RegressionTrainer, make_lr_schedule

IMG, B, Q, LR, SPE = 32, 2, 16, 1e-3, 4
TOL = dict(atol=5e-4, rtol=1e-3)
_STATS = ("running_mean", "running_var", "num_batches_tracked")
# the VGG trunk's last BatchNorm feeds no output: the port does not run it
_UNUSED_BN = ("slices_generator.down5_.", "img_encoder.conv_last.")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    rng = np.random.default_rng(seed)
    rots, trans = zip(*(jax_camera.camera_matrices(az, el, 1.2) for az, el in
                        rng.uniform((0.0, -0.2), (2 * np.pi, 0.6), (B, 2))))
    sdf = rng.normal(size=(B, Q)).astype(np.float32) * 0.1
    return {"img_input": rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
            "img_slices": rng.uniform(-1, 1, (B, 12, IMG, IMG, 3)).astype(np.float32),
            "qry_norot": rng.uniform(-0.5, 0.5, (B, Q, 3)).astype(np.float32),
            "sdf": sdf, "occ": (sdf <= 0).astype(np.float32),
            "obj_rot_mat": np.stack(rots).astype(np.float32),
            "trans_mat_wo_rot_tp": np.stack(trans).astype(np.float32)}


def _vgg19_sd(seed=5):
    """torchvision vgg19's full state_dict layout (features and classifier),
    numpy-drawn: U(+-1/sqrt(fan_in)) weights, U(+-0.1) biases."""
    rng = np.random.default_rng(seed)
    sd, cin, idx = {}, 3, 0
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
              512, 512, 512, 512, "M"):
        if v == "M":
            idx += 1
            continue
        bound = 1.0 / np.sqrt(cin * 9)
        sd[f"features.{idx}.weight"] = rng.uniform(-bound, bound, (v, cin, 3, 3))
        sd[f"features.{idx}.bias"] = rng.uniform(-0.1, 0.1, (v,))
        cin, idx = v, idx + 2
    sd["classifier.0.weight"] = np.zeros((8, 4))
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


def _opts(cls, name, **kw):
    return cls(**dict(dict(name_model=name, img_size=IMG, n_qry=Q, n_bs=B, lr=LR,
                           freq_decay=1, weight_decay=0.5), **kw))


def _to_sd(name, variables):
    to_sd = convert.slicenet_state_dict if name == "slicenet" else convert.gtslice_state_dict
    return to_sd(variables)


def _named_params(name, tree, stats):
    """A JAX params-shaped tree (params, gradients) -> the port's names."""
    return {k: v for k, v in _to_sd(name, {"params": tree, "batch_stats": stats}).items()
            if not k.endswith(_STATS)}


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def vgg_sd():
    return _vgg19_sd()


def _jax_run(name, vgg_sd, tmp_dir):
    vgg = torch_import.vgg19_features(vgg_sd, "features") if name == "slicenet" else None
    trainer = JaxTrainer(_opts(JaxOptions, name), vgg19_params=vgg, steps_per_epoch=SPE)
    state = trainer.init_state()
    variables = redraw({"params": state.params, "batch_stats": state.batch_stats}, 60)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = state.replace(params=params,
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]),
                          opt_state=trainer.tx.init(params))

    def step(state, batch):
        def loss_fn(p):
            out, mut = trainer._forward(trainer.model, {"params": p,
                                                        "batch_stats": state.batch_stats},
                                        batch, ["batch_stats"])
            loss, logs = trainer._losses(out, batch)
            return loss, (logs, mut["batch_stats"])

        (loss, (logs, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, opt = trainer.tx.update(grads, state.opt_state, state.params)
        logs["loss"] = loss
        return state.replace(step=state.step + 1, params=jax.tree_util.tree_map(
            lambda p, u: p + u, state.params, updates), batch_stats=stats,
            opt_state=opt), logs, grads

    jstep = jax.jit(step)
    batches = [_batch(61), _batch(62)]
    s1, logs1, grads1 = jstep(state, batches[0])
    s2, logs2, grads2 = jstep(s1, batches[1])
    ckpt = trainer.save(s1, tmp_dir, 0, {k: float(v) for k, v in logs1.items()})
    return {"variables": variables, "batches": batches, "vgg": vgg, "ckpt": ckpt,
            "logs": [_np(logs1), _np(logs2)], "grads": [_np(grads1), _np(grads2)],
            "after": [{"params": _np(s.params), "stats": _np(s.batch_stats)}
                      for s in (s1, s2)],
            "eval": trainer.eval_epoch(s1, [batches[1]])}


@pytest.fixture(scope="module")
def jax_slicenet(vgg_sd, tmp_path_factory):
    return _jax_run("slicenet", vgg_sd, str(tmp_path_factory.mktemp("jax_slicenet")))


@pytest.fixture(scope="module")
def jax_gtslice(vgg_sd, tmp_path_factory):
    return _jax_run("gtslice", vgg_sd, str(tmp_path_factory.mktemp("jax_gtslice")))


@pytest.fixture(scope="module")
def runs(jax_slicenet, jax_gtslice):
    return {"slicenet": jax_slicenet, "gtslice": jax_gtslice}


def _port(name, run, vgg_sd, state_dict=None, **kw):
    vgg = load_vgg19_features(vgg_sd) if name == "slicenet" and vgg_sd else None
    trainer = RegressionTrainer(_opts(Options, name, **kw), vgg19=vgg, steps_per_epoch=SPE,
                                device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(state_dict or _to_sd(name, run["variables"]))
    return trainer, state


def _moved_like(got, before, want, grad, grad_port, lr, what):
    """Adam's update, element-wise, within 1e-6 + 3e-3 lr where the gradient
    is firm: |g| beyond the gradients' atol 5e-4, or both packages' gradients
    within 2e-3 of each other, relative, and |g| >= 1e-5 (a resumed step's
    ratio of moments then moves by at most 0.75 lr times that relative error,
    the first step's lr times a sign by less than lr eps / |g|).  Within 2 lr
    elsewhere: where g is within its error of zero either sign is right (a
    conv bias right before a train-mode BatchNorm)."""
    err = np.abs(got - want)
    firm = (np.abs(grad) >= TOL["atol"]) | (
        (np.abs(grad_port - grad) <= 2e-3 * np.abs(grad)) & (np.abs(grad) >= 1e-5))
    assert err[firm].max(initial=0) <= 1e-6 + 3e-3 * lr, what
    assert err.max(initial=0) <= 2 * lr + 1e-6, what
    if np.abs(grad).max() > 0:
        assert np.abs(got - before).max() > 0, what


_FP64_GRADS = {}


def _jax_fp64_grads(name, run, k):
    """The JAX trainer's gradients of step ``k`` with float64 weights,
    statistics and batch (``jax.enable_x64``: the networks compute in
    float64, the losses' last reductions and the head's softmax logits in
    fp32 as the trainer writes them), by the port's parameter names.  One
    compile a model, shared by both steps."""
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                                          tree)

        if name not in _FP64_GRADS:
            trainer = JaxTrainer(_opts(JaxOptions, name), steps_per_epoch=SPE,
                                 vgg19_params=None if run["vgg"] is None else f64(run["vgg"]))

            def loss_fn(params, stats, batch):
                out, _ = trainer._forward(trainer.model, {"params": params,
                                                          "batch_stats": stats},
                                          batch, ["batch_stats"])
                return trainer._losses(out, batch)[0]

            _FP64_GRADS[name] = jax.jit(jax.grad(loss_fn))
        state = run["variables"] if k == 0 else {"params": run["after"][0]["params"],
                                                 "batch_stats": run["after"][0]["stats"]}
        grads = _np(_FP64_GRADS[name](f64(state["params"]), f64(state["batch_stats"]),
                                      f64(run["batches"][k])))
    return _named_params(name, grads, state["batch_stats"])


def _check_step(name, run, k, state, before, logs, sd_before):
    """Step ``k`` (0 or 1) of the port against the JAX run's.

    Gradients, element-wise at TOL.  An element beyond it (a max-pool
    near-tie or a ReLU at its edge routes it differently in fp32) must be at
    most 1e-4 of its tensor, and there the port must agree with JAX's same
    step in float64.  Per tensor, relative to its own size: the L2 error at
    most 2e-2 of the tensor's norm (fp32 summation order through the U-Net
    or VGG16-BN reaches 1.03e-2 in tensors whose largest gradient is ~1e-3
    of the model's; a sign flip reads 2, a 10% scale error 0.1), or, in a
    tensor whose gradient cancels by structure (below 1e-6 of the model's
    largest: a conv bias right before a BatchNorm), every element below
    that (readings 1.1e-7)."""
    for key, want in run["logs"][k].items():
        np.testing.assert_allclose(float(logs[key]), want, **TOL, err_msg=key)
    assert set(logs) == set(run["logs"][k])
    stats = run["variables"]["batch_stats"] if k == 0 else run["after"][0]["stats"]
    grads = _named_params(name, run["grads"][k], stats)
    params = dict(state.model.named_parameters())
    assert set(grads) == set(params)
    big = max(float(np.abs(g.numpy()).max()) for g in grads.values())
    fp64 = None
    for n, p in params.items():
        got, want = p.grad.numpy(), grads[n].numpy()
        bad = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)
        if bad.any():
            if fp64 is None:
                fp64 = _jax_fp64_grads(name, run, k)
            assert bad.mean() <= 1e-4, n
            np.testing.assert_allclose(got[bad], fp64[n].numpy()[bad], **TOL, err_msg=n)
        if np.abs(want).max() >= 1e-6 * big:
            rel = np.linalg.norm((got - want).ravel()) / np.linalg.norm(want.ravel())
            assert rel <= 2e-2, (n, rel)
        else:
            assert np.abs(got).max() <= 1e-6 * big, n
    want = _named_params(name, run["after"][k]["params"], stats)
    for n, p in params.items():
        _moved_like(p.detach().numpy(), before[n].numpy(), want[n].numpy(),
                    grads[n].numpy(), p.grad.numpy(), LR, n)
    after = _to_sd(name, {"params": run["after"][k]["params"],
                          "batch_stats": run["after"][k]["stats"]})
    n_bn = 0
    for n, v in state.model.state_dict().items():
        if n.endswith(("running_mean", "running_var")):
            if n.startswith(_UNUSED_BN):
                assert torch.equal(v, sd_before[n]), n
                continue
            np.testing.assert_allclose(v.numpy(), after[n].numpy(), atol=1e-5, rtol=0,
                                       err_msg=n)
            n_bn += 1
    assert n_bn == {"slicenet": 2 * 20, "gtslice": 2 * 12}[name]


@pytest.fixture(scope="module")
def port_steps(runs, vgg_sd):
    out = {}
    for name, run in runs.items():
        trainer, state = _port(name, run, vgg_sd)
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        sd0 = {n: t.clone() for n, t in state.model.state_dict().items()}
        vgg0 = ({n: t.clone() for n, t in trainer.vgg19.state_dict().items()}
                if trainer.vgg19 is not None else None)
        state, logs = trainer.train_step(state, run["batches"][0])
        out[name] = (trainer, state, before, logs, vgg0, sd0)
    return out


@pytest.mark.parametrize("name", ["slicenet", "gtslice"])
def test_train_step_matches_jax(name, runs, port_steps):
    """Logs, gradients, updated parameters and BatchNorm statistics of one
    step (SliceNet with the perceptual term)."""
    _, state, before, logs, _, sd0 = port_steps[name]
    assert state.step == 1
    _check_step(name, runs[name], 0, state, before, logs, sd0)


def test_vgg19_stays_frozen(port_steps):
    trainer, state, _, logs, vgg0, _ = port_steps["slicenet"]
    assert float(logs["loss_vgg"]) > 0
    assert all(not p.requires_grad for p in trainer.vgg19.parameters())
    for n, t in trainer.vgg19.state_dict().items():
        assert torch.equal(t, vgg0[n]), n
    in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert not any(id(p) in in_opt for p in trainer.vgg19.parameters())


@pytest.mark.parametrize("name", ["slicenet", "gtslice"])
def test_eval_epoch_matches_jax(name, runs, port_steps):
    trainer, state, _, _, _, _ = port_steps[name]
    got = trainer.eval_epoch(state, [runs[name]["batches"][1]])
    assert set(got) == set(runs[name]["eval"])
    for k, want in runs[name]["eval"].items():
        np.testing.assert_allclose(got[k], want, **TOL, err_msg=k)


@pytest.mark.parametrize("name", ["slicenet", "gtslice"])
def test_resume_from_jax_msgpack_continues_the_jax_run(name, runs, vgg_sd):
    """The JAX trainer's checkpoint after step 1 (msgpack: variables, Adam's
    moments, epoch, step) restored into the port: the port's step 2 is the
    JAX run's step 2."""
    run = runs[name]
    trainer = RegressionTrainer(_opts(Options, name), vgg19=(
        load_vgg19_features(vgg_sd) if name == "slicenet" else None), steps_per_epoch=SPE,
        device="cpu")
    state, epoch = trainer.restore(trainer.init_state(seed=3), run["ckpt"])
    assert (epoch, state.step) == (1, 1)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    sd1 = {n: t.clone() for n, t in state.model.state_dict().items()}
    state, logs = trainer.train_step(state, run["batches"][1])
    assert state.step == 2
    _check_step(name, run, 1, state, before, logs, sd1)


@pytest.mark.parametrize("name", ["slicenet", "gtslice"])
def test_forward_matches_jax(name, runs, vgg_sd):
    """The training entry in eval mode (running statistics): SliceNet's with
    the object rotation, GTSlice's in test mode; ``prepare_queries`` both
    ways."""
    run = runs[name]
    variables = jax.tree_util.tree_map(jnp.asarray, run["variables"])
    _, state = _port(name, run, vgg_sd)
    model = state.model.eval()
    jax_model = JaxTrainer(_opts(JaxOptions, name), steps_per_epoch=SPE).eval_model
    batch = run["batches"][1]
    img = batch["img_input"] if name == "slicenet" else batch["img_slices"]
    test_mode = name == "gtslice"  # the rotation for SliceNet, the flip for GTSlice
    want = jax.jit(lambda v, *a: jax_model.apply(v, *a, test_mode=test_mode))(
        variables, img, batch["qry_norot"], batch["trans_mat_wo_rot_tp"], batch["obj_rot_mat"])
    with torch.no_grad():
        got = model(*(torch.from_numpy(batch[k]) for k in (
            "img_input" if name == "slicenet" else "img_slices", "qry_norot",
            "trans_mat_wo_rot_tp", "obj_rot_mat")), test_mode=test_mode)
    if name == "gtslice":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    q = batch["qry_norot"]
    for test_mode in (False, True):
        np.testing.assert_allclose(
            prepare_queries(torch.from_numpy(q), torch.from_numpy(batch["obj_rot_mat"]),
                            test_mode=test_mode).numpy(),
            np.asarray(jax_prepare_queries(q, batch["obj_rot_mat"], test_mode=test_mode)),
            atol=1e-6)


def test_vgg19_taps_and_perceptual_loss_match_jax(vgg_sd):
    """The as-executed taps (conv1_2 .. conv4_2 post-ReLU, conv5_2 pre-ReLU)
    of a torchvision vgg19 state_dict, and the weighted loss."""
    rng = np.random.default_rng(70)
    pred = rng.uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (3, IMG, IMG, 3)).astype(np.float32)
    params = torch_import.vgg19_features(vgg_sd, "features")
    vgg = load_vgg19_features(vgg_sd)
    with torch.no_grad():
        taps = vgg(torch.from_numpy(pred).permute(0, 3, 1, 2))
    want = JaxVGG19().apply(params, pred)
    assert [t.shape[1] for t in taps] == [64, 128, 256, 512, 512]
    for t, w in zip(taps, want):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(w), **TOL)
    assert all(float(t.min()) >= 0 for t in taps[:4]) and float(taps[4].min()) < 0
    got = perceptual_loss(vgg, torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(float(got), float(jax_perceptual(params, pred, target)),
                               rtol=1e-5)
    # the features-only layout loads too, and the names are torchvision's
    feats = {k[len("features."):]: v for k, v in vgg_sd.items() if k.startswith("features.")}
    assert set(VGG19Features().state_dict()) <= set(vgg_sd)
    assert all(torch.equal(a, b) for a, b in zip(load_vgg19_features(feats).state_dict().values(),
                                                 vgg.state_dict().values()))


@pytest.mark.parametrize("name", ["slicenet", "gtslice"])
def test_occ_losses_match_jax(name, vgg_sd):
    """``pred_type occ``: the occupancy cross-entropy and accuracy beside the
    image terms, on the same outputs."""
    rng = np.random.default_rng(71)
    batch = _batch(72)
    sdf_pred = rng.normal(size=(B, Q)).astype(np.float32)
    slices = rng.uniform(-1, 1, (B * 12, IMG, IMG, 3)).astype(np.float32)
    vgg = torch_import.vgg19_features(vgg_sd, "features") if name == "slicenet" else None
    jt = JaxTrainer(_opts(JaxOptions, name, pred_type="occ"), vgg19_params=vgg)
    out = (sdf_pred, slices) if name == "slicenet" else sdf_pred
    want_loss, want = jt._losses(out, batch)
    pt = RegressionTrainer(_opts(Options, name, pred_type="occ"), device="cpu", vgg19=(
        load_vgg19_features(vgg_sd) if name == "slicenet" else None))
    loss, logs = pt.losses(torch.from_numpy(sdf_pred),
                           torch.from_numpy(slices) if name == "slicenet" else None, batch)
    assert list(logs) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(logs[k]), float(w), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


def test_lr_at_epoch_and_decay_boundaries(vgg_sd, runs):
    """optax evaluates the schedule at the update count before it counts the
    update: the LR of the last step of a decay period and of the first after
    it, as the trainer applies them, against ``make_lr_schedule``."""
    args = dict(base_lr=LR, steps_per_epoch=3, freq_decay=2, decay=0.5)
    want, got = jax_schedule(**args), make_lr_schedule(**args)
    for step in (0, 2, 3, 5, 6, 11, 12):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-7), step
    trainer, state = _port("gtslice", runs["gtslice"], vgg_sd, freq_decay=2)
    trainer.schedule = got
    state.step = 5  # the last update of epoch 1, which ends the first period
    lrs = []
    for _ in range(2):
        state, _ = trainer.train_step(state, runs["gtslice"]["batches"][0])
        lrs.append(state.optimizer.param_groups[0]["lr"])
    assert lrs == [pytest.approx(float(want(5))), pytest.approx(float(want(6)))]
    assert lrs[1] == pytest.approx(lrs[0] / 2)


def test_checkpoint_round_trip(runs, vgg_sd, tmp_path):
    """save / restore keeps weights, statistics, Adam's moments and the step:
    the next step is the same, and the file name carries the metrics."""
    run = runs["gtslice"]
    trainer, state = _port("gtslice", run, vgg_sd)
    state, logs = trainer.train_step(state, run["batches"][0])
    metrics = {k: float(v) for k, v in logs.items()}
    path = trainer.save(state, str(tmp_path), 3, metrics)
    assert os.path.basename(path) == (f"3_1_{metrics['loss_pred']:.4}_{metrics['acc']:.4}_"
                                      f"{0.0:.4}.ckpt")
    restored, epoch = trainer.restore(trainer.init_state(seed=9), path)
    assert (epoch, restored.step) == (4, 1)
    for (n, a), b in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), n
    for s in (state, restored):
        trainer.train_step(s, run["batches"][1])
    for (n, a), b in zip(state.model.named_parameters(), restored.model.parameters()):
        assert torch.equal(a, b), n


def test_train_dtype_bfloat16_keeps_fp32_master_weights(runs, vgg_sd):
    trainer, state = _port("slicenet", runs["slicenet"], vgg_sd, train_dtype="bfloat16")
    assert state.model.dtype == torch.bfloat16
    state, logs = trainer.train_step(state, runs["slicenet"]["batches"][0])
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in state.model.parameters())
    assert all(v.dtype == torch.float32 and np.isfinite(float(v)) for v in logs.values())
    np.testing.assert_allclose(float(logs["loss"]), runs["slicenet"]["logs"][0]["loss"],
                               rtol=2e-2)


def test_trainer_runs_on_cuda_unless_asked_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RegressionTrainer(Options())


# -- the CLIs on a synthetic dataset ------------------------------------------------------


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The CLIs' scalars printed (TensorBoard, where installed, imports
    TensorFlow: seconds a run)."""
    monkeypatch.setattr(train_reg, "scalar_writer", lambda log_dir: train_reg._PrintWriter())


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    create_synthetic_dataset(str(root / "objaverse"), n_shapes=2, n_views=6, img_size=IMG,
                             n_sdf=64)
    return str(root)


def _cli_args(dataset, exp_dir, name_exp, *extra):
    return ["--dir_data", dataset, "--name_dataset", "objaverse", "--img_size", str(IMG),
            "--n_qry", str(Q), "--n_bs", str(B), "--n_views", "6", "--n_epochs", "1",
            "--freq_log", "1", "--freq_ckpt", "1", "--n_wk", "1", "--lr", str(LR),
            "--dir_experiments", exp_dir, "--name_exp", name_exp, "--device", "cpu", *extra]


def test_train_cli_resume_and_reconstruct(dataset, tmp_path, vgg_sd, capsys, no_tensorboard):
    """``python -m slice3d_tpu_torch.train`` for one epoch with the VGG19 term,
    then ``--resume`` for a second: the step count and the schedule carry on,
    the first run's code snapshot is kept (the JAX package overwrites it);
    the checkpoint loads in ``load_model`` and reconstructs through the
    reconstruct CLI."""
    from slice3d_tpu_torch import reconstruct
    from slice3d_tpu_torch.train.__main__ import main

    exp = str(tmp_path / "exp")
    vgg_path = str(tmp_path / "vgg19.pth")
    torch.save(vgg_sd, vgg_path)
    main(_cli_args(dataset, exp, "run", "--vgg19_ckpt", vgg_path, "--freq_decay", "1"))
    out = capsys.readouterr().out
    assert "loss_vgg" in out and "[val] epoch 0" in out and "[scalar] Loss/val " in out
    ckpt_dir = os.path.join(exp, "run", "ckpt")
    (first,) = os.listdir(ckpt_dir)
    assert first.startswith("0_1_")
    assert os.path.exists(os.path.join(exp, "run", "opts.txt"))
    snap = os.path.join(exp, "run", "code", "slice3d_tpu_torch", "train", "train_reg.py")
    with open(snap, "a") as f:
        f.write("# first run's snapshot\n")
    main(_cli_args(dataset, exp, "run", "--vgg19_ckpt", vgg_path, "--freq_decay", "1",
                   "--resume", "--n_epochs", "2"))
    out = capsys.readouterr().out
    assert "resumed from" in out and "at epoch 1" in out
    # step 2 is the first of epoch 1: the LR has halved
    assert f"[train] epoch 1 iter 2 lr {LR / 2:.6g}" in out
    assert sorted(os.listdir(ckpt_dir))[-1].startswith("1_2_")
    with open(snap) as f:
        assert f.read().endswith("# first run's snapshot\n")

    opts = Options(name_model="slicenet", img_size=IMG, dtype="float32")
    latest = max(os.listdir(ckpt_dir))
    model = load_model(opts, os.path.join(ckpt_dir, latest))
    payload = torch.load(os.path.join(ckpt_dir, latest), weights_only=True)
    for n, t in model.state_dict().items():
        assert torch.equal(t, payload["model"][n]), n
    reconstruct.main(["--dir_data", dataset, "--name_dataset", "objaverse", "--img_size",
                      str(IMG), "--n_views", "6", "--dir_experiments", exp, "--name_exp", "run",
                      "--name_ckpt", latest, "--dtype", "float32", "--mc_res0", "8",
                      "--mc_up_steps", "1", "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(exp, "run", "results", "objaverse"))) == [
        "00000.obj", "00001.obj"]


def test_backup_code_keeps_the_first_snapshot(tmp_path):
    """The JAX package's ``_backup_code`` copies its package over
    ``<exp_dir>/code`` on every start, so a resumed run overwrites the first
    run's snapshot; the port snapshots only where there is none."""
    train_reg._backup_code(str(tmp_path))
    snap = tmp_path / "code" / "slice3d_tpu_torch" / "train" / "train_reg.py"
    assert snap.read_text() == open(train_reg.__file__).read()
    snap.write_text("# the first run's code\n")
    train_reg._backup_code(str(tmp_path))
    assert snap.read_text() == "# the first run's code\n"
    assert not any(p.name == "__pycache__" or p.suffix == ".so"
                   for p in (tmp_path / "code").rglob("*"))


def test_train_cli_refuses_gtslice(dataset, tmp_path):
    from slice3d_tpu_torch.train.__main__ import main

    with pytest.raises(SystemExit, match="train_gt"):
        main(_cli_args(dataset, str(tmp_path), "x", "--name_model", "gtslice"))


def test_train_gt_cli_with_device_preprocess(dataset, tmp_path, capsys, no_tensorboard):
    """``python -m slice3d_tpu_torch.train_gt --device_preprocess --pred_type
    occ --train_dtype bfloat16``: raw uint8 RGBA through
    ``DeviceTransformLoader``, the occupancy loss, bf16 layers."""
    from slice3d_tpu_torch.train_gt import main

    main(_cli_args(dataset, str(tmp_path), "gt", "--device_preprocess", "--pred_type", "occ",
                   "--train_dtype", "bfloat16"))
    out = capsys.readouterr().out
    assert "[train] epoch 0 iter 1" in out
    (ckpt,) = os.listdir(os.path.join(str(tmp_path), "gt", "ckpt"))
    payload = torch.load(os.path.join(str(tmp_path), "gt", "ckpt", ckpt), weights_only=True)
    assert "img_encoder.conv1_2.0.weight" in payload["model"]


@pytest.mark.parametrize("module", ["train", "train_gt"])
def test_cli_runs_on_cuda_unless_asked_otherwise(module, dataset, tmp_path, monkeypatch):
    import importlib

    main = importlib.import_module(
        "slice3d_tpu_torch.train.__main__" if module == "train"
        else "slice3d_tpu_torch.train_gt").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _cli_args(dataset, str(tmp_path), "x")[:-2]  # no --device
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)


def test_synthetic_dataset_matches_jax_builder(dataset, tmp_path):
    """The port's builder writes the JAX builder's pixels and arrays."""
    from slice3d_tpu_torch.data.image import load_image

    theirs = jax_synthetic(str(tmp_path / "jax"), n_shapes=2, n_views=6, img_size=IMG,
                           n_sdf=64)
    ours = os.path.join(dataset, "objaverse")
    files = sorted(os.path.relpath(os.path.join(d, f), theirs)
                   for d, _, fs in os.walk(theirs) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), ours)
                           for d, _, fs in os.walk(ours) for f in fs)
    for rel in files:
        a, b = os.path.join(ours, rel), os.path.join(theirs, rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(load_image(a), load_image(b), err_msg=rel)
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=rel)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


def test_scalars_print_without_tensorboard(monkeypatch, capsys):
    import builtins

    real = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    writer = train_reg.scalar_writer("unused")
    writer.add_scalar("Loss/train", 0.25, 7)
    assert "[scalar] Loss/train 0.25 at step 7" in capsys.readouterr().out
