"""Checkpoint directories of the port's trainers (``--ckpt_backend orbax`` /
``orbax_async``: ``torch.distributed.checkpoint``, ``train/checkpoint.py``)
against the JAX package's orbax backends (CPU, fp32).

The round trip of each directory backend (the ``.tmp`` rename, restores
with and without a target, ``wait_pending``), top-k pruning of directories,
``load_model`` from a directory, ``-r <checkpoint directory>``; and for each
trainer (SliceNet's ``RegressionTrainer``, the tiny ``LDMTrainer``, the tiny
VAE finetune) one state from JAX-drawn weights through a directory round
trip on each side: the port's next step must be the JAX trainer's next step
after its own orbax round trip, at the logs' tolerance of
tests/test_torch_train_{reg,ldm,vae}.py (atol 5e-4 / rtol 1e-3), and the
restored state must be the saved one bit for bit (also after a step, with
AdamW's or Adam's moments set, through ``orbax_async``).  The JAX steps run
from shapes (``jax.eval_shape``) with redrawn values: no JAX init runs.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from jax_weights import redraw
from test_torch_train_ldm import (B as LDM_B, IMG as LDM_IMG, LR as LDM_LR, T as LDM_T,
                                  TINY as LDM_TINY, _batch as ldm_batch, _draws as ldm_draws)
from test_torch_train_reg import _batch as reg_batch
from test_torch_train_reg import _opts as reg_opts
from test_torch_train_vae import WIDTHS as VAE_WIDTHS, _images as vae_images, _noise as vae_noise
from slice3d_tpu.config import Options as JaxOptions
from slice3d_tpu.data.builders import create_synthetic_dataset
from slice3d_tpu.diffusion.latent import LatentDiffusion as JaxLatentDiffusion
from slice3d_tpu.train import train_vae as jax_train_vae
from slice3d_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from slice3d_tpu.train.train_ldm import LDMTrainer as JaxLDMTrainer
from slice3d_tpu.train.train_reg import RegressionTrainer as JaxRegTrainer
from slice3d_tpu_torch import convert
from slice3d_tpu_torch import main as port_main
from slice3d_tpu_torch.config import Options
from slice3d_tpu_torch.diffusion.latent import LatentDiffusion
from slice3d_tpu_torch.models.build import load_model
from slice3d_tpu_torch.train import checkpoint as ckpt
from slice3d_tpu_torch.train.train_ldm import LDMTrainer
from slice3d_tpu_torch.train.train_reg import RegressionTrainer
from slice3d_tpu_torch.train.train_vae import VAEFinetuneTrainer

TOL = dict(atol=5e-4, rtol=1e-3)
BACKENDS = ("orbax", "orbax_async")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy(tree):
    """A payload's tensors copied, its other values as they are."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _same(got, want, where=""):
    """Nested payloads equal bit for bit: keys, dtypes, shapes, values."""
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert torch.equal(got, want), where
    else:
        assert got == want, where


# -- the checkpoint functions ------------------------------------------------------


def _small_state():
    """A Linear, AdamW after one step on it (its state by name), a step count."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(lin.parameters(), lr=1e-2)
    lin(torch.randn(5, 4)).square().sum().backward()
    opt.step()
    return lin, opt, {"model": lin.state_dict(),
                      "adam": ckpt.optimizer_shards(opt, dict(lin.named_parameters())),
                      "step": 7}


@pytest.mark.parametrize("backend", BACKENDS)
def test_directory_round_trip(tmp_path, backend):
    """A directory in DCP's format under its final name once the write ends
    (a stale ``.tmp`` and the files of an earlier directory gone); read back
    whole, in place through a target, and by top-level key."""
    _, _, state = _small_state()
    saved = _copy(state)
    path = str(tmp_path / "a.ckpt")
    os.makedirs(path + ".tmp")
    open(os.path.join(path + ".tmp", "__7_0.distcp"), "wb").close()  # a write cut short
    os.makedirs(path)
    open(os.path.join(path, "__3_0.distcp"), "wb").close()  # an earlier world size's
    assert ckpt.save_checkpoint(path, state, backend) == path
    if backend == "orbax_async":
        ckpt.wait_pending()
    assert sorted(os.listdir(tmp_path)) == ["a.ckpt"]
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp"]
    assert ckpt.is_checkpoint_dir(path) and not ckpt.is_checkpoint_dir(str(tmp_path))
    _same(ckpt.restore_checkpoint(path), saved)
    _same(ckpt.restore_checkpoint(path, keys=("model",)), {"model": saved["model"]})
    lin2, opt2, target = _small_state()
    with torch.no_grad():
        lin2.weight.zero_()
    weight = lin2.weight
    target["step"] = 0
    got = ckpt.restore_checkpoint(path, target=target)
    assert got is target and target["step"] == 7
    assert lin2.weight is weight and torch.equal(weight, saved["model"]["weight"])  # in place
    _same(_copy(target), saved)
    file = ckpt.save_checkpoint(str(tmp_path / "b.ckpt"), saved)  # a file: whole, or by key
    _same(ckpt.restore_checkpoint(file, keys=("step",)), {"step": 7})
    with pytest.raises(ValueError, match="a target restores a checkpoint directory"):
        ckpt.restore_checkpoint(file, target=target)


def test_async_save_returns_before_the_write_and_raises_its_failure(tmp_path, monkeypatch):
    """``orbax_async`` hands the write to a background thread: the name
    appears once it ends (``wait_pending``), one save waits for the one
    before it, and a failed write raises from ``wait_pending``; a save that
    DCP would not run in the background raises at once."""
    import concurrent.futures
    import torch.distributed.checkpoint as dcp

    _, _, state = _small_state()
    real = dcp.async_save
    gate = concurrent.futures.Future()

    def held(*a, **k):  # the write starts once the gate opens
        future = real(*a, **k)
        out = concurrent.futures.Future()
        future.add_done_callback(lambda f: gate.add_done_callback(
            lambda _: out.set_result(f.result())))
        return out

    monkeypatch.setattr(dcp, "async_save", held)
    path = str(tmp_path / "held.ckpt")
    ckpt.save_checkpoint(path, state, "orbax_async")
    time.sleep(0.2)
    assert not os.path.exists(path)  # not renamed while the future is open
    gate.set_result(None)
    ckpt.wait_pending()
    assert ckpt.is_checkpoint_dir(path)

    def failing(*a, **k):
        out = concurrent.futures.Future()
        out.set_exception(OSError("disk full"))
        return out

    monkeypatch.setattr(dcp, "async_save", failing)
    ckpt.save_checkpoint(str(tmp_path / "failed.ckpt"), state, "orbax_async")
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_pending()
    ckpt.wait_pending()  # raised once
    assert not os.path.exists(tmp_path / "failed.ckpt")
    monkeypatch.setattr(dcp, "async_save", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="not a future"):
        ckpt.save_checkpoint(str(tmp_path / "sync.ckpt"), state, "orbax_async")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        ckpt.save_checkpoint(str(tmp_path / "x.ckpt"), state, "orbax2")


def test_topk_prunes_directories_and_latest_picks_the_newest(tmp_path):
    """``TopKCheckpointer(backend="orbax_async")`` keeps the k best
    directories and removes the one that falls out (after ``wait_pending``);
    a new instance seeds from them; ``latest_checkpoint`` picks the newest
    directory (or file) by modification time; ``restore_checkpoint`` refuses a
    JAX orbax directory, naming ``read_flax_checkpoint``, which reads it."""
    _, _, state = _small_state()
    topk = ckpt.TopKCheckpointer(str(tmp_path), monitor="val/loss", k=2, backend="orbax_async")
    kept = [topk.update(v, s, state) for s, v in ((1, 0.5), (2, 0.4), (3, 0.6), (4, 0.3))]
    assert kept[2] is None
    ckpt.wait_pending()
    names = sorted(os.listdir(tmp_path))
    assert names == ["step=000002-val_loss=0.40000.ckpt", "step=000004-val_loss=0.30000.ckpt"]
    assert all(ckpt.is_checkpoint_dir(str(tmp_path / n)) for n in names)
    again = ckpt.TopKCheckpointer(str(tmp_path), monitor="val/loss", k=2, backend="orbax")
    assert [os.path.basename(p) for _, p in again.best] == names[::-1]
    now = time.time()
    os.utime(tmp_path / names[0], (now + 10, now + 10))
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / names[0])
    ckpt.save_checkpoint(str(tmp_path / "last.ckpt"), state)
    os.utime(tmp_path / "last.ckpt", (now + 20, now + 20))
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "last.ckpt")
    jax_dir = jax_save_checkpoint(str(tmp_path / "jax.ckpt"), {"a": jnp.ones(3)},
                                  backend="orbax")
    assert not ckpt.is_checkpoint_dir(jax_dir)
    with pytest.raises(ValueError, match="JAX orbax checkpoint directory.*read_flax_checkpoint"):
        ckpt.restore_checkpoint(jax_dir)


# -- each trainer's next step after a round trip, against JAX's ----------------------


def _jax_reg(path):
    """SliceNet (no VGG19 term) from redrawn weights: the JAX trainer's orbax
    round trip and its next step; the port's state of the same weights."""
    trainer = JaxRegTrainer(reg_opts(JaxOptions, "slicenet", ckpt_backend="orbax"),
                            steps_per_epoch=4)
    shapes = jax.eval_shape(trainer.init_state)
    variables = redraw({"params": shapes.params, "batch_stats": shapes.batch_stats}, 60)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = shapes.replace(step=jnp.int32(0), params=params, opt_state=trainer.tx.init(params),
                           batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                              variables["batch_stats"]))
    saved = trainer.save(state, path, 0, {})
    restored, _ = trainer.restore(jax.tree_util.tree_map(jnp.zeros_like, state), saved)
    batch = reg_batch(61)
    _, logs = trainer._train_step(restored, batch)  # the batch on the state's device

    port = RegressionTrainer(reg_opts(Options, "slicenet", ckpt_backend="orbax"),
                             steps_per_epoch=4, device="cpu")
    pstate = port.init_state()
    pstate.model.load_state_dict(convert.slicenet_state_dict(variables))
    return {"trainer": port, "state": pstate, "logs": logs, "batches": [batch, reg_batch(62)],
            "save": lambda tr, st, p: tr.save(st, p, 0, {}),
            "restore": lambda tr, p: tr.restore(tr.init_state(seed=4), p)[0],
            "payload": lambda tr, st: tr.shard_payload(st, 0),
            "step": lambda tr, st, b, _: tr.train_step(st, b)[1]}


def _jax_ldm(path):
    """The tiny LDM (tests/test_torch_train_ldm.py's) from redrawn weights."""
    trainer = JaxLDMTrainer(img_size=LDM_IMG, batch_size=LDM_B, timesteps=LDM_T, base_lr=LDM_LR,
                            scale_lr=False, module=JaxLatentDiffusion(**LDM_TINY),
                            ckpt_backend="orbax")
    shapes = jax.eval_shape(trainer.init_state, 0)
    variables = redraw({"params": shapes.params, "batch_stats": shapes.batch_stats}, 40)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    ema = {k: jax.tree_util.tree_map(lambda v: v * 0.5, v) for k, v in params.items()
           if k != "first_stage"}
    logvar = jnp.zeros((LDM_T,), jnp.float32)
    state = shapes.replace(
        step=jnp.int32(0), params=params, ema_params=ema, logvar=logvar,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        scale_factor=jnp.float32(0.8),
        opt_state=trainer.tx.init({"net": params, "logvar": logvar}))
    trainer.save(state, path)
    restored = trainer.restore(jax.tree_util.tree_map(jnp.zeros_like, state), path)
    key = jax.random.PRNGKey(42)
    batch = ldm_batch(41)
    _, logs = trainer._train_step(restored, batch, key)  # the batch on the state's device

    port = LDMTrainer(img_size=LDM_IMG, batch_size=LDM_B, timesteps=LDM_T, base_lr=LDM_LR,
                      scale_lr=False, module=LatentDiffusion(**LDM_TINY).eval(), device="cpu",
                      ckpt_backend="orbax")
    pstate = port.init_state()
    np_ = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    port.load_payload(pstate, convert.ldm_train_payload(
        np_(params), np_(state.batch_stats), np_(ema), np.array(logvar), 0.8))
    return {"trainer": port, "state": pstate, "logs": logs,
            "batches": [batch, ldm_batch(43)],
            "save": lambda tr, st, p: tr.save(st, p),
            "restore": lambda tr, p: tr.restore(tr.init_state(), p),
            "payload": lambda tr, st: tr.shard_payload(st),
            "step": lambda tr, st, b, k: tr.train_step(st, b, draws=ldm_draws(k))[1],
            "key": key}


def _jax_vae(path):
    """The tiny VAE finetune (tests/test_torch_train_vae.py's widths, the GAN
    off) from redrawn weights."""
    trainer = jax_train_vae.VAEFinetuneTrainer(ckpt_backend="orbax", **VAE_WIDTHS)
    shapes = jax.eval_shape(trainer.init_state, 0)
    disc = redraw({"params": shapes.disc_params, "batch_stats": shapes.disc_stats}, 11)
    params = redraw({"params": shapes.params}, 10)["params"]
    state = shapes.replace(step=jnp.int32(0), params=params, disc_params=disc["params"],
                           disc_stats=disc["batch_stats"], opt_state=trainer.tx.init(params),
                           disc_opt_state=trainer.tx_d.init(disc["params"]))
    state = jax.tree_util.tree_map(jnp.asarray, state)
    trainer.save(state, path)
    restored = trainer.restore(jax.tree_util.tree_map(jnp.zeros_like, state), path)
    key = jax.random.PRNGKey(13)
    batch = {"image": vae_images(12)}
    _, logs = trainer._step(restored, batch, key)  # the batch on the state's device

    port = VAEFinetuneTrainer(device="cpu", ckpt_backend="orbax", **VAE_WIDTHS)
    pstate = port.init_state()
    pstate.vae.load_state_dict(convert.vae_state_dict(params))
    pstate.disc.load_state_dict(convert.discriminator_state_dict(disc["params"],
                                                                 disc["batch_stats"]))
    return {"trainer": port, "state": pstate, "logs": logs,
            "batches": [batch, {"image": vae_images(14)}],
            "save": lambda tr, st, p: tr.save(st, p),
            "restore": lambda tr, p: tr.restore(tr.init_state(seed=3), p),
            "payload": lambda tr, st: tr.shard_payload(st),
            "step": lambda tr, st, b, k: tr.train_step(
                st, b, draws={"posterior_noise": vae_noise(k)})[1],
            "key": key}


@pytest.mark.parametrize("kind", ["slicenet", "ldm", "vae"])
def test_next_step_after_a_round_trip_matches_jax(kind, tmp_path):
    side = {"slicenet": _jax_reg, "ldm": _jax_ldm, "vae": _jax_vae}[kind](str(tmp_path / "jax"))
    trainer, state = side["trainer"], side["state"]
    save, restore, payload_of, step = (side[k] for k in ("save", "restore", "payload", "step"))
    key = side.get("key")
    saved = _copy(payload_of(trainer, state))
    path = save(trainer, state, str(tmp_path / "port"))
    restored = restore(trainer, path)
    _same(_copy(payload_of(trainer, restored)), saved)
    logs = step(trainer, restored, side["batches"][0], key)
    assert set(logs) == set(side["logs"])
    for k, want in side["logs"].items():
        np.testing.assert_allclose(float(logs[k]), float(want), **TOL, err_msg=k)
    # after that step (the moments set), through orbax_async: the same state,
    # and the same next step bit for bit
    trainer.ckpt_backend = "orbax_async"
    saved = _copy(payload_of(trainer, restored))
    path = save(trainer, restored, str(tmp_path / "port_async"))
    ckpt.wait_pending()
    again = restore(trainer, path)
    _same(_copy(payload_of(trainer, again)), saved)
    logs = [step(trainer, s, side["batches"][1], key) for s in (restored, again)]
    _same(_copy(logs[1]), _copy(logs[0]))
    for name in os.listdir(tmp_path):  # ~250 MB a checkpoint of the tiny LDM
        shutil.rmtree(tmp_path / name)


# -- readers of the directories ---------------------------------------------------------


def test_load_model_reads_a_trainer_directory(tmp_path):
    """``load_model`` takes a ``RegressionTrainer`` directory's ``model``
    entries: the weights that a file of the same state gives."""
    opts = reg_opts(Options, "slicenet", ckpt_backend="orbax")
    trainer = RegressionTrainer(opts, steps_per_epoch=4, device="cpu")
    state = trainer.init_state(seed=7)
    path = trainer.save(state, str(tmp_path), 0, {})
    trainer.ckpt_backend = "msgpack"
    file = trainer.save(state, str(tmp_path / "file"), 0, {})
    inference = Options(name_model="slicenet", img_size=opts.img_size, dtype="float32")
    got = load_model(inference, path).state_dict()
    want = load_model(inference, file).state_dict()
    _same(got, want)
    assert any(not torch.equal(v, load_model(inference).state_dict()[k]) for k, v in got.items())
    shutil.rmtree(path)  # ~230 MB each
    shutil.rmtree(tmp_path / "file")


@pytest.fixture(scope="module")
def ldm_config(tmp_path_factory):
    """The tiny LDM config of tests/test_torch_main_train.py (batch 2) over a
    synthetic dataset of 2 objects, 6 views, 16 px."""
    out = tmp_path_factory.mktemp("ldm_cfg")
    root = create_synthetic_dataset(str(out / "ds"), n_shapes=2, n_views=6, img_size=16,
                                    n_sdf=64)
    split = lambda: {"params": {"size": 16, "root": root, "n_views": 6}}  # noqa: E731
    unet = {"model_channels": 32, "channel_mult": [1, 2], "num_res_blocks": 1,
            "attention_resolutions": [1, 2]}
    cfg = {"model": {"base_learning_rate": 5e-5,
                     "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
                     "params": {"timesteps": 20, "unet_config": {"params": unet},
                                "first_stage_config": {"params": {"ddconfig": {
                                    "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1}}}}},
           "data": {"params": {"batch_size": 2, "train": split(), "validation": split()}}}
    with open(out / "ldm.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return str(out / "ldm.yaml")


class _NoScalars:
    def add_scalar(self, *_):
        pass

    def close(self):
        pass


def test_resume_from_a_checkpoint_directory(ldm_config, tmp_path, monkeypatch):
    """``main -t -r <logdir>/checkpoints/last.ckpt`` (a directory) continues
    that run in its logdir; the JAX root ``main.py`` takes the same path for
    a logdir, finds no checkpoint under it and starts a fresh run inside the
    checkpoint's own directory (ROADMAP.md Queue 3)."""
    import main as root_main

    monkeypatch.setattr(port_main, "scalar_writer", lambda log_dir: _NoScalars())
    flags = ["--val_every", "0", "--log_images_every", "0", "--ckpt_backend", "orbax",
             "--device", "cpu", "--dtype", "float32"]
    logdir = port_main.main(["-b", ldm_config, "-t", "-l", str(tmp_path / "logs"),
                             "--max_steps", "1", "--ckpt_every", "1"] + flags)
    last = os.path.join(logdir, "checkpoints", "last.ckpt")
    assert ckpt.is_checkpoint_dir(last)
    assert port_main.main(["-b", ldm_config, "-t", "-r", last + "/", "--max_steps", "2"]
                          + flags) == logdir
    assert ckpt.restore_checkpoint(last, keys=("step",))["step"] == 2

    class Stop(Exception):
        pass

    saved = []
    init = JaxLDMTrainer.init_state
    monkeypatch.setattr(JaxLDMTrainer, "init_state", lambda self, seed=0: jax.eval_shape(
        lambda s: init(self, s), seed).replace(step=jnp.int32(0)))
    monkeypatch.setattr(JaxLDMTrainer, "maybe_set_scale", lambda *a, **k: (_ for _ in ()).throw(
        Stop()))
    monkeypatch.setattr(JaxLDMTrainer, "save", lambda self, state, path: saved.append(path))
    with pytest.raises(Stop):
        root_main.main(["-b", ldm_config, "-t", "-r", last, "--max_steps", "3"])
    assert saved == [os.path.join(last, "checkpoints", "last.ckpt")]
    assert os.path.isfile(os.path.join(last, "configs", "merged.yaml"))
    shutil.rmtree(logdir)  # ~240 MB
