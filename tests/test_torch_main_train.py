"""``python -m slice3d_tpu_torch.main -t`` on an LDM config and on an
autoencoder config, and ``--mode rec`` on an autoencoder config (CPU, fp32).

One synthetic dataset (2 objects, 6 views, 16 px) and the tiny configs of
tests/test_gen_route_e2e.py::test_ldm_train_cli and tests/test_vae_cli.py
(UNet 32 ch, mult [1, 2], attention at ds 1 and 2, T 20; VAE ch 32, mult
[1, 2]; batch 2).  The files each run writes are held to the names the root
``main.py`` writes in the same run (``main.py:226-380`` and ``:430-539``):
``configs/merged.yaml``, ``checkpoints/last.ckpt``, one top-k file named
by its step and monitor, and the montages under ``images/train/``.  The
weights are drawn from ``-s`` (the LDM), from a reference-keyed torch file
(``ckpt_path``, the VAE) and from a taming LPIPS file (``lpips_ckpt``).
Tolerances: montages written through the same integer steps are compared
exactly; two steps of Adam (b1 0.5, b2 0.9) move a weight by at most
(1 + 1.039) lr (the second step's bias-corrected moments bound its ratio by
Cauchy-Schwarz), plus 1e-7 for the weights' fp32 rounding.
"""

import glob
import os
import re
import shutil
import signal

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax
import jax.numpy as jnp

from jax_weights import redraw
from torch_refs import TLPIPS
from slice3d_tpu.data.builders import create_synthetic_dataset
from slice3d_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from slice3d_tpu.train.train_vae import VAEFinetuneTrainer as JaxVAETrainer
from slice3d_tpu_torch import main as port_main
from slice3d_tpu_torch.data.ldm_data import LDMSliceDataset
from slice3d_tpu_torch.data.pipeline import BatchLoader
from slice3d_tpu_torch.models.vae import AutoencoderKL
from slice3d_tpu_torch.train.checkpoint import restore_checkpoint
from slice3d_tpu_torch.train.train_ldm import LDMTrainer
from slice3d_tpu_torch.train.train_vae import VAEFinetuneTrainer
from slice3d_tpu_torch.utils import montage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, N_VIEWS, N_SHAPES, BS, LR = 16, 6, 2, 2, 4.5e-6
CPU = ["--device", "cpu", "--dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch in one thread, the module's fixtures included: the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Scalars:
    """Keeps the scalars the CLI writes (TensorBoard's ``add_scalar``)."""

    def __init__(self):
        self.tags = []

    def add_scalar(self, tag, value, step):
        assert np.isfinite(value), tag
        self.tags.append((tag, step))

    def close(self):
        pass


@pytest.fixture(autouse=True, scope="module")
def scalars():
    """Every run of this module writes its scalars here, not to TensorBoard
    (``scalar_writer``'s choice is tests/test_torch_train_reg.py's)."""
    rec = _Scalars()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_main, "scalar_writer", lambda log_dir: rec)
        yield rec


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return create_synthetic_dataset(str(tmp_path_factory.mktemp("ds")), n_shapes=N_SHAPES,
                                    n_views=N_VIEWS, img_size=IMG, n_sdf=64)


def _splits(root, *names):
    return {s: {"params": {"size": IMG, "root": root, "n_views": N_VIEWS}} for s in names}


def ldm_cfg(root):
    return {"model": {"base_learning_rate": 5e-5,
                      "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
                      "params": {"timesteps": 20,
                                 "unet_config": {"params": {"model_channels": 32,
                                                            "channel_mult": [1, 2],
                                                            "num_res_blocks": 1,
                                                            "attention_resolutions": [1, 2]}},
                                 "first_stage_config": {"params": {"ddconfig": {
                                     "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1}}}}},
            "data": {"params": {"batch_size": BS, **_splits(root, "train", "validation")}}}


def vae_cfg(root, **loss):
    return {"model": {"base_learning_rate": LR,
                      "target": "ldm.models.autoencoder.AutoencoderKL",
                      "params": {"monitor": "val/rec_loss", "embed_dim": 4,
                                 "lossconfig": {
                                     "target": "ldm.modules.losses.LPIPSWithDiscriminator",
                                     "params": {"disc_start": 1, "kl_weight": 1e-6,
                                                "disc_weight": 0.5, **loss}},
                                 "ddconfig": {"ch": 32, "ch_mult": [1, 2],
                                              "num_res_blocks": 1, "z_channels": 4}}},
            "data": {"params": {"batch_size": BS,
                                **_splits(root, "train", "validation", "test")}}}


def _write(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _files(d):
    return sorted(os.path.relpath(p, d) for p in glob.glob(os.path.join(d, "**", "*"),
                                                           recursive=True)
                  if os.path.isfile(p) and "tensorboard" not in p)


def _root_names(step, monitor, images):
    """What the root ``main.py -t`` writes by ``step`` with every interval at
    ``step``, as patterns: the merged config, ``last.ckpt``, the top-k file
    (the monitor's value in its name), the montages."""
    return sorted([re.escape("configs/merged.yaml"), re.escape("checkpoints/last.ckpt"),
                   re.escape(f"checkpoints/step={step:06d}-{monitor}=") + r"\d+\.\d{5}\.ckpt"]
                  + [re.escape(f"images/train/{name}_gs-{step:06d}.png") for name in images])


def _match(files, patterns):
    assert len(files) == len(patterns), files
    for f, p in zip(sorted(files), patterns):
        assert re.fullmatch(p, f), (f, p)


def png(path):
    return np.asarray(Image.open(path))


# -- LDM training ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ldm_run(data_root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ldm")
    cfg_path = _write(tmp / "ldm.yaml", ldm_cfg(data_root))
    logdir = port_main.main(["-b", cfg_path, "-t", "-l", str(tmp / "logs"), "-n", "ldm",
                             "--max_steps", "2", "--ckpt_every", "2", "--val_every", "2",
                             "--log_images_every", "2", "--ddim_steps", "2",
                             "--log_progressive_rows", "--log_every_t", "10", "--gpus", "0",
                             "--scale_lr", "False"] + CPU)
    return cfg_path, logdir


def test_ldm_train_writes_the_root_cli_files(ldm_run, scalars):
    """Two steps with every interval at 2: the root CLI's names, the merged
    config, a finite ``last.ckpt`` at step 2 with AdamW's state and the
    moved EMA, montages of 4 x 4 tiles (the progressive and diffusion rows
    one montage column per logged step: t = 19, 10, 0)."""
    cfg_path, logdir = ldm_run
    assert os.path.basename(logdir).endswith("_ldm")
    assert {("val/loss_simple", 2), ("val/loss_simple_ema", 2)} <= set(scalars.tags)
    _match(_files(logdir), _root_names(2, "val_loss_simple_ema", (
        "diffusion_row", "inputs", "progressive_row", "reconstruction", "samples")))
    assert yaml.safe_load(open(os.path.join(logdir, "configs", "merged.yaml"))) == \
        yaml.safe_load(open(cfg_path))
    payload = restore_checkpoint(os.path.join(logdir, "checkpoints", "last.ckpt"))
    assert payload["step"] == 2 and payload["optimizer"]["state"]
    assert all(torch.isfinite(v).all() for v in payload["model"].values()
               if v.is_floating_point())
    assert payload["optimizer"]["param_groups"][0]["lr"] == pytest.approx(5e-5)  # --scale_lr
    assert float(payload["model"]["scale_factor"]) != 1.0  # maybe_set_scale ran
    img = os.path.join(logdir, "images", "train")
    for name in ("inputs", "reconstruction", "samples"):
        assert png(os.path.join(img, f"{name}_gs-000002.png")).shape == (4 * IMG, 4 * IMG, 3)
    for name in ("progressive_row", "diffusion_row"):
        assert png(os.path.join(img, f"{name}_gs-000002.png")).shape == (4 * IMG, 12 * IMG, 3)


def test_ldm_train_resumes_its_checkpoint(ldm_run, tmp_path, monkeypatch):
    """``-r <logdir>`` continues at the saved step with AdamW's moments;
    ``-r <file>`` too."""
    cfg_path, logdir = ldm_run
    steps = []
    real = LDMTrainer.train_step

    def spy(self, state, *a, **k):
        state, logs = real(self, state, *a, **k)
        steps.append(state.step)
        return state, logs

    monkeypatch.setattr(LDMTrainer, "train_step", spy)
    run = str(tmp_path / "run")
    os.makedirs(os.path.join(run, "checkpoints"))
    last = os.path.join(run, "checkpoints", "last.ckpt")
    with open(os.path.join(logdir, "checkpoints", "last.ckpt"), "rb") as f, \
            open(last, "wb") as g:
        g.write(f.read())
    assert port_main.main(["-b", cfg_path, "-t", "-r", run, "--max_steps", "3",
                           "--val_every", "0", "--log_images_every", "0"] + CPU) == run
    port_main.main(["-b", cfg_path, "-t", "-r", last, "--max_steps", "4",
                    "--val_every", "0", "--log_images_every", "0"] + CPU)
    assert steps == [3, 4]
    payload = restore_checkpoint(last)
    assert payload["step"] == 4
    assert int(payload["optimizer"]["state"][0]["step"]) == 4


def test_ldm_train_writes_an_emergency_checkpoint(ldm_run, tmp_path, monkeypatch):
    """SIGUSR1 writes ``last.ckpt`` after the step it arrives in; an
    exception inside the loop writes it and re-raises."""
    cfg_path, _ = ldm_run
    real = LDMTrainer.train_step
    calls = []

    def flaky(self, state, *a, **k):
        calls.append(state.step)
        if len(calls) == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        if len(calls) == 3:
            raise RuntimeError("device lost")
        return real(self, state, *a, **k)

    monkeypatch.setattr(LDMTrainer, "train_step", flaky)
    saved = []
    real_save = LDMTrainer.save
    monkeypatch.setattr(LDMTrainer, "save", lambda self, state, path: saved.append(
        state.step) or real_save(self, state, path))
    with pytest.raises(RuntimeError, match="device lost"):
        port_main.main(["-b", cfg_path, "-t", "-l", str(tmp_path), "--max_steps", "5",
                        "--ckpt_every", "100", "--val_every", "0",
                        "--log_images_every", "0"] + CPU)
    assert saved == [1, 2]  # the signal after step 1, the exception at step 2
    last = glob.glob(str(tmp_path / "*" / "checkpoints" / "last.ckpt"))
    assert len(last) == 1 and restore_checkpoint(last[0])["step"] == 2


# -- the VAE finetune --------------------------------------------------------------


@pytest.fixture(scope="module")
def vae_files(tmp_path_factory):
    """A taming LPIPS torch file and a reference kl-f8 torch checkpoint
    (``state_dict`` with the VAE's keys and ``loss.*`` entries), drawn."""
    tmp = tmp_path_factory.mktemp("vae_files")
    torch.manual_seed(5)
    lpips = TLPIPS().state_dict()
    for k in range(5):
        lpips[f"lin{k}.model.1.weight"].abs_()
    torch.save(lpips, tmp / "lpips.pth")
    vae = AutoencoderKL(ch=32, ch_mult=(1, 2), num_res_blocks=1).state_dict()
    ref = {k: v.clone() for k, v in vae.items()}
    ref["loss.logvar"] = torch.zeros(())
    torch.save({"state_dict": ref}, tmp / "kl-f8.ckpt")
    return str(tmp / "lpips.pth"), str(tmp / "kl-f8.ckpt"), vae


@pytest.fixture(scope="module")
def vae_run(data_root, vae_files, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vae")
    lpips, ckpt, vae = vae_files
    cfg = vae_cfg(data_root, lpips_ckpt=lpips)
    cfg["model"]["params"]["ckpt_path"] = ckpt
    cfg_path = _write(tmp / "vae.yaml", cfg)
    logs = []
    real = VAEFinetuneTrainer.train_step

    def spy(self, state, batch, *a, **k):
        if state.step == 0:
            logs.append([{n: p.detach().clone() for n, p in net.named_parameters()}
                         for net in (state.vae, state.disc)])
        state, out = real(self, state, batch, *a, **k)
        logs.append((state.step, len(batch["image"]), {k: float(v) for k, v in out.items()},
                     {n: p.detach().clone() for n, p in state.disc.named_parameters()}))
        return state, out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(VAEFinetuneTrainer, "train_step", spy)
        logdir = port_main.main(["-b", cfg_path, "-t", "-l", str(tmp / "logs"),
                                 "--max_steps", "2", "--ckpt_every", "2", "--val_every", "2",
                                 "--log_images_every", "2"] + CPU)
    return cfg_path, logdir, logs


def test_vae_finetune_writes_the_root_cli_files(vae_run, vae_files, scalars):
    """Two steps of 13 x 2 images from the reference checkpoint with LPIPS:
    the root CLI's names (top-k on ``val/rec_loss``); the VAE started at
    ``ckpt_path``'s weights; the NLL pixel-summed (LPIPS on); D unmoved at
    step 1 (GAN off) and moved at step 2; finite weights at step 2."""
    _, logdir, logs = vae_run
    (init, d0), (s1, n1, l1, d1), (s2, _, l2, d2) = logs
    assert {(f"val/{k}", 2) for k in ("rec_loss", "kl", "lpips")} <= set(scalars.tags)
    _match(_files(logdir), _root_names(2, "val_rec_loss", ("inputs", "reconstruction")))
    assert (s1, s2, n1) == (1, 2, 13 * BS)
    for name, v in vae_files[2].items():
        if name in init:
            assert torch.equal(init[name], v), name
    assert l1["rec_loss"] > 10 and l1["disc_loss"] == 0 and l2["disc_loss"] > 0
    assert all(torch.equal(d1[n], v) for n, v in d0.items())
    assert any(not torch.equal(d2[n], v) for n, v in d0.items())
    assert all(0 <= l["d_weight"] <= 1e4 for l in (l1, l2))
    payload = restore_checkpoint(os.path.join(logdir, "checkpoints", "last.ckpt"))
    assert payload["step"] == 2 and payload["disc_adam"]["count"] == 2
    assert all(torch.isfinite(v).all() for v in payload["vae"].values() if v.is_floating_point())
    moved = max(float((payload["vae"][n] - v).abs().max()) for n, v in init.items())
    assert 0 < moved <= 2.04 * LR + 1e-7
    for name in ("inputs", "reconstruction"):
        assert png(os.path.join(logdir, "images", "train", f"{name}_gs-000002.png")).shape == (
            4 * IMG, 4 * IMG, 3)


def test_vae_finetune_resumes(vae_run):
    cfg_path, logdir, _ = vae_run
    assert port_main.main(["-b", cfg_path, "-t", "-r", logdir, "--max_steps", "3",
                           "--val_every", "0", "--log_images_every", "0"] + CPU) == logdir
    payload = restore_checkpoint(os.path.join(logdir, "checkpoints", "last.ckpt"))
    assert payload["step"] == 3 and payload["adam"]["count"] == 3


def test_vae_finetune_writes_an_emergency_checkpoint(data_root, tmp_path, monkeypatch):
    cfg_path = _write(tmp_path / "vae.yaml", vae_cfg(data_root))
    real = VAEFinetuneTrainer.train_step

    def flaky(self, state, *a, **k):
        if state.step == 1:
            raise RuntimeError("device lost")
        return real(self, state, *a, **k)

    monkeypatch.setattr(VAEFinetuneTrainer, "train_step", flaky)
    with pytest.raises(RuntimeError, match="device lost"):
        port_main.main(["-b", cfg_path, "-t", "-l", str(tmp_path / "logs"),
                        "--max_steps", "4", "--val_every", "0",
                        "--log_images_every", "0"] + CPU)
    last = glob.glob(str(tmp_path / "logs" / "*" / "checkpoints" / "last.ckpt"))
    assert len(last) == 1 and restore_checkpoint(last[0])["step"] == 1


# -- --mode rec on an autoencoder config ----------------------------------------------


@pytest.fixture(scope="module")
def jax_vae_run(tmp_path_factory):
    """A JAX VAE finetune run's logdir: ``last.ckpt`` of the JAX trainer's
    ``state_payload`` (msgpack), as the root ``main.py -t`` writes it."""
    run = str(tmp_path_factory.mktemp("jax_vae_run"))
    trainer = JaxVAETrainer(img_size=IMG, vae_ch=32, vae_mult=(1, 2), vae_nres=1)
    shapes = jax.eval_shape(trainer.init_state, 0)  # every value is drawn below
    disc = redraw({"params": shapes.disc_params, "batch_stats": shapes.disc_stats}, 21)
    params = redraw({"params": shapes.params}, 20)["params"]
    state = shapes.replace(step=jnp.int32(0), params=params, disc_params=disc["params"],
                           disc_stats=disc["batch_stats"], opt_state=trainer.tx.init(params),
                           disc_opt_state=trainer.tx_d.init(disc["params"]))
    jax_save_checkpoint(os.path.join(run, "checkpoints", "last.ckpt"),
                        trainer.state_payload(state))
    return run, trainer, state


def _rec_names():
    n = N_SHAPES * N_VIEWS  # trainval_rec: every object once per view
    return sorted(f"{b}_{c}.png" for b, c in (divmod(i, BS) for i in range(n)))


@pytest.mark.parametrize("source", ["port", "jax"])
def test_rec_mode_on_an_autoencoder_config(vae_run, jax_vae_run, data_root, tmp_path, source):
    """``--mode rec`` from a finetune run (the port's, or the JAX package's
    msgpack): the trainval_rec split batch by batch, each montage the VAE's
    round trip of the batch's 12 slices at the batch's seed."""
    cfg_path = _write(tmp_path / "vae.yaml", vae_cfg(data_root))
    run = vae_run[1] if source == "port" else jax_vae_run[0]
    logdir = port_main.main(["-b", cfg_path, "-r", run, "--mode", "rec", "-s", "3"] + CPU)
    rec_dir = os.path.join(logdir, "images_reconstructed")
    assert sorted(os.listdir(rec_dir)) == _rec_names()
    trainer = VAEFinetuneTrainer(img_size=IMG, vae_ch=32, vae_mult=(1, 2), vae_nres=1,
                                 device="cpu")
    state = trainer.init_state()
    state = trainer.restore(state, latest_checkpoint_of(run))
    ds = LDMSliceDataset(root=data_root, split="trainval_rec", size=IMG, n_views=N_VIEWS)
    for b, batch in enumerate(BatchLoader(ds, BS, shuffle=False, drop_last=False)):
        if b == 2:
            break
        x = batch["image"][:, :12].reshape(-1, IMG, IMG, 3)
        rec = trainer.reconstruct(state, x, generator=torch.Generator().manual_seed(3 + b))
        rec = rec.reshape(-1, 12, IMG, IMG, 3).numpy()
        for c in range(len(rec)):
            np.testing.assert_array_equal(png(os.path.join(rec_dir, f"{b}_{c}.png")),
                                          montage.to_uint8(montage.slices_to_montage(rec[c])))


def latest_checkpoint_of(run):
    return os.path.join(run, "checkpoints", "last.ckpt")


def test_root_cli_fails_where_the_port_reconstructs(jax_vae_run, data_root):
    """The root CLI on configs/autoencoder_kl_f8_infer.yaml with ``-r`` a VAE
    finetune run and ``--mode rec`` builds an LDM trainer (``main.py:400-401``)
    and cannot restore the finetune payload into it (ROADMAP Queue 3).  The
    dotlist shrinks the LDM it builds from defaults the config does not set,
    and its initial state is built as shapes only (``jax.eval_shape``): the
    restore fails on the payload's keys before it reads a value.
    And the root finetune's ``lpips_ckpt`` path passes ``lpips_model``'s
    ``{"params": ...}`` where the trainer wants its inside, so its first
    LPIPS call fails; the port reads the same file (above)."""
    import main as root_main
    from slice3d_tpu.convert.torch_import import lpips_model

    from slice3d_tpu.train.train_ldm import LDMTrainer as JaxLDMTrainer

    run, trainer, state = jax_vae_run
    shrink = [f"model.params.unet_config.params.{k}" for k in (
        "model_channels=32", "channel_mult=[1,2]", "num_res_blocks=1",
        "attention_resolutions=[2]")] + [
        f"model.params.first_stage_config.params.ddconfig.{k}" for k in (
            "ch=32", "ch_mult=[1,2]", "num_res_blocks=1")] + [
        "model.params.timesteps=20", f"data.params.test.params.size={IMG}",
        f"data.params.test.params.root={data_root}", f"data.params.test.params.n_views={N_VIEWS}"]
    init = JaxLDMTrainer.init_state
    with pytest.MonkeyPatch.context() as mp, \
            pytest.raises(ValueError, match="keys do not match"):
        # the LDM state only as shapes: the restore compares its keys
        mp.setattr(JaxLDMTrainer, "init_state",
                   lambda self, seed=0: jax.eval_shape(lambda s: init(self, s), seed))
        root_main.main(["-b", os.path.join(ROOT, "configs", "autoencoder_kl_f8_infer.yaml"),
                        "-r", run, "--mode", "rec"] + shrink)
    trainer.lpips_params = lpips_model(TLPIPS().state_dict())
    with pytest.raises(Exception, match="extra params layer"):
        trainer.eval_loss(state, {"image": np.zeros((BS, IMG, IMG, 3), np.float32)},
                          jax.random.PRNGKey(0))


# -- options and the device -------------------------------------------------------------


def test_sampling_an_autoencoder_is_refused(data_root, tmp_path):
    cfg_path = _write(tmp_path / "vae.yaml", vae_cfg(data_root))
    with pytest.raises(ValueError, match="samples nothing"):
        port_main.main(["-b", cfg_path] + CPU)


def _trained_state(cfg_path, path):
    """The trainer's gathered payload of the checkpoint at ``path`` (a file
    or a directory), read through the trainer the config builds."""
    from slice3d_tpu_torch.utils.yaml_config import load_config

    cfg = load_config([cfg_path], [])
    if port_main.is_autoencoder_target(cfg):
        trainer = port_main.build_vae_trainer(cfg, "cpu", torch.float32)[0]
        state = trainer.restore(trainer.init_state(), path)
    else:
        trainer = port_main.build_module_and_trainer(cfg, "cpu", torch.float32)[1]
        state = trainer.restore(trainer.init_state(), path)
    payload = trainer.state_payload(state)
    payload.pop("optimizer", None)  # the LDM's: its hyperparameters come from the file
    payload["moments"] = [{k: v for k, v in st.items()}
                          for opt in ([state.optimizer] + ([state.disc_optimizer]
                                                           if hasattr(state, "disc") else []))
                          for st in opt.state.values()]
    return payload


@pytest.mark.parametrize("config", ["ldm", "vae"])
def test_orbax_async_trains_prunes_and_resumes_like_msgpack(data_root, tmp_path, config,
                                                           monkeypatch):
    """``main -t --ckpt_backend orbax_async``: ``last.ckpt`` and the top-k
    checkpoint are directories (DCP's ``.metadata`` and one ``.distcp``
    file), and ``-r <logdir>`` resumes from them to the state that the same
    runs with ``msgpack`` files reach, bit for bit (each object's training
    view fixed, where the dataset draws one at random, so that the runs see
    the same batches)."""
    monkeypatch.setattr(LDMSliceDataset, "_view_for",
                        lambda self, index, rng: index % self.n_views)
    cfg = ldm_cfg(data_root) if config == "ldm" else vae_cfg(data_root)
    cfg_path = _write(tmp_path / f"{config}.yaml", cfg)
    flags = ["--val_every", "2", "--log_images_every", "0", "--ckpt_every", "2"] + CPU
    last = {}
    for backend in ("msgpack", "orbax_async"):
        logdir = port_main.main(["-b", cfg_path, "-t", "-l", str(tmp_path / backend),
                                 "--max_steps", "2", "--ckpt_backend", backend] + flags)
        names = sorted(os.listdir(os.path.join(logdir, "checkpoints")))
        assert len(names) == 2 and names[0] == "last.ckpt" and names[1].startswith("step=000002")
        for name in names:
            path = os.path.join(logdir, "checkpoints", name)
            if backend == "msgpack":
                assert os.path.isfile(path)
            else:
                assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp"]
        assert port_main.main(["-b", cfg_path, "-t", "-r", logdir, "--max_steps", "3",
                               "--ckpt_backend", backend] + flags) == logdir
        last[backend] = _trained_state(cfg_path, os.path.join(logdir, "checkpoints",
                                                              "last.ckpt"))
    assert last["msgpack"]["step"] == 3
    _same_payload(last["orbax_async"], last["msgpack"])
    for backend in last:  # the runs' checkpoints: ~250 MB each for the LDM
        shutil.rmtree(tmp_path / backend)


def _same_payload(got, want, where=""):
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same_payload(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same_payload(a, b, f"{where}/{i}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), where
    else:
        assert got == want, where


def test_training_needs_cuda_unless_asked_for_the_cpu(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ldm = _write(tmp_path / "ldm.yaml", ldm_cfg(data_root))
    vae = _write(tmp_path / "vae.yaml", vae_cfg(data_root))
    for argv in (["-b", ldm, "-t"], ["-b", vae, "-t"], ["-b", vae, "--mode", "rec"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main.main(argv + ["-l", str(tmp_path / "logs")])
    assert not os.path.exists(tmp_path / "logs")
