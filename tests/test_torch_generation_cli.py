"""The generation route's on-disk CLIs in the port against the root CLIs and
the JAX package (CPU, fp32).

One synthetic dataset (3 objects, 5 views, 20 px images resized to 16), one
tiny LDM config written by PyYAML, one JAX LDM checkpoint (``LDMTrainer.save``
with every weight and the EMA redrawn from a seed): the root ``main.py`` and
``python -m slice3d_tpu_torch.main`` sample from it, the port's ``re_org_slices``
crops the root CLI's montages, and the port's ``reconstruct_slices`` and
``create_dataset_sin_img`` run beside the root ones.  The YAML reader, the
montage functions, ``LDMSliceDataset`` and ``BatchLoader`` are held against
PyYAML and the JAX package's.  Tolerances: files and arrays that the port
writes through the same integer steps are compared exactly; floats atol 5e-4
(fp32, another summation order); the slice dump within 1 grey level (fp32
SliceNets whose slices round to uint8 on either side of a level).
"""

import glob
import os
import pickle
import random
import shutil
import types

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax
import jax.numpy as jnp

from jax_weights import redraw
from slice3d_tpu.data.builders import create_synthetic_dataset
from slice3d_tpu.data.ldm_data import LDMSliceDataset as JaxLDMSliceDataset
from slice3d_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.slicenet import SliceNetModel as JaxSliceNet
from slice3d_tpu.train.checkpoint import save_checkpoint
from slice3d_tpu.utils import montage as jax_montage
from slice3d_tpu_torch import create_dataset_sin_img, re_org_slices, reconstruct_slices
from slice3d_tpu_torch import main as port_main
from slice3d_tpu_torch.config import Options
from slice3d_tpu_torch.data.ldm_data import LDMSliceDataset
from slice3d_tpu_torch.data.pipeline import BatchLoader
from slice3d_tpu_torch.train.checkpoint import restore_checkpoint
from slice3d_tpu_torch.train.train_ldm import LDMTrainer
from slice3d_tpu_torch.utils import montage
from slice3d_tpu_torch.utils.yaml_config import dump_yaml, load_config, load_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 5e-4
IMG, SRC_IMG, N_SHAPES, N_VIEWS, BS, SEED, STEPS = 16, 20, 3, 5, 2, 5, 2


def tiny_cfg(root):
    """A tiny LDM config of the shape of configs/objaverse-ldm-kl-8-infer.yaml."""
    return {"model": {"base_learning_rate": 5.0e-5,
                      "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
                      "params": {"timesteps": 20, "linear_start": 0.0015,
                                 "linear_end": 0.0155, "loss_type": "l1",
                                 "unet_config": {"params": {"model_channels": 32,
                                                            "channel_mult": [1, 2],
                                                            "num_res_blocks": 1,
                                                            "attention_resolutions": [1, 2]}},
                                 "first_stage_config": {"params": {"ddconfig": {
                                     "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1}}}}},
            "data": {"params": {"batch_size": BS, "test": {"params": {
                "size": IMG, "root": root, "n_views": N_VIEWS}}}}}


def vae_cfg(root):
    """tests/test_vae_cli.py's autoencoder config."""
    return {"model": {"base_learning_rate": 4.5e-6,
                      "target": "ldm.models.autoencoder.AutoencoderKL",
                      "params": {"monitor": "val/rec_loss", "embed_dim": 4,
                                 "lossconfig": {
                                     "target": "ldm.modules.losses.LPIPSWithDiscriminator",
                                     "params": {"disc_start": 1, "kl_weight": 1e-6,
                                                "disc_weight": 0.5}},
                                 "ddconfig": {"ch": 32, "ch_mult": [1, 2],
                                              "num_res_blocks": 1, "z_channels": 4}}},
            "data": {"params": {"batch_size": 2, "train": {"params": {"size": 16,
                                                                      "root": root}}}}}


def png(path):
    return np.asarray(Image.open(path))


# -- the YAML reader ---------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(ROOT, "configs")))
                         + ["tiny_ldm", "tiny_vae"])
def test_yaml_reader_equals_pyyaml(name):
    """Every config of configs/ and the tests' configs (written by
    ``yaml.safe_dump``) read as ``yaml.safe_load`` reads them, and
    ``dump_yaml`` of each read back equal by both."""
    if name.endswith(".yaml"):
        text = open(os.path.join(ROOT, "configs", name)).read()
    else:
        text = yaml.safe_dump((tiny_cfg if name == "tiny_ldm" else vae_cfg)("/data/x y"))
    want = yaml.safe_load(text)
    assert load_yaml(text) == want
    assert yaml.safe_load(dump_yaml(want)) == want == load_yaml(dump_yaml(want))


def test_config_merge_and_dotlist_equal_the_root_cli(tmp_path):
    import main as root_main

    extra = tmp_path / "extra.yaml"
    extra.write_text("model:\n  params:\n    timesteps: 50  # fewer\n    new: [a, 'b c']\n")
    bases = [os.path.join(ROOT, "configs", "objaverse-ldm-kl-8.yaml"), str(extra)]
    dots = ["data.params.batch_size=2", "model.params.unet_config.params.channel_mult=[1,2]",
            "a.b.c=yes", "x.y=1.5e-3", "x.z=1e-3", "flag", "x.w=", "x.v={k: [1, 2.0]}"]
    assert load_config(bases, dots) == root_main.load_config(bases, dots)


@pytest.mark.parametrize("text,line", [("a: 1\nb: &anchor 2\n", 2), ("a: *alias\n", 1),
                                       ("a:\n  b: !!str 3\n", 2), ("a: |\n  text\n", 1),
                                       ("a: 0x1f\n", 1), ("a: [1,\n  2]\n", 1),
                                       ("a: 1\n---\nb: 2\n", 2), ("a: b: c\n", 1),
                                       ("a:\n  b: 1\n   c: 2\n", 3)])
def test_yaml_reader_refuses_what_it_does_not_read(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        load_yaml(text)


# -- montages, the LDM dataset and the loader ---------------------------------------------


def test_montage_functions_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    slices = rng.uniform(-1.2, 1.2, (12, 8, 8, 3)).astype(np.float32)
    m = montage.slices_to_montage(slices)
    np.testing.assert_array_equal(m, jax_montage.slices_to_montage(slices))
    np.testing.assert_array_equal(montage.montage_to_slices(m, 8),
                                  jax_montage.montage_to_slices(m, 8))
    u8 = montage.to_uint8(m)
    np.testing.assert_array_equal(u8, jax_montage.to_uint8(m))
    montage.save_image(u8, str(tmp_path / "port.png"))
    jax_montage.save_image(u8, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(png(tmp_path / "port.png"), png(tmp_path / "jax.png"))
    with pytest.raises(ValueError):
        montage.slices_to_montage(slices[:11])


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return create_synthetic_dataset(str(tmp_path_factory.mktemp("gen_cli") / "data" / "objv"),
                                    n_shapes=N_SHAPES, n_views=N_VIEWS, img_size=SRC_IMG,
                                    n_sdf=64, seed=3)


@pytest.mark.parametrize("split", ["train", "validation", "test", "trainval_rec"])
def test_ldm_dataset_equals_jax(data_root, split):
    """Every sample of each split equal to the JAX dataset's (train: the same
    seeded ``random.Random`` picks the view)."""
    mine = LDMSliceDataset(root=data_root, split=split, size=IMG, n_views=N_VIEWS)
    ref = JaxLDMSliceDataset(root=data_root, split=split, size=IMG, n_views=N_VIEWS)
    assert len(mine) == len(ref) == (N_SHAPES * N_VIEWS if split == "trainval_rec"
                                     else N_SHAPES)
    for i in range(len(ref)):
        got, want = mine.__getitem__(i, random.Random(i)), ref.__getitem__(i, random.Random(i))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{split} {i} {k}")


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True), (True, False)])
def test_batch_loader_equals_jax(data_root, shuffle, drop_last):
    """The same batches in the same order, the short last one kept without
    ``drop_last`` (the JAX loader's seeded shuffle)."""
    ds = LDMSliceDataset(root=data_root, split="trainval_rec", size=IMG, n_views=N_VIEWS)
    mine = list(BatchLoader(ds, 4, shuffle=shuffle, drop_last=drop_last, num_workers=3))
    ref = list(JaxBatchLoader(ds, 4, shuffle=shuffle, drop_last=drop_last, num_workers=3))
    assert len(mine) == len(ref) == len(BatchLoader(ds, 4, drop_last=drop_last))
    assert [len(b["view"]) for b in mine] == [len(b["view"]) for b in ref]
    for a, b in zip(mine, ref):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    if not shuffle:
        assert np.concatenate([b["view"] for b in mine]).tolist() == [
            i // N_SHAPES for i in range(N_SHAPES * N_VIEWS)]


def test_batch_loader_raises_a_worker_failure():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError(f"sample {i} is unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(BatchLoader(Broken(), 2, shuffle=False))


# -- main: sampling and the VAE round trip --------------------------------------------------


@pytest.fixture(scope="module")
def runs(data_root, tmp_path_factory):
    """The root CLI and the port's CLI on one JAX checkpoint: (tmp dir, config
    path, the JAX trainer and state, the root logdir, the port logdir)."""
    import main as root_main

    tmp = tmp_path_factory.mktemp("runs")
    cfg = tiny_cfg(data_root)
    cfg_path = str(tmp / "ldm_tiny.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    _, jtrainer, _, _ = root_main.build_module_and_trainer(cfg, True)
    state = jtrainer.init_state(0)
    variables = redraw({"params": state.params, "batch_stats": state.batch_stats}, 70)
    ema = redraw({"params": {k: v for k, v in variables["params"].items()
                             if k != "first_stage"}}, 71)["params"]
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    state = state.replace(params=tree(variables["params"]),
                          batch_stats=tree(variables["batch_stats"]), ema_params=tree(ema),
                          scale_factor=jnp.float32(0.9))
    logdirs = {}
    for who in ("root", "port"):
        logdirs[who] = str(tmp / who)
        jtrainer.save(state, os.path.join(logdirs[who], "checkpoints", "last.ckpt"))
    common = ["-b", cfg_path, "--ddim_steps", str(STEPS), "-s", str(SEED)]
    root_main.main(common + ["-r", logdirs["root"], "--mode", "sample"])
    port_main.main(common + ["-r", logdirs["port"], "--device", "cpu", "--dtype", "float32"])
    port_main.main(common + ["-r", logdirs["port"], "--mode", "rec", "--device", "cpu",
                             "--dtype", "float32"])
    return tmp, cfg_path, jtrainer, state, logdirs["root"], logdirs["port"]


def _files(d):
    return sorted(os.path.relpath(p, d) for p in glob.glob(os.path.join(d, "**", "*"),
                                                           recursive=True)
                  if os.path.isfile(p))


def _port_trainer(cfg_path, ckpt):
    from slice3d_tpu_torch.main import build_module_and_trainer

    cfg = load_config([cfg_path], [])
    _, trainer, _, _ = build_module_and_trainer(cfg, torch.device("cpu"), torch.float32)
    return trainer, trainer.restore(trainer.init_state(), ckpt)


def test_main_writes_the_root_cli_files_and_the_library_samples(runs, data_root):
    """The same file names as the root ``main.py`` (montages and input views
    per batch and case, the short last batch included, the merged config);
    each montage is ``sample_slices`` of the port library under the EMA at
    the batch's seed, and each input view the batch's."""
    _, cfg_path, _, _, root_dir, port_dir = runs
    names = [n for n in _files(port_dir) if not n.startswith("images_reconstructed")]
    assert names == _files(root_dir)
    cases = [f"{b}_{c}" for b, c in (divmod(i, BS) for i in range(N_SHAPES))]
    assert sorted(os.listdir(os.path.join(port_dir, "images_testing_sampled"))) == sorted(
        [f"{n}.png" for n in cases] + [f"{n}_ipt.png" for n in cases])
    assert yaml.safe_load(open(os.path.join(port_dir, "configs", "merged.yaml"))) == \
        yaml.safe_load(open(cfg_path))

    trainer, state = _port_trainer(cfg_path, os.path.join(port_dir, "checkpoints",
                                                          "last.ckpt"))
    ds = LDMSliceDataset(root=data_root, split="test", size=IMG, n_views=N_VIEWS)
    for b in range(-(-N_SHAPES // BS)):
        views = np.stack([ds[i]["img_ipt_view"] for i in range(b * BS,
                                                               min(N_SHAPES, b * BS + BS))])
        gen = trainer.sample_slices(state, views, ddim_steps=STEPS, eta=1.0,
                                    generator=torch.Generator().manual_seed(SEED + b))
        for c in range(len(views)):
            out = os.path.join(port_dir, "images_testing_sampled", f"{b}_{c}")
            np.testing.assert_array_equal(
                png(out + ".png"), montage.to_uint8(montage.slices_to_montage(gen[c].numpy())))
            np.testing.assert_array_equal(png(out + "_ipt.png"), montage.to_uint8(views[c]))


def test_rec_mode_equals_jax_reconstruct_slices(runs, data_root):
    """``--mode rec`` walks trainval once per view in order, batch by batch,
    and writes the VAE round trip; the port's ``reconstruct_slices`` equals
    the JAX trainer's given the same posterior noise (atol 5e-4), and each
    written montage is the port's at the batch's seed."""
    _, cfg_path, jtrainer, state, _, port_dir = runs
    rec_dir = os.path.join(port_dir, "images_reconstructed")
    n = N_SHAPES * N_VIEWS
    assert sorted(os.listdir(rec_dir)) == sorted(f"{b}_{c}.png" for b, c in
                                                  (divmod(i, BS) for i in range(n)))
    trainer, pstate = _port_trainer(cfg_path, os.path.join(port_dir, "checkpoints",
                                                           "last.ckpt"))
    ds = LDMSliceDataset(root=data_root, split="trainval_rec", size=IMG, n_views=N_VIEWS)
    batch = next(iter(BatchLoader(ds, BS, shuffle=False, drop_last=False)))
    key = jax.random.PRNGKey(9)
    want = jtrainer.reconstruct_slices(state, batch, key)
    h = IMG // 2
    noise = np.array(jax.random.normal(key, (BS * 13, h, h, 4), jnp.float32))
    got = trainer.reconstruct_slices(pstate, batch["image"], posterior_noise=torch.from_numpy(
        noise.reshape(BS, 13, h, h, 4)))
    assert tuple(got.shape) == (BS, 12, IMG, IMG, 3) and float(np.std(want)) > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    mine = trainer.reconstruct_slices(pstate, batch["image"],
                                      generator=torch.Generator().manual_seed(SEED))
    for c in range(BS):
        np.testing.assert_array_equal(png(os.path.join(rec_dir, f"0_{c}.png")),
                                      montage.to_uint8(montage.slices_to_montage(
                                          mine[c].numpy())))


def _split_copy(data_root, dst):
    shutil.copytree(os.path.join(data_root, "03_splits"), os.path.join(dst, "03_splits"))
    return dst


@pytest.mark.parametrize("kind", ["gen", "rec"])
def test_re_org_slices_equals_the_root_cli(runs, data_root, kind):
    """The root CLI's sampled montages (gen) and the port's VAE round trips
    (rec), cropped by both tools into their own dataset copies: the same
    tiles, pixel for pixel; rec keeps a tile that exists."""
    import re_org_slices as root_re_org

    tmp, _, _, _, root_dir, port_dir = runs
    src = os.path.join(root_dir if kind == "gen" else port_dir,
                       "images_testing_sampled" if kind == "gen" else "images_reconstructed")
    out = {}
    for who in ("root", "port"):
        base = str(tmp / f"reorg_{kind}_{who}")
        _split_copy(data_root, os.path.join(base, "objv"))
        argv = ["--dir_slices", src, "--type_slices", kind, "--name_dataset", "objv",
                "--dir_data", base, "--img_size", str(IMG), "--n_bs", str(BS),
                "--n_views", str(N_VIEWS)]
        if who == "root":
            root_re_org.crop_slices(root_re_org.get_parser().parse_args(argv))
        else:
            re_org_slices.main(argv)
        out[who] = os.path.join(base, "objv")
    sub = "04_img_slices_gen" if kind == "gen" else "05_img_slices_rec"
    names = _files(os.path.join(out["root"], sub))
    assert names == _files(os.path.join(out["port"], sub))
    assert len(names) == 12 * N_SHAPES * (1 if kind == "gen" else N_VIEWS)
    for name in names:
        np.testing.assert_array_equal(png(os.path.join(out["port"], sub, name)),
                                      png(os.path.join(out["root"], sub, name)))
    if kind == "rec":
        tile = os.path.join(out["port"], sub, names[0])
        Image.fromarray(np.zeros((IMG, IMG, 3), np.uint8)).save(tile)
        re_org_slices.main(["--dir_slices", src, "--type_slices", "rec", "--name_dataset",
                            "objv", "--dir_data", os.path.dirname(out["port"]),
                            "--img_size", str(IMG), "--n_bs", str(BS),
                            "--n_views", str(N_VIEWS)])
        assert not png(tile).any()


# -- the slice dump and the single-image dataset ----------------------------------------------


def test_reconstruct_slices_from_a_jax_checkpoint_equals_the_root_cli(data_root, tmp_path):
    """A JAX msgpack SliceNet checkpoint (``train_reg``'s payload) dumped by
    both CLIs at --dtype float32: the same files, PNGs of 256 x 256 within
    1 grey level."""
    import reconstruct_slices as root_dump

    opts = Options(img_size=32)
    variables = redraw(init_variables(JaxSliceNet(n_slices=12), opts, seed=0), 72)
    exps = {}
    for who in ("root", "port"):
        exps[who] = str(tmp_path / who)
        save_checkpoint(os.path.join(exps[who], "dump", "ckpt", "reg.ckpt"),
                        {"variables": variables, "n_epoch": 1, "n_iter": 2})
    argv = ["--name_dataset", "objv", "--dir_data", os.path.dirname(data_root),
            "--img_size", "32", "--n_views", str(N_VIEWS), "--name_exp", "dump",
            "--name_ckpt", "reg.ckpt", "--dtype", "float32"]
    root_dump.main(argv + ["--dir_experiments", exps["root"]])
    reconstruct_slices.main(argv + ["--dir_experiments", exps["port"], "--device", "cpu"])
    sub = os.path.join("dump", "results_slices", "objv")
    names = _files(os.path.join(exps["root"], sub))
    assert names == _files(os.path.join(exps["port"], sub)) and len(names) == 12 * N_SHAPES
    worst = 0
    for name in names:
        got = png(os.path.join(exps["port"], sub, name)).astype(int)
        want = png(os.path.join(exps["root"], sub, name)).astype(int)
        assert got.shape == want.shape == (256, 256, 3)
        worst = max(worst, int(np.abs(got - want).max()))
    assert worst <= 1


def test_create_dataset_sin_img_equals_the_root_cli(tmp_path):
    """An off-centre RGBA picture: pixel-equal PNGs (the recentred input
    view and the blank slices), equal meta.pkl arrays, SDF array and split
    lists."""
    import create_dataset_sin_img as root_sin

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, size=(48, 40, 4), dtype=np.uint8)
    arr[..., 3] = 0
    arr[3:20, 22:38, 3] = rng.integers(1, 255, size=(17, 16), dtype=np.uint8)
    img_path = str(tmp_path / "input.png")
    Image.fromarray(arr, "RGBA").save(img_path)
    roots = {}
    for who, cli in (("root", root_sin.main), ("port", create_dataset_sin_img.main)):
        roots[who] = str(tmp_path / who)
        cli(["--img_path", img_path, "--name_dataset", "sin", "--dir_data", roots[who],
             "--img_size", "24"])
    names = _files(os.path.join(roots["root"], "sin"))
    assert names == _files(os.path.join(roots["port"], "sin")) and len(names) == 18
    for name in names:
        a, b = (os.path.join(roots[w], "sin", name) for w in ("port", "root"))
        if name.endswith(".png"):
            assert Image.open(a).mode == Image.open(b).mode
            np.testing.assert_array_equal(png(a), png(b), err_msg=name)
        elif name.endswith(".pkl"):
            got, want = pickle.load(open(a, "rb")), pickle.load(open(b, "rb"))
            assert len(got) == len(want) == 7
            for x, y in zip(got, want):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            assert open(a).read() == open(b).read()
    view = png(os.path.join(roots["port"], "sin", "00_img_input", "00000", "004.png"))
    assert view[..., 3].any() and not np.array_equal(view, arr)  # moved to the middle


# -- the device, and training from a root CLI checkpoint ----------------------------------------


def test_entry_points_need_cuda_unless_asked_for_the_cpu(runs, data_root, monkeypatch):
    """Without a card the model CLIs raise unless given --device cpu (they
    never fall back to the CPU by themselves)."""
    _, cfg_path, _, _, _, port_dir = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("sample", "rec"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main.main(["-b", cfg_path, "-r", port_dir, "--mode", mode])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reconstruct_slices.main(["--name_dataset", "objv", "--dir_data",
                                 os.path.dirname(data_root), "--random_init",
                                 "--img_size", "32", "--dtype", "float32"])


@pytest.fixture
def one_torch_thread():
    """Torch in one thread for a test that trains: the test workers share the
    machine's cores (the other tests of this file compare montages with the
    module fixture's, made at the default thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_training_resumes_a_root_cli_checkpoint(runs, data_root, monkeypatch,
                                                one_torch_thread):
    """``-t -r <run>`` on the JAX trainer's msgpack ``last.ckpt`` (what the
    root ``main.py -t`` writes, ``LDMTrainer.save``) saved at step 3: the
    port restores the weights, EMA, ``scale_factor`` and step, skips
    ``maybe_set_scale`` and trains steps 4 and 5 (AdamW starts fresh)."""
    tmp, cfg_path, jtrainer, state, _, _ = runs
    run = str(tmp / "resume_root")
    jtrainer.save(state.replace(step=jnp.int32(3)), os.path.join(run, "checkpoints",
                                                                 "last.ckpt"))
    steps = []
    real = LDMTrainer.train_step

    def spy(self, st, *a, **k):
        st, logs = real(self, st, *a, **k)
        steps.append((st.step, float(st.ldm.scale_factor)))
        return st, logs

    monkeypatch.setattr(LDMTrainer, "train_step", spy)
    scalars = []
    monkeypatch.setattr(port_main, "scalar_writer", lambda log_dir: types.SimpleNamespace(
        add_scalar=lambda *a: scalars.append(a), close=lambda: None))
    train = [f"data.params.train.params.{k}" for k in (f"root={data_root}", f"size={IMG}",
                                                       f"n_views={N_VIEWS}")]
    assert port_main.main(["-b", cfg_path, "-t", "-r", run, "--max_steps", "5",
                           "--val_every", "0", "--log_images_every", "0", "--device", "cpu",
                           "--dtype", "float32"] + train) == run
    assert steps == [(4, pytest.approx(0.9)), (5, pytest.approx(0.9))]
    assert restore_checkpoint(os.path.join(run, "checkpoints", "last.ckpt"))["step"] == 5
