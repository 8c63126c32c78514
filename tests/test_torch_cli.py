"""The port's reconstruct CLI against the root one (CPU, fp32).

Both CLIs read the same synthetic dataset (3 shapes) and the same
reference-format checkpoint, ``{"model": slicenet_state_dict(JAX seed-0
variables)}``, and reconstruct its test split at img 32, res0 16, up 1 in
batches of 2 (a padded tail).  The root CLI's Reconstructor ships values as
float16 by default, which the port leaves out, so its values are shipped in
fp32 here.  The ``.obj`` files must have equal face lists and vertices within
1e-4.
"""

import functools
import os
import re
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

from jax_weights import redraw
from slice3d_tpu.data import Slice3DDataset as JaxDataset
from slice3d_tpu.data.builders import create_synthetic_dataset
from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.camnet import CameraNet as JaxCameraNet
from slice3d_tpu.models.disn import DISNModel as JaxDISN
from slice3d_tpu.models.slicenet import SliceNetModel as JaxSliceNet
from slice3d_tpu.pipeline import Reconstructor as JaxReconstructor
from slice3d_tpu_torch import pipeline
from slice3d_tpu_torch import reconstruct as port_cli
from slice3d_tpu_torch.convert import camnet_state_dict, disn_state_dict, slicenet_state_dict
from slice3d_tpu_torch.data.dataset import Slice3DDataset
from slice3d_tpu_torch.mesh.refine import refine_mesh
from slice3d_tpu_torch.models.build import load_model
from slice3d_tpu_torch.config import options_from_args
from slice3d_tpu_torch.pipeline import Reconstructor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_obj(path):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            kind, *vals = line.split()
            (verts if kind == "v" else faces).append([float(v) for v in vals])
    return np.array(verts, np.float32).reshape(-1, 3), np.array(faces, np.int64).reshape(-1, 3)


def test_cli_matches_root_cli(tmp_path, monkeypatch):
    create_synthetic_dataset(str(tmp_path / "data" / "synth"), n_shapes=3, img_size=32, n_sdf=64)
    variables = init_variables(JaxSliceNet(n_slices=12), types.SimpleNamespace(img_size=32),
                               seed=0)
    sd = slicenet_state_dict(variables)
    for exp in ("jax", "port"):
        os.makedirs(tmp_path / "exp" / exp / "ckpt")
        torch.save({"model": sd}, tmp_path / "exp" / exp / "ckpt" / "ref.ckpt")
    common = ["--name_model", "slicenet", "--dir_data", str(tmp_path / "data"),
              "--name_dataset", "synth", "--mode", "test", "--dir_experiments",
              str(tmp_path / "exp"), "--name_ckpt", "ref.ckpt", "--dtype", "float32",
              "--img_size", "32", "--mc_res0", "16", "--mc_up_steps", "1",
              "--mc_chunk_size", "1024", "--mc_batch_size", "2"]
    # the iso level at the median coarse logit of the first object, so each
    # object has a real surface
    opts = options_from_args(common)
    feed = Slice3DDataset(opts.dataset_root, split="test", img_size=32, load_slices=False,
                          load_sdf=False)[0]
    model = load_model(opts, str(tmp_path / "exp" / "port" / "ckpt" / "ref.ckpt"))
    grid, _ = Reconstructor(model, resolution0=16, upsampling_steps=0,
                            device="cpu").build_grid(feed)
    common += ["--mc_threshold", repr(float(1.0 / (1.0 + np.exp(-np.median(grid)))))]

    root_cli = _root_cli()
    monkeypatch.setattr(root_cli, "Reconstructor",
                        functools.partial(JaxReconstructor, transport_dtype="float32"))
    root_cli.main(common + ["--name_exp", "jax"])
    port_cli.main(common + ["--name_exp", "port", "--device", "cpu"])

    names = sorted(os.listdir(tmp_path / "exp" / "jax" / "results" / "synth"))
    assert names == ["00000.obj", "00001.obj", "00002.obj"]
    assert sorted(os.listdir(tmp_path / "exp" / "port" / "results" / "synth")) == names
    for name in names:
        j_verts, j_faces = _read_obj(tmp_path / "exp" / "jax" / "results" / "synth" / name)
        verts, faces = _read_obj(tmp_path / "exp" / "port" / "results" / "synth" / name)
        assert len(faces) > 0
        np.testing.assert_array_equal(faces, j_faces)
        np.testing.assert_allclose(verts, j_verts, atol=1e-4, rtol=0)


def _root_cli():
    sys.path.insert(0, ROOT)
    try:
        import reconstruct as root_cli
    finally:
        sys.path.remove(ROOT)
    return root_cli


def _shared_draws(monkeypatch, steps, rows=1 << 15):
    """The JAX polish's Dirichlet draws replaced by a numpy table, row block
    i for the i-th key ``refine_mesh`` walks; the port's polish takes the
    same table (tests/test_torch_refine.py holds the polish itself)."""
    table = np.random.default_rng(5).dirichlet(np.full(3, 0.5), size=(steps, rows))
    table = table.astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), steps)

    def fake(key, alpha, shape):
        i = jnp.argmax(jnp.all(key[None] == keys, axis=-1))
        return jnp.asarray(table)[i, :int(np.prod(shape))].reshape(tuple(shape) + (3,))

    monkeypatch.setattr(jax.random, "dirichlet", fake)
    monkeypatch.setattr(pipeline, "refine_mesh",
                        functools.partial(refine_mesh, draws=lambda step, n: table[step, :n]))


@pytest.mark.parametrize("name_model,img,n_shapes,options", [
    ("disn", 128, 2, ["--est_campose", "--mc_extract", "tetrahedra", "16"]),
    ("slicenet", 32, 1, ["--mc_refine_steps", "2", "8"])])
def test_cli_options_match_root_cli(tmp_path, monkeypatch, capsys, name_model, img,
                                    n_shapes, options):
    """DISN with CameraNet's pose estimate and marching tetrahedra, at img 128
    (the JAX importer reads CameraNet's and DISN's global Linears over a 4x4
    map only), and SliceNet with the polish, at img 32: both CLIs on one
    synthetic dataset (one batch of 2, padded for the polish's one shape,
    whose JAX trace compiles once an object) with one reference
    checkpoint each for the model and CameraNet.  Equal points evaluated;
    every vertex within 1e-3 of the other mesh's nearest one, both ways, and
    face counts within 0.1%: random DISN weights give a nearly flat field
    whose lattice values crowd the iso level, so fp32 rounding flips a few
    of its 200,000 faces (the polish, for its part, moves a coordinate by up
    to 3.2e-4 a step whatever its gradient's size; test_torch_refine.py)."""
    create_synthetic_dataset(str(tmp_path / "data" / "synth"), n_shapes=n_shapes, img_size=img,
                             n_sdf=64)
    if name_model == "disn":
        jmodel = JaxDISN()
        sd = disn_state_dict(init_variables(jmodel, types.SimpleNamespace(img_size=img), seed=0))
    else:
        jmodel = JaxSliceNet(n_slices=12)
        sd = slicenet_state_dict(init_variables(jmodel, types.SimpleNamespace(img_size=img),
                                                seed=0))
    zeros = np.zeros((1, img, img, 3), np.float32)
    cam_sd = camnet_state_dict(redraw(JaxCameraNet().init(jax.random.PRNGKey(0), zeros), 2))
    for exp, state in (("jax", sd), ("port", sd), ("cam", cam_sd)):
        os.makedirs(tmp_path / "exp" / exp / "ckpt")
        torch.save({"model": state}, tmp_path / "exp" / exp / "ckpt" / "ref.ckpt")
    base = ["--name_model", name_model, "--dir_data", str(tmp_path / "data"),
            "--name_dataset", "synth", "--mode", "test", "--dir_experiments",
            str(tmp_path / "exp"), "--name_ckpt", "ref.ckpt", "--dtype", "float32",
            "--img_size", str(img), "--mc_up_steps", "1", "--mc_res0", options[-1],
            "--mc_chunk_size", "2048", "--mc_batch_size", "2", "--name_exp_cam", "cam",
            "--name_ckpt_cam", "ref.ckpt"]
    common = base + options[:-1]  # the last entry is --mc_res0's value
    opts = options_from_args(common)
    feed = Slice3DDataset(opts.dataset_root, split="test", img_size=img, load_slices=False,
                          load_sdf=False, load_full_projection=True)[0]
    if opts.est_campose:
        feed = port_cli.campose_predictor(opts, "cpu")(feed)
    model = load_model(opts, str(tmp_path / "exp" / "port" / "ckpt" / "ref.ckpt"))
    grid, _ = Reconstructor(model, resolution0=opts.mc_res0, upsampling_steps=0,
                            device="cpu").build_grid(feed)
    # the iso level between the two middle coarse logits: on a lattice value
    # itself, fp32 rounding would decide that point's side
    mid = np.sort(grid.reshape(-1))[grid.size // 2:grid.size // 2 + 2].mean()
    threshold = ["--mc_threshold", repr(float(1.0 / (1.0 + np.exp(-mid))))]
    common += threshold
    if "--mc_refine_steps" in options:
        _shared_draws(monkeypatch, 2)

    root_cli = _root_cli()
    monkeypatch.setattr(root_cli, "Reconstructor",
                        functools.partial(JaxReconstructor, transport_dtype="float32"))
    capsys.readouterr()
    root_cli.main(common + ["--name_exp", "jax"])
    j_points = re.findall(r"over (\d+) pts", capsys.readouterr().out)
    port_cli.main(common + ["--name_exp", "port", "--device", "cpu"])
    points = re.findall(r"over (\d+) pts", capsys.readouterr().out)
    assert len(points) == n_shapes and points == j_points
    names = sorted(os.listdir(tmp_path / "exp" / "jax" / "results" / "synth"))
    assert names == ["00000.obj", "00001.obj"][:n_shapes]
    n_faces = []
    for name in names:
        j_verts, j_faces = _read_obj(tmp_path / "exp" / "jax" / "results" / "synth" / name)
        verts, faces = _read_obj(tmp_path / "exp" / "port" / "results" / "synth" / name)
        assert len(faces) > 0
        assert abs(len(faces) - len(j_faces)) <= 1e-3 * len(j_faces)
        assert cKDTree(j_verts).query(verts)[0].max() <= 1e-3
        assert cKDTree(verts).query(j_verts)[0].max() <= 1e-3
        n_faces.append(len(faces))

    # simplification (held bit-equal to the JAX library's in
    # test_torch_mesh_extra.py): the CLI hands the option through
    port_cli.main(base + threshold + ["--name_exp", "port", "--device", "cpu",
                                      "--overwrite_res", "--simplify_nfaces", "100"])
    for name, n in zip(names, n_faces):
        _, faces = _read_obj(tmp_path / "exp" / "port" / "results" / "synth" / name)
        assert 0 < len(faces) < n / 2


def test_cli_needs_the_card_or_device_cpu(tmp_path):
    create_synthetic_dataset(str(tmp_path / "synth"), n_shapes=1, n_views=6, img_size=32,
                             n_sdf=16)
    argv = ["--dir_data", str(tmp_path), "--name_dataset", "synth", "--random_init",
            "--img_size", "32", "--n_views", "6", "--dir_experiments", str(tmp_path / "exp")]
    with pytest.raises(ValueError, match="shard_axis"):
        port_cli.main(argv + ["--mc_shard_axis", "rows", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_cli.main(argv)
    assert not os.path.exists(tmp_path / "exp")


@pytest.mark.parametrize("slices", ["gt", "gen"])
def test_dataset_matches_jax(tmp_path, slices):
    """The port's reader gives the JAX reader's feeds: images (Pillow's
    decode, compositing and bilinear resize, 32 -> 24 px), cameras and SDF
    samples; "gen" slices are read as RGB without compositing."""
    root = create_synthetic_dataset(str(tmp_path / "synth"), n_shapes=2, n_views=6,
                                    img_size=32, n_sdf=64, seed=3)
    if slices == "gen":
        shutil.copytree(os.path.join(root, "01_img_slices"),
                        os.path.join(root, "04_img_slices_gen"))
    kw = dict(split="test", img_size=24, n_qry=32, n_views=6, from_which_slices=slices)
    port, jax_ds = Slice3DDataset(root, **kw), JaxDataset(root, **kw)
    assert port.files == jax_ds.files and len(port) == 2
    for i in range(2):
        got, want = port[i], jax_ds[i]
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
