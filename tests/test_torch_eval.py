"""The port's evaluation (metrics, ICP, the eval CLI) against the JAX
package's and the root ``eval.py`` on the CPU.

Surface sampling is numpy in both, so a seed gives the same points.  On the
CPU the port's nearest-neighbour search runs the JAX function's fp32
arithmetic (XLA's fused multiply-add chains), so distances and ICP
correspondences agree bit for bit; the means (Chamfer, Hausdorff) are held
to relative 1e-5 and the threshold counts (precision, recall, F-score)
exactly.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from slice3d_tpu.eval import icp as jax_icp
from slice3d_tpu.eval import metrics as jax_metrics
from slice3d_tpu.mesh import export_obj as jax_export_obj
from slice3d_tpu_torch.eval import cli
from slice3d_tpu_torch.eval import icp, metrics
from slice3d_tpu_torch.mesh import Mesh, export_obj, isosurface

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
COUNTS = ("precision", "recall", "fscore")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in COUNTS or k == "n":
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=RTOL, abs=0), k


def blob_mesh(n=28, radius=0.3, bump=0.03, shift=(0.0, 0.0, 0.0)):
    lin = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    g = radius - np.sqrt(x * x + y * y + z * z) + bump * np.sin(9 * x) * np.cos(7 * z)
    m = isosurface(g.astype(np.float32), 0.0)
    verts = (m.vertices / (n - 1) - 0.5 + np.float32(shift)).astype(np.float32)
    return Mesh(verts, m.faces)


def test_sample_mesh_surface_matches_jax():
    m = blob_mesh()
    for seed in (0, 1):
        got = metrics.sample_mesh_surface(m.vertices, m.faces, 5000, seed=seed)
        np.testing.assert_array_equal(
            got, jax_metrics.sample_mesh_surface(m.vertices, m.faces, 5000, seed=seed))
    flat = np.zeros((3, 3), np.float32)
    assert not metrics.sample_mesh_surface(flat, np.array([[0, 1, 2]]), 7).any()


@pytest.mark.parametrize("noise", [0.002, 0.01])
def test_chamfer_metrics_match_jax(noise):
    rng = np.random.default_rng(0)
    a = rng.uniform(-0.5, 0.5, (8000, 3)).astype(np.float32)
    b = (a[:6000] + rng.normal(0, noise, (6000, 3))).astype(np.float32)
    got = metrics.chamfer_metrics(a, b, device="cpu")
    assert_metrics_close(got, jax_metrics.chamfer_metrics(a, b))
    assert 0.0 < got["fscore"] < 1.0
    assert metrics.hausdorff_distance(a, b, device="cpu") == pytest.approx(
        jax_metrics.hausdorff_distance(a, b), rel=RTOL, abs=0)


def test_nearest_matches_jax_and_ignores_the_block_size():
    rng = np.random.default_rng(1)
    a = rng.uniform(-0.5, 0.5, (3000, 3)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (2000, 3)).astype(np.float32)
    d2, idx = metrics.nearest(a, b, device="cpu")
    assert d2.dtype == np.float32 and idx.shape == (3000,)
    exact = np.linalg.norm(a[:, None].astype(np.float64) - b[None], axis=-1)
    # the expanded form's rounding: a few ulps of |a|^2 (~1e-7) in d^2
    assert (idx == exact.argmin(1)).mean() > 0.999
    np.testing.assert_allclose(d2, exact.min(1) ** 2, atol=5e-7, rtol=0)
    np.testing.assert_array_equal(metrics.nn_distances(a, b, device="cpu"),
                                  jax_metrics.nn_distances(a, b))
    small_d2, small_idx = metrics.nearest(a, b, device="cpu", block_elems=2000 * 7)
    np.testing.assert_array_equal(small_d2, d2)
    np.testing.assert_array_equal(small_idx, idx)


def test_occupancy_iou():
    p = np.array([1, 1, 0, 0], bool)
    g = np.array([1, 0, 1, 0], bool)
    assert metrics.occupancy_iou(p, g) == jax_metrics.occupancy_iou(p, g) == 1 / 3
    assert metrics.occupancy_iou(np.zeros(3), np.zeros(3)) == 1.0


def test_icp_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, size=(800, 3))
    ang = 0.15
    r_true = np.array([[np.cos(ang), -np.sin(ang), 0.0], [np.sin(ang), np.cos(ang), 0.0],
                       [0.0, 0.0, 1.0]])
    dst = pts @ r_true.T + np.array([0.04, -0.02, 0.03])
    dst = dst[rng.permutation(len(dst))]
    tm, dists, its = icp.icp(pts, dst, max_iterations=30, device="cpu")
    j_tm, j_dists, j_its = jax_icp.icp(pts, dst, max_iterations=30)
    assert its == j_its
    np.testing.assert_allclose(tm, j_tm, rtol=RTOL, atol=1e-12)
    np.testing.assert_array_equal(dists, j_dists)
    np.testing.assert_allclose(tm[:3, :3], r_true, atol=1e-4)
    tm2, r, t = icp.best_fit_transform(pts, pts @ r_true.T)
    np.testing.assert_allclose(r, r_true, atol=1e-10)


@pytest.fixture(scope="module")
def root_eval():
    sys.path.insert(0, ROOT)
    try:
        return importlib.import_module("eval")
    finally:
        sys.path.remove(ROOT)


def _eval_tree(tmp_path):
    """A dataset of two shapes: GT meshes, 02_sdfs samples of a sphere (a
    surface band and volume points), and result meshes a little off."""
    root = tmp_path / "data" / "tiny"
    (root / "03_splits").mkdir(parents=True)
    (root / "02_sdfs").mkdir()
    (root / "03_splits" / "test.lst").write_text("00000\n00001\n00002\n")
    gt_dir, res_dir = tmp_path / "gt", tmp_path / "exp" / "e" / "results" / "tiny"
    gt_dir.mkdir()
    res_dir.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i, sid in enumerate(("00000", "00001")):
        gt = blob_mesh(radius=0.3 + 0.02 * i, bump=0.0)
        jax_export_obj(gt, str(gt_dir / f"{sid}.obj"))
        export_obj(blob_mesh(radius=0.3 + 0.02 * i, shift=(0.01, -0.02, 0.015 * i)),
                   str(res_dir / f"{sid}.obj"))
        d = rng.normal(size=(3000, 3))
        surf = 0.3 * d / np.linalg.norm(d, axis=1, keepdims=True) + rng.normal(0, 0.002,
                                                                              (3000, 3))
        vol = rng.uniform(-0.5, 0.5, (3000, 3))
        pts = np.concatenate([surf, vol])
        sdf = np.linalg.norm(pts, axis=1) - (0.3 + 0.02 * i)
        np.save(root / "02_sdfs" / f"{sid}.npy",
                np.concatenate([pts, sdf[:, None]], 1).astype(np.float32))
    # 00002 has no result mesh: both CLIs skip it
    return ["--name_exp", "e", "--name_dataset", "tiny", "--dir_data", str(tmp_path / "data"),
            "--dir_experiments", str(tmp_path / "exp"), "--n_pts", "6000"], gt_dir


@pytest.mark.parametrize("mode", ["gt_meshes", "sdfs"])
def test_eval_cli_matches_root(tmp_path, root_eval, mode):
    common, gt_dir = _eval_tree(tmp_path)
    if mode == "gt_meshes":
        common += ["--dir_gt_meshes", str(gt_dir)]
    for extra in ([], ["--icp_align"]):
        out = tmp_path / f"port{len(extra)}.json"
        got = cli.main(common + extra + ["--device", "cpu", "--out", str(out)])
        want = root_eval.main(common + extra)
        assert got["n"] == 2
        assert ("hausdorff" in got) == (mode == "gt_meshes")
        assert_metrics_close(got, want)
        assert out.exists()


def test_load_obj_matches_root(tmp_path, root_eval):
    m = blob_mesh(12)
    export_obj(m, str(tmp_path / "m.obj"))
    got, want = cli.load_obj(str(tmp_path / "m.obj")), root_eval.load_obj(str(tmp_path / "m.obj"))
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
