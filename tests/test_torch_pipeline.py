"""The port's Reconstructor against the JAX Reconstructor (CPU, fp32).

One weight set (JAX seed-0 init with randomized BatchNorm statistics,
carried across by ``slice3d_tpu_torch.convert``) drives both pipelines on
the same image at img 32, res0 16, up 1.  The refined logit grids must agree
on both coarse-level routes (separable lattice slabs and per-point gather),
the same points must be evaluated, and surface nets must give the same mesh.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from slice3d_tpu import camera as jax_camera
from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.slicenet import SliceNetModel as JaxSliceNet
from slice3d_tpu.pipeline import Reconstructor as JaxReconstructor
from slice3d_tpu_torch import camera
from slice3d_tpu_torch.convert import slicenet_state_dict
from slice3d_tpu_torch.models.slicenet import SliceNetModel
from slice3d_tpu_torch.pipeline import Reconstructor

N_SLICES, IMG, RES0, UP = 12, 32, 16, 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomized_bn(variables, seed):
    """Non-trivial BatchNorm statistics, so a mean/var mix-up shows."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), variables["batch_stats"])

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict) and "mean" in v:
                v["mean"] = rng.normal(0, 0.1, v["mean"].shape).astype(np.float32)
                v["var"] = rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)
            elif isinstance(v, dict):
                fill(v)

    fill(stats)
    return {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": stats}


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxSliceNet(n_slices=N_SLICES)
    variables = randomized_bn(
        init_variables(jmodel, types.SimpleNamespace(img_size=IMG), seed=0), seed=1)
    model = SliceNetModel(N_SLICES)
    model.load_state_dict(slicenet_state_dict(variables))
    rng = np.random.default_rng(3)
    _, proj = camera.camera_matrices(0.0, 0.0, 1.2)
    feed = {"img_input": rng.uniform(-1, 1, (IMG, IMG, 3)).astype(np.float32),
            "trans_mat_wo_rot_tp": proj.astype(np.float32)}
    # iso level at the median coarse logit, so a real surface is extracted
    probe = Reconstructor(model.eval(), resolution0=RES0, upsampling_steps=0,
                          device="cpu")
    grid, _ = probe.build_grid(feed)
    threshold = float(1.0 / (1.0 + np.exp(-np.median(grid))))
    kw = dict(resolution0=RES0, upsampling_steps=UP, threshold=threshold,
              chunk_size=1024)
    jrec = JaxReconstructor(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                            transport_dtype="float32", **kw)
    return jrec, model, feed, kw


def test_port_camera_matches_jax():
    for args in ((0.0, 0.0, 1.2), (0.7, -0.3, 1.8)):
        for a, b in zip(camera.camera_matrices(*args), jax_camera.camera_matrices(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lattice", [True, False], ids=["lattice", "gather"])
def test_reconstruct_matches_jax(setup, monkeypatch, lattice):
    jrec, model, feed, kw = setup
    monkeypatch.setenv("SLICE3D_LATTICE_DENSE", "1" if lattice else "0")
    j_grid, _, j_stats = jrec._build_grid(feed)
    j_mesh = jrec._march_one(j_grid, {})

    rec = Reconstructor(model, lattice_dense=lattice, device="cpu", **kw)
    grid, stats = rec.build_grid(feed)
    mesh, _ = rec.reconstruct(feed)

    np.testing.assert_allclose(grid, np.asarray(j_grid), atol=2e-3, rtol=0)
    assert stats["n_points_evaluated"] == j_stats["n_points_evaluated"]
    assert stats["n_points_evaluated"] > (RES0 + 1) ** 3  # refinement ran
    assert stats["final_resolution"] == RES0 * 2 ** UP
    assert not mesh.is_empty
    assert mesh.vertices.shape == j_mesh.vertices.shape
    assert mesh.faces.shape == j_mesh.faces.shape
    np.testing.assert_array_equal(mesh.faces, j_mesh.faces)
    np.testing.assert_allclose(mesh.vertices, j_mesh.vertices, atol=1e-4, rtol=0)


def test_reconstructor_validates_arguments(setup):
    _, model, _, _ = setup
    for bad in (dict(slab_points=0), dict(slab_points=2.5), dict(chunk_size=-1),
                dict(threshold=1.0)):
        with pytest.raises(ValueError):
            Reconstructor(model, device="cpu", **bad)
