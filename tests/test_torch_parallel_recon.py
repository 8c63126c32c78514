"""The port's sharded Reconstructor on the CPU: a mesh of two CPU replicas
(``create_mesh((2, 1), devices=["cpu", "cpu"])``) against the JAX
Reconstructor on two of the 8 virtual CPU devices of ``tests/conftest.py``,
and against the port's unsharded run.

One weight set (JAX seed-0 init with redrawn BatchNorm statistics, carried
across by ``slice3d_tpu_torch.convert``) drives SliceNet (here) and GTSlice
(``tests/test_torch_parallel_recon_gtslice.py``) at img 32, res0 16, up 1,
chunk 4096, with the object batch (``batch``, two objects) or the head calls
(``points``, one object) split over the mesh.  Against
JAX: the grids at atol 2e-3 (``tests/test_torch_pipeline.py``'s tolerance),
the same points evaluated, the same faces, the vertices at 1e-4.  Against
the port unsharded: the grids at 1e-5 and the same points.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jax_weights import redraw
from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.gtslice import GTSliceModel as JaxGTSlice
from slice3d_tpu.models.slicenet import SliceNetModel as JaxSliceNet
from slice3d_tpu.parallel import create_mesh as jax_create_mesh
from slice3d_tpu.pipeline import Reconstructor as JaxReconstructor
from slice3d_tpu_torch import camera
from slice3d_tpu_torch.convert import gtslice_state_dict, slicenet_state_dict
from slice3d_tpu_torch.models.gtslice import GTSliceModel
from slice3d_tpu_torch.models.slicenet import SliceNetModel
from slice3d_tpu_torch.parallel import create_mesh
from slice3d_tpu_torch.pipeline import Reconstructor

N_SLICES, IMG, RES0, UP = 12, 32, 16, 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feeds(name, n, seed):
    rng = np.random.default_rng(seed)
    _, proj = camera.camera_matrices(0.0, 0.0, 1.2)
    shape = (N_SLICES, IMG, IMG, 3) if name == "gtslice" else (IMG, IMG, 3)
    key = "img_slices" if name == "gtslice" else "img_input"
    return [{key: rng.uniform(-1, 1, shape).astype(np.float32),
             "trans_mat_wo_rot_tp": proj.astype(np.float32)} for _ in range(n)]


def sharded_setup(name):
    """(the JAX model, its variables, the port model with the same weights,
    two feeds, the operating point) of ``name``."""
    jmodel, model, to_port = ((JaxSliceNet(n_slices=N_SLICES), SliceNetModel(N_SLICES),
                               slicenet_state_dict) if name == "slicenet" else
                              (JaxGTSlice(n_slices=N_SLICES), GTSliceModel(N_SLICES),
                               gtslice_state_dict))
    opts = types.SimpleNamespace(img_size=IMG, n_slices=N_SLICES)
    variables = redraw(init_variables(jmodel, opts, seed=0), seed=21)
    model.load_state_dict(to_port(variables))
    feeds = _feeds(name, 2, 22)
    grid, _ = Reconstructor(model.eval(), resolution0=RES0, upsampling_steps=0,
                            device="cpu").build_grid(feeds[0])
    # iso level between the two middle coarse logits, so a real surface is
    # extracted and no lattice value sits on it (the median itself would
    # leave its side to fp32 noise, tests/test_torch_gtslice.py)
    mid = np.sort(grid.ravel())[grid.size // 2 - 1:grid.size // 2 + 1].mean()
    threshold = float(1.0 / (1.0 + np.exp(-mid)))
    return (jmodel, jax.tree_util.tree_map(jnp.asarray, variables), model, feeds,
            dict(resolution0=RES0, upsampling_steps=UP, threshold=threshold, chunk_size=4096))


def check_sharded(setup, shard_axis):
    """The port's sharded run against JAX's sharded one and the port's
    unsharded one."""
    jmodel, variables, model, feeds, kw = setup
    if shard_axis == "points":
        feeds = feeds[:1]
    kw = dict(kw, batch_size=len(feeds))
    jrec = JaxReconstructor(jmodel, variables, transport_dtype="float32",
                            mesh=jax_create_mesh((2, 1), devices=jax.devices()[:2]),
                            shard_axis=shard_axis, **kw)
    j_grids, _, j_stats = jrec._build_grids(feeds)
    rec = Reconstructor(model, device="cpu", mesh=create_mesh((2, 1), devices=["cpu", "cpu"]),
                        shard_axis=shard_axis, **kw)
    assert len({id(m) for m, _ in rec._replicas}) == 1  # repeats share the replica
    grids, stats, _ = rec._build(feeds)
    single_grids, single_stats = Reconstructor(model, device="cpu", **kw).build_grids(feeds)
    for i, st in enumerate(stats):
        np.testing.assert_allclose(grids[i], np.asarray(j_grids[i]), atol=2e-3, rtol=0)
        assert st["n_points_evaluated"] == j_stats[i]["n_points_evaluated"]
        assert st["n_points_evaluated"] == single_stats[i]["n_points_evaluated"]
        assert st["n_points_evaluated"] > (RES0 + 1) ** 3  # refinement ran
        np.testing.assert_allclose(grids[i], single_grids[i], atol=1e-5, rtol=0)
        j_mesh = jrec._march_one(np.asarray(j_grids[i]), {})
        mesh = rec._march(grids[i], st)
        assert not mesh.is_empty
        np.testing.assert_array_equal(mesh.faces, j_mesh.faces)
        np.testing.assert_allclose(mesh.vertices, j_mesh.vertices, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def slicenet():
    return sharded_setup("slicenet")


@pytest.mark.parametrize("shard_axis", ["batch", "points"])
def test_sharded_slicenet(slicenet, shard_axis):
    check_sharded(slicenet, shard_axis)


@pytest.mark.parametrize("shard_axis,kw,match", [
    ("batch", dict(batch_size=3), "batch_size 3 not divisible by data axis size 2"),
    ("points", dict(chunk_size=4097), "chunk_size 4097 not divisible by data axis size 2"),
    ("rows", {}, "unknown shard_axis 'rows'")])
def test_sharding_errors(shard_axis, kw, match):
    mesh = create_mesh((2, 1), devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match=match):
        Reconstructor(SliceNetModel(N_SLICES), device="cpu", mesh=mesh, shard_axis=shard_axis,
                      **kw)
