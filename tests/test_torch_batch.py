"""Batched reconstruction in the port against the JAX package (CPU, fp32).

The plane-set selectors (``obj_index``) of the three samplers are held
against their JAX twins at atol 1e-5.  The port's batched ``Reconstructor``
(B = 2) is held against the JAX batched ``Reconstructor`` (its sequential
per-object chunk walk, values shipped in fp32) on the same JAX seed-0
weights, carried across by ``slice3d_tpu_torch.convert``, at img 32, res0 16,
up 1: the grids within 2e-3, the same points evaluated, the same faces, on
both coarse-level routes.  ``reconstruct_all`` keeps the order, pads the tail
batch, and matches ``reconstruct`` one object at a time.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.sdf_head import sample_packed_sum as jax_sample_packed_sum
from slice3d_tpu.models.slicenet import SliceNetModel as JaxSliceNet
from slice3d_tpu.ops.hat_sample import hat_sample_sum as jax_hat_sample_sum
from slice3d_tpu.ops.lattice_sample import lattice_sample_sum as jax_lattice_sample_sum
from slice3d_tpu.pipeline import Reconstructor as JaxReconstructor
from slice3d_tpu_torch import camera
from slice3d_tpu_torch.convert import slicenet_state_dict
from slice3d_tpu_torch.mesh.extract import extract_mesh_from_grid
from slice3d_tpu_torch.models.sdf_head import sample_packed_sum
from slice3d_tpu_torch.models.slicenet import SliceNetModel, init_slicenet
from slice3d_tpu_torch.ops.hat_sample import hat_sample_sum
from slice3d_tpu_torch.ops.lattice_sample import lattice_sample_sum
from slice3d_tpu_torch.pipeline import Reconstructor
from test_torch_pipeline import randomized_bn

N_SLICES, IMG, RES0, UP, B = 12, 32, 16, 1, 2
LEVELS = ((3, 4, 5), (3, 9, 7), (3, 33, 40))  # (B, h, w) of the packed planes


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(seed, n_slices=2, d=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, w, n_slices * d)).astype(np.float32) for b, h, w in LEVELS]


def test_lattice_sample_scalar_obj_index_matches_jax():
    planes = _planes(1)
    rng = np.random.default_rng(2)
    u = rng.uniform(-1.1, 1.1, (3, 6)).astype(np.float32)  # a few nodes out of range
    v = rng.uniform(-1.1, 1.1, (3, 5)).astype(np.float32)
    for obj in range(LEVELS[0][0]):
        want = jax_lattice_sample_sum([jnp.asarray(p) for p in planes], jnp.asarray(u),
                                      jnp.asarray(v), 2, obj_index=jnp.int32(obj))
        got = lattice_sample_sum([torch.from_numpy(p) for p in planes], torch.from_numpy(u),
                                 torch.from_numpy(v), 2, obj_index=obj)
        assert tuple(got.shape) == (3, 5, 6, 2, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        lattice_sample_sum([torch.from_numpy(p) for p in planes], torch.from_numpy(u),
                           torch.from_numpy(v), 2, obj_index=3)


# hat_max_rows: every level gathered, the small ones through the hat matmul,
# every level through the hat matmul
@pytest.mark.parametrize("hat_max_rows", [0, 64, 10 ** 6], ids=["gather", "mixed", "hat"])
def test_sample_packed_sum_obj_index_matches_jax(hat_max_rows):
    planes = _planes(3)
    rng = np.random.default_rng(4)
    uv = rng.uniform(-1.05, 1.05, (4, 50, 2)).astype(np.float32)
    obj_index = np.array([2, 0, 1, 2])
    want = jax_sample_packed_sum([jnp.asarray(p) for p in planes], jnp.asarray(uv), 2,
                                 obj_index=jnp.asarray(obj_index, jnp.int32),
                                 hat_max_rows=hat_max_rows)
    got = sample_packed_sum([torch.from_numpy(p) for p in planes], torch.from_numpy(uv), 2,
                            obj_index=torch.from_numpy(obj_index), hat_max_rows=hat_max_rows)
    assert tuple(got.shape) == (4, 50, 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the hat levels alone, through hat_sample_sum
    want_hat, _ = jax_hat_sample_sum([jnp.asarray(p) for p in planes], jnp.asarray(uv),
                                     obj_index=jnp.asarray(obj_index, jnp.int32), max_rows=20)
    got_hat, rest = hat_sample_sum([torch.from_numpy(p) for p in planes], torch.from_numpy(uv),
                                   obj_index=torch.from_numpy(obj_index), max_rows=20)
    assert [tuple(p.shape) for p in rest] == [(3, 9, 7, 8), (3, 33, 40, 8)]
    np.testing.assert_allclose(got_hat.numpy(), np.asarray(want_hat), atol=1e-5, rtol=0)


def _feeds(n, seed, size=IMG):
    rng = np.random.default_rng(seed)
    _, proj = camera.camera_matrices(0.0, 0.0, 1.2)
    return [{"img_input": rng.uniform(-1, 1, (size, size, 3)).astype(np.float32),
             "trans_mat_wo_rot_tp": proj.astype(np.float32)} for _ in range(n)]


def _threshold(model, feed, res0):
    """Iso level at the median coarse logit, so a real surface is extracted."""
    grid, _ = Reconstructor(model, resolution0=res0, upsampling_steps=0,
                            device="cpu").build_grid(feed)
    return float(1.0 / (1.0 + np.exp(-np.median(grid))))


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxSliceNet(n_slices=N_SLICES)
    variables = randomized_bn(
        init_variables(jmodel, types.SimpleNamespace(img_size=IMG), seed=0), seed=1)
    model = SliceNetModel(N_SLICES)
    model.load_state_dict(slicenet_state_dict(variables))
    feeds = _feeds(B, 5)
    kw = dict(resolution0=RES0, upsampling_steps=UP, threshold=_threshold(model, feeds[0], RES0),
              chunk_size=1024, batch_size=B)
    jrec = JaxReconstructor(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                            transport_dtype="float32", **kw)
    return jrec, model.eval(), feeds, kw


@pytest.mark.parametrize("lattice", [True, False], ids=["lattice", "gather"])
def test_batched_reconstructor_matches_jax(setup, monkeypatch, lattice):
    jrec, model, feeds, kw = setup
    monkeypatch.setenv("SLICE3D_LATTICE_DENSE", "1" if lattice else "0")
    j_grids, _, j_stats = jrec._build_grids(feeds)

    rec = Reconstructor(model, lattice_dense=lattice, device="cpu", **kw)
    grids, stats = rec.build_grids(feeds)
    for i in range(B):
        np.testing.assert_allclose(grids[i], np.asarray(j_grids[i]), atol=2e-3, rtol=0)
        assert stats[i]["n_points_evaluated"] == j_stats[i]["n_points_evaluated"]
        assert stats[i]["n_points_evaluated"] > (RES0 + 1) ** 3  # refinement ran
        assert stats[i]["final_resolution"] == RES0 * 2 ** UP
        j_mesh = jrec._march_one(j_grids[i], {})
        mesh = rec._march(grids[i], stats[i])
        assert not mesh.is_empty
        np.testing.assert_array_equal(mesh.faces, j_mesh.faces)
        np.testing.assert_allclose(mesh.vertices, j_mesh.vertices, atol=1e-4, rtol=0)
    assert not np.array_equal(grids[0], grids[1])  # two objects, two fields


def test_reconstruct_all_in_order_with_a_padded_tail():
    model = init_slicenet(0)
    feeds = _feeds(3, 6)
    kw = dict(resolution0=8, upsampling_steps=1, threshold=_threshold(model, feeds[0], 8),
              chunk_size=512, device="cpu")
    batched = Reconstructor(model, batch_size=2, **kw)
    built = []  # (group size, grids) of every batch reconstruct_all evaluates
    build = batched._build

    def recorded(group):
        grids, stats, cond = build(group)
        built.append((len(group), grids))
        return grids, stats, cond

    batched._build = recorded
    results = []
    batched.reconstruct_all(iter(feeds), lambda j, mesh, st: results.append((j, mesh, st)))
    assert [j for j, _, _ in results] == [0, 1, 2]
    assert [n for n, _ in built] == [2, 2]  # the tail batch padded to 2
    grids = built[0][1] + built[1][1][:1]
    single = Reconstructor(model, **kw)
    for (j, mesh, st), grid in zip(results, grids):
        want = extract_mesh_from_grid(grid, single.generator.logit_threshold)
        np.testing.assert_array_equal(mesh.faces, want.faces)
        np.testing.assert_array_equal(mesh.vertices, want.vertices)
        # one object at a time: the same field (batched convolutions sum in
        # another order), the same points
        s_grid, s_stats = single.build_grid(feeds[j])
        np.testing.assert_allclose(grid, s_grid, atol=1e-5, rtol=0)
        assert st["n_points_evaluated"] == s_stats["n_points_evaluated"]
    with pytest.raises(ValueError):
        batched.build_grids(feeds)  # more feeds than the batch holds
    with pytest.raises(ValueError):
        Reconstructor(model, batch_size=0, device="cpu")


def test_encode_folded_takes_a_batch():
    model = init_slicenet(0)
    imgs = torch.from_numpy(np.stack([f["img_input"] for f in _feeds(2, 7)]))
    with torch.no_grad():
        packed, slices = model.encode_folded(imgs)
        for i in range(2):
            one, one_slices = model.encode_folded(imgs[i:i + 1])
            torch.testing.assert_close(slices[i * N_SLICES:(i + 1) * N_SLICES], one_slices,
                                       atol=1e-5, rtol=0)
            for p, q in zip(packed, one):
                assert p.shape[0] == 2
                torch.testing.assert_close(p[i:i + 1], q, atol=1e-4, rtol=0)
