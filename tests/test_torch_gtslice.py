"""The port's GTSlice and its Reconstructor route against the JAX package
(CPU, fp32).

Every weight and BatchNorm statistic is redrawn from a seed
(tests/jax_weights.py) and carried into the port by
``slice3d_tpu_torch.convert.gtslice_state_dict``; 12 slices of 32 px.  The
folded paths agree at atol 5e-4 / rtol 1e-3 (tests/test_model_parity.py's
tolerance); the Reconstructor grids at atol 2e-3 with identical point counts
and meshes, on both coarse-level routes, as tests/test_torch_pipeline.py
holds SliceNet's.
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
from slice3d_tpu.pipeline import Reconstructor as JaxReconstructor
from slice3d_tpu_torch import camera
from slice3d_tpu_torch.convert import gtslice_state_dict
from slice3d_tpu_torch.models.gtslice import GTSliceModel, init_gtslice
from slice3d_tpu_torch.pipeline import Reconstructor

N_SLICES, IMG, M, RES0, UP = 12, 32, 97, 16, 1
TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxGTSlice(n_slices=N_SLICES)
    opts = types.SimpleNamespace(img_size=IMG, n_slices=N_SLICES)
    variables = redraw(init_variables(jmodel, opts, seed=0), seed=11)
    model = GTSliceModel(N_SLICES).eval()
    model.load_state_dict(gtslice_state_dict(variables))
    rng = np.random.default_rng(12)
    slices = rng.uniform(-1, 1, (1, N_SLICES, IMG, IMG, 3)).astype(np.float32)
    rot, proj = camera.camera_matrices(0.5, 0.1, 1.2)
    qry = (rng.uniform(-0.5, 0.5, (1, M, 3)) @ rot).astype(np.float32)
    inputs = dict(slices=slices, qry=qry, trans=proj[None].astype(np.float32))
    j_packed = jmodel.apply(variables, jnp.asarray(slices), method=JaxGTSlice.encode_folded)
    with torch.no_grad():
        packed = model.encode_folded(torch.from_numpy(slices))
    return jmodel, variables, model, inputs, j_packed, packed


def test_encode_folded_matches_jax(models):
    *_, j_packed, packed = models
    assert [tuple(p.shape) for p in packed] == [p.shape for p in j_packed]
    assert [p.shape[1] for p in packed] == [32, 16, 8, 4, 2]  # VGG taps of 32 px
    assert packed[0].shape[-1] == N_SLICES * 128
    for a, b in zip(packed, j_packed):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_query_folded_matches_jax(models):
    jmodel, variables, model, inp, j_packed, packed = models
    want = jmodel.apply(variables, j_packed, jnp.asarray(inp["qry"]),
                        jnp.asarray(inp["trans"]), method=JaxGTSlice.query_folded)
    with torch.no_grad():
        got = model.query_folded(packed, torch.from_numpy(inp["qry"]),
                                 torch.from_numpy(inp["trans"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_query_presampled_matches_jax(models):
    jmodel, variables, model, inp, _, _ = models
    sampled = np.random.default_rng(13).normal(size=(1, M, N_SLICES, 128)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(inp["qry"]), jnp.asarray(sampled),
                        method=JaxGTSlice.query_presampled)
    with torch.no_grad():
        got = model.query_presampled(torch.from_numpy(inp["qry"]), torch.from_numpy(sampled))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def recon(models):
    jmodel, variables, model, inp, _, _ = models
    _, proj = camera.camera_matrices(0.0, 0.0, 1.2)
    feed = {"img_slices": inp["slices"][0], "trans_mat_wo_rot_tp": proj.astype(np.float32)}
    # iso level at the median coarse logit, so a real surface is extracted
    grid, _ = Reconstructor(model, resolution0=RES0, upsampling_steps=0,
                            device="cpu").build_grid(feed)
    threshold = float(1.0 / (1.0 + np.exp(-np.median(grid))))
    kw = dict(resolution0=RES0, upsampling_steps=UP, threshold=threshold, chunk_size=1024)
    jrec = JaxReconstructor(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                            transport_dtype="float32", **kw)
    return jrec, model, feed, kw


@pytest.mark.parametrize("lattice", [True, False], ids=["lattice", "gather"])
def test_reconstruct_matches_jax(recon, monkeypatch, lattice):
    jrec, model, feed, kw = recon
    monkeypatch.setenv("SLICE3D_LATTICE_DENSE", "1" if lattice else "0")
    j_grid, _, j_stats = jrec._build_grid(feed)
    j_mesh = jrec._march_one(j_grid, {})

    rec = Reconstructor(model, lattice_dense=lattice, device="cpu", **kw)
    mesh, stats = rec.reconstruct(feed)
    grid, _ = rec.build_grid(feed)

    np.testing.assert_allclose(grid, np.asarray(j_grid), atol=2e-3, rtol=0)
    assert stats["n_points_evaluated"] == j_stats["n_points_evaluated"]
    assert stats["n_points_evaluated"] > (RES0 + 1) ** 3  # refinement ran
    assert not mesh.is_empty
    np.testing.assert_array_equal(mesh.faces, j_mesh.faces)
    np.testing.assert_allclose(mesh.vertices, j_mesh.vertices, atol=1e-4, rtol=0)


def test_init_gtslice_draws_every_weight():
    a, b, c = init_gtslice(0), init_gtslice(0), init_gtslice(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k
        if v.is_floating_point() and v.numel() > 1:
            assert not torch.equal(v, sc[k]), k  # drawn, not left at its init
    assert not a.training
