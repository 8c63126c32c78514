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

import os
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


class _Float64Reconstructor(Reconstructor):
    """The port's Reconstructor on a float64 model: the images, the lattice
    points and every layer in float64.  The projection, the hat weights and
    the head's last cast stay fp32, as the precision policy fixes them."""

    def _stack_inputs(self, feeds, device=None):
        imgs, extras = super()._stack_inputs(feeds, device)
        return imgs.double(), tuple(e.astype(np.float64) for e in extras)

    def _index_logits(self, enc, d, obj, idx, res):
        n = res + 1
        ix = torch.from_numpy(np.asarray(idx, np.int64))
        pts = torch.stack([ix // (n * n), (ix // n) % n, ix % n], -1).double()
        return self._logits(enc.conds[d], obj, (pts / res - 0.5) * self.box_size, d=d)


@pytest.fixture(scope="module")
def coarse_grids(models, recon):
    """The coarse level (res0 16, no refinement) of the float64 port and of
    JAX's fp32 Reconstructor on both routes, and the iso level."""
    jmodel, variables, model, *_ = models
    _, _, feed, kw = recon
    kw0 = dict(kw, upsampling_steps=0)
    m64 = GTSliceModel(N_SLICES).eval()
    m64.load_state_dict(model.state_dict())
    rec64 = _Float64Reconstructor(m64.double(), lattice_dense=False, device="cpu", **kw0)
    rec64._replicas = [(rec64.model, rec64._flip.double())]
    g64, _ = rec64.build_grid(feed)
    jrec = JaxReconstructor(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                            transport_dtype="float32", **kw0)
    j_grids = {}
    for lattice in (True, False):
        os.environ["SLICE3D_LATTICE_DENSE"] = "1" if lattice else "0"
        j_grids[lattice] = np.asarray(jrec._build_grid(feed)[0])
    os.environ.pop("SLICE3D_LATTICE_DENSE")
    return g64, j_grids, rec64.generator.logit_threshold, kw0


@pytest.mark.parametrize("threads", [1, 0], ids=["one_thread", "default_threads"])
@pytest.mark.parametrize("lattice", [True, False], ids=["lattice", "gather"])
def test_iso_level_ties_against_float64(models, recon, coarse_grids, lattice, threads):
    """Why ``test_reconstruct_matches_jax`` fails with torch in one thread
    (ROADMAP Queue 3): its refined grid then departs from JAX's by 2.16e-3
    because the two refine different points, and they do because one coarse
    value lies on the iso level: the fixture's level is the median coarse
    logit, one lattice value (at (1, 14, 16); 1.4e-8 below it in float64,
    less than one fp32 ulp), so fp32 noise of either package picks its side
    (readings, printed: the port +4.5e-8 in one thread, -8.9e-8 and -1.5e-7
    in the default threads, JAX -1.6e-7).  Both fp32 coarse grids hold to
    the float64 one at 1e-6, and every coarse point that either package
    puts on the other side of the iso level than float64 lies within that
    1e-6 of it: a tie, not a fault of either.

    The port's grid is no farther from float64 than JAX's on the same route:
    its RMS error at most 0.9 of JAX's (readings: the port 1.41e-7 to
    1.45e-7, JAX 1.69e-7 on the gather route and 1.71e-7 on the lattice
    route; ratios 0.83 to 0.85), and its largest error at most 1.1 of
    JAX's (readings: the port 6.41e-7 / 6.56e-7 on the lattice route, 5.4e-7
    / 4.92e-7 on the gather route, default / one thread; JAX 6.33e-7 and
    6.85e-7; ratios 0.72 to 1.04: the one point the port is farther at
    lies 0.23e-7 beyond JAX's).  The float64 grid keeps the port's fp32
    projection and hat weights, as the precision policy fixes them, so there
    it shares the port's rounding."""
    rms_ratio, max_ratio = 0.9, 1.1
    _, _, model, *_ = models
    g64, j_grids, thr, kw0 = coarse_grids
    n = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        grid, _ = Reconstructor(model, lattice_dense=lattice, device="cpu",
                                **kw0).build_grid(recon[2])
    finally:
        torch.set_num_threads(n)
    g64 = g64.astype(np.float64)
    median = np.unravel_index(np.argsort(g64.ravel())[g64.size // 2], g64.shape)
    errors = {}
    for name, g in (("port", grid), ("jax", j_grids[lattice])):
        flipped = (g > thr) != (g64 > thr)
        e = np.abs(g - g64)
        errors[name] = (float(np.sqrt(np.mean(e * e))), float(e.max()))
        print(f"{name}: |fp32 - float64| rms {errors[name][0]:.3g}, max {errors[name][1]:.3g}; "
              f"at the median point {median}: fp32 - level {g[median] - thr:.3g}, float64 - "
              f"level {g64[median] - thr:.3g}; other side than float64 at "
              f"{[tuple(int(i) for i in p) for p in np.argwhere(flipped)]}")
        np.testing.assert_allclose(g, g64, atol=1e-6, rtol=0)
        assert np.all(np.abs(g64[flipped] - thr) < 1e-6)
    assert errors["port"][0] <= rms_ratio * errors["jax"][0], errors
    assert errors["port"][1] <= max_ratio * errors["jax"][1], errors
