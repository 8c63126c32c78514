"""The port's mesh polish (``mesh/refine.py``) against the JAX package's on
the CPU, with the same Dirichlet draws on both sides: the JAX side's
``jax.random.dirichlet`` is patched in this process to hand back numpy draws
chosen by the step's key, the port takes the same draws through ``draws=``.
One step must agree to 1e-4 and five to 1e-3 (fp32; the JAX loss sums every
chunk before dividing, the port divides each chunk's share).  The polish in
``Reconstructor`` (SliceNet, through the head's plain route) is held against
the JAX ``Reconstructor``'s the same way."""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import slice3d_tpu.mesh.refine as jax_refine
from slice3d_tpu.mesh import isosurface as jax_isosurface
from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.slicenet import SliceNetModel as JaxSliceNet
from slice3d_tpu.pipeline import Reconstructor as JaxReconstructor
from slice3d_tpu_torch import camera, pipeline
from slice3d_tpu_torch.convert import slicenet_state_dict
from slice3d_tpu_torch.mesh.refine import refine_mesh
from slice3d_tpu_torch.models.slicenet import SliceNetModel
from slice3d_tpu_torch.pipeline import Reconstructor

R = 0.3
ROWS = 1 << 14  # draws a step: more than any padded face count here


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shared_draws(monkeypatch, steps, seed=0, table_seed=5):
    """Patch ``jax.random.dirichlet`` to return row block ``i`` of a numpy
    table for the i-th key of ``split(PRNGKey(seed), steps)`` (the keys
    ``refine_mesh`` walks); returns the port's ``draws`` for the same
    table."""
    table = np.random.default_rng(table_seed).dirichlet(
        np.full(3, 0.5), size=(steps, ROWS)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), steps)

    def fake(key, alpha, shape):
        i = jnp.argmax(jnp.all(key[None] == keys, axis=-1))
        n = int(np.prod(shape))
        return jnp.asarray(table)[i, :n].reshape(tuple(shape) + (3,))

    monkeypatch.setattr(jax.random, "dirichlet", fake)
    return lambda step, n: table[step, :n]


def sphere(res=12):
    g = np.linspace(-0.5, 0.5, res + 1).astype(np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    m = jax_isosurface((R - np.sqrt(x * x + y * y + z * z)).astype(np.float32), 0.0)
    return (m.vertices / res - 0.5).astype(np.float32), m.faces


def jax_logit():
    """A fresh function each call: ``_refine_step`` is jitted with the logit
    function static, so a new one keeps a test from reusing another's trace
    (and its patched draws)."""
    return lambda p: (R - jnp.linalg.norm(p, axis=-1)) * 20.0


def torch_logit(p):
    return (R - torch.linalg.vector_norm(p, dim=-1)) * 20.0


@pytest.mark.parametrize("steps,atol", [(1, 1e-4), (5, 1e-3)])
def test_refine_matches_jax(monkeypatch, steps, atol):
    verts, faces = sphere()
    draws = shared_draws(monkeypatch, steps)
    kw = dict(steps=steps, lr=1e-3, threshold=0.5, face_chunk=128)
    want, w_losses = jax_refine.refine_mesh(verts, faces, jax_logit(), **kw)
    got, losses = refine_mesh(verts, faces, torch_logit, draws=draws, device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == verts.shape
    assert np.abs(got - verts).max() > 2 * atol  # the vertices moved
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(losses, w_losses, rtol=1e-4, atol=0)


def test_refine_sphere_improves():
    verts, faces = sphere(16)

    def radial_err(v):
        return float(np.mean(np.abs(np.linalg.norm(v, axis=1) - R)))

    refined, losses = refine_mesh(verts, faces, torch_logit, steps=50, lr=1e-3, device="cpu")
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert radial_err(refined) < 0.9 * radial_err(verts)


def test_refine_noop_cases():
    v = np.zeros((3, 3), np.float32)
    out, losses = refine_mesh(v, np.zeros((0, 3), np.int64), torch_logit, device="cpu")
    np.testing.assert_array_equal(out, v)
    assert losses.shape == (0,)
    out, _ = refine_mesh(v, np.array([[0, 1, 2]]), torch_logit, steps=0, device="cpu")
    np.testing.assert_array_equal(out, v)


def test_reconstructor_polish_matches_jax(monkeypatch):
    """SliceNet at img 32, res0 8, up 1, polished for 2 steps in both
    pipelines.  (Simplification is held bit-equal on equal inputs in
    test_torch_mesh_extra.py; here the two grids differ by fp32 rounding,
    which can move a greedy edge collapse.)"""
    steps = 2
    jmodel = JaxSliceNet(n_slices=12)
    variables = init_variables(jmodel, types.SimpleNamespace(img_size=32), seed=0)
    model = SliceNetModel(12)
    model.load_state_dict(slicenet_state_dict(variables))
    _, proj = camera.camera_matrices(0.0, 0.0, 1.2)
    feed = {"img_input": np.random.default_rng(3).uniform(-1, 1, (32, 32, 3)).astype(np.float32),
            "trans_mat_wo_rot_tp": proj.astype(np.float32)}
    probe, _ = Reconstructor(model, resolution0=8, upsampling_steps=0,
                             device="cpu").build_grid(feed)
    kw = dict(resolution0=8, upsampling_steps=1, chunk_size=1024,
              threshold=float(1.0 / (1.0 + np.exp(-np.median(probe)))))
    draws = shared_draws(monkeypatch, steps)
    want, w_stats = JaxReconstructor(jmodel, variables, refine_steps=steps,
                                     transport_dtype="float32", **kw).reconstruct(feed)
    monkeypatch.setattr(pipeline, "refine_mesh", functools.partial(refine_mesh, draws=draws))
    rec = Reconstructor(model, refine_steps=steps, device="cpu", **kw)
    got, stats = rec.reconstruct(feed)
    plain, _ = Reconstructor(model, device="cpu", **kw).reconstruct(feed)
    assert stats["n_points_evaluated"] == w_stats["n_points_evaluated"]
    assert len(got.faces) > 0
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(plain.faces, got.faces)
    assert np.abs(got.vertices - plain.vertices).max() > 1e-4  # the polish moved them
    # the end-to-end tolerance: RMSprop's first steps move a coordinate by up
    # to lr / sqrt(0.1) = 3.2e-4 whatever its gradient's size, so where the
    # field is nearly flat the two fp32 gradients can send it either way
    np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-3, rtol=0)
    assert stats["time_refine"] > 0 and np.isfinite(stats["refine_loss_last"])
