"""The port's main-path ops against their JAX twins (CPU, fp32, atol 1e-5).

Mirrors tests/test_hat_sample.py and tests/test_lattice_sample.py: the same
numpy-seeded inputs go through both packages.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from slice3d_tpu.models import sdf_head as jax_sdf_head
from slice3d_tpu.ops import hat_sample as jax_hat
from slice3d_tpu.ops import lattice_sample as jax_lattice
from slice3d_tpu.ops.projection import project_points as jax_project_points
from slice3d_tpu_torch import camera
from slice3d_tpu_torch.models.sdf_head import pack_planes, sample_packed_sum
from slice3d_tpu_torch.ops.hat_sample import hat_sample_level, hat_sample_sum
from slice3d_tpu_torch.ops.lattice_sample import (lattice_sample_sum,
                                                  projection_is_separable)
from slice3d_tpu_torch.ops.projection import project_points

TOL = dict(atol=1e-5, rtol=0)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_project_points_matches_jax_and_clamps():
    rng = np.random.default_rng(0)
    _, proj = camera.camera_matrices(0.8, 0.25, 1.2)
    trans = np.stack([proj, proj * 1.1]).astype(np.float32)
    # points far off-axis project outside [0, 1]: the clamp must hold
    pts = rng.uniform(-1.5, 1.5, (2, 257, 3)).astype(np.float32)
    got = project_points(t(pts), t(trans))
    close(got, jax_project_points(jnp.asarray(pts), jnp.asarray(trans)))
    assert got.dtype == torch.float32
    assert got.abs().max() <= 1.0 and (got.abs() == 1.0).any()
    # bf16 points still project in fp32
    bf = project_points(t(pts).to(torch.bfloat16), t(trans))
    assert bf.dtype == torch.float32


@pytest.mark.parametrize("lo,hi,shape", [(-1.0, 1.0, (2, 9, 7, 24)),
                                         (-1.8, 1.8, (1, 5, 5, 8))],
                         ids=["in_range", "out_of_range"])
def test_hat_sample_level_matches_jax(lo, hi, shape):
    rng = np.random.default_rng(1)
    plane = rng.normal(size=shape).astype(np.float32)
    b, h, w, _ = shape
    uv = rng.uniform(lo, hi, (b, 333, 2)).astype(np.float32)
    px = (uv[..., 0] + 1) * 0.5 * (w - 1)
    py = (uv[..., 1] + 1) * 0.5 * (h - 1)
    got = hat_sample_level(t(plane), t(px), t(py))
    close(got, jax_hat.hat_sample_level(jnp.asarray(plane), jnp.asarray(px),
                                        jnp.asarray(py)))


def test_hat_sample_sum_routing_matches_jax():
    rng = np.random.default_rng(2)
    planes = [rng.normal(size=(1, s, s, 12)).astype(np.float32) for s in (8, 16, 64)]
    uv = rng.uniform(-1, 1, (1, 200, 2)).astype(np.float32)
    total, rest = hat_sample_sum([t(p) for p in planes], t(uv), max_rows=256)
    j_total, j_rest = jax_hat.hat_sample_sum([jnp.asarray(p) for p in planes],
                                             jnp.asarray(uv), max_rows=256)
    assert len(rest) == len(j_rest) == 1 and rest[0].shape == (1, 64, 64, 12)
    close(total, j_total)


@pytest.mark.parametrize("hat_max_rows", [0, 64, 1024], ids=["rows", "mixed", "hat"])
def test_sample_packed_sum_matches_jax(hat_max_rows):
    """Rows gather path (with zero-padding corners at the clamp border) and
    the hat routing give the JAX values."""
    rng = np.random.default_rng(3)
    s, d = 3, 4
    packed = [rng.normal(size=(2, h, w, s * d)).astype(np.float32)
              for h, w in ((8, 8), (16, 12), (32, 32))]
    uv = rng.uniform(-1, 1, (2, 97, 2)).astype(np.float32)
    uv[0, :4] = [[-1, -1], [1, 1], [1, -1], [0.999999, 0.5]]
    got = sample_packed_sum([t(p) for p in packed], t(uv), s, hat_max_rows=hat_max_rows)
    want = jax_sdf_head.sample_packed_sum([jnp.asarray(p) for p in packed],
                                          jnp.asarray(uv), s, hat_max_rows=hat_max_rows)
    assert tuple(got.shape) == (2, 97, s, d)
    close(got, want)


def test_pack_planes_matches_jax():
    rng = np.random.default_rng(4)
    planes = [rng.normal(size=(2 * 3, h, h, 5)).astype(np.float32) for h in (4, 8)]
    got = pack_planes([t(p) for p in planes], 3)
    want = jax_sdf_head.pack_planes([jnp.asarray(p) for p in planes], 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lattice_sample_sum_shared_plane_matches_jax():
    rng = np.random.default_rng(5)
    s, d = 3, 4
    packed = [rng.normal(size=(1, h, w, s * d)).astype(np.float32)
              for h, w in ((8, 8), (5, 7), (2, 2))]
    g, nx, ny = 3, 6, 4
    # nodes include out-of-range values to pin the zero-attenuation border
    u = rng.uniform(-1.2, 1.2, (g, nx)).astype(np.float32)
    v = rng.uniform(-1.2, 1.2, (g, ny)).astype(np.float32)
    got = lattice_sample_sum([t(p) for p in packed], t(u), t(v), s)
    want = jax_lattice.lattice_sample_sum([jnp.asarray(p) for p in packed],
                                          jnp.asarray(u), jnp.asarray(v), s,
                                          obj_index=jnp.asarray(0, jnp.int32))
    assert tuple(got.shape) == (g, ny, nx, s, d)
    close(got, want)
    # and it equals the per-point gather path at the slab's tensor grid
    uu = np.broadcast_to(u[0][None], (ny, nx))
    vv = np.broadcast_to(v[0][:, None], (ny, nx))
    uv = np.stack([uu.ravel(), vv.ravel()], -1)[None]
    rows = sample_packed_sum([t(p) for p in packed], t(uv), s, hat_max_rows=0)
    np.testing.assert_allclose(got[0].reshape(1, -1, s, d).numpy(), rows.numpy(), **TOL)


def test_projection_is_separable():
    _, trans_tp = camera.camera_matrices(0.7, 0.3, 1.8)
    rot = np.array([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]], np.float32)
    full = np.concatenate([rot, np.zeros((1, 3), np.float32)], axis=0)
    for m in (trans_tp, np.eye(4, 3, dtype=np.float32), full):
        assert projection_is_separable(m) == jax_lattice.projection_is_separable(m)
    assert projection_is_separable(trans_tp) and not projection_is_separable(full)
