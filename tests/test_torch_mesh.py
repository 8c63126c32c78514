"""The port's mesh stage (its own copy of the native refiner and surface
nets) against the JAX package's, on analytic fields: same inputs, same
points evaluated, identical meshes."""

import numpy as np
import pytest

from slice3d_tpu import mesh as jax_mesh
from slice3d_tpu.mesh import extract as jax_extract
from slice3d_tpu_torch import mesh
from slice3d_tpu_torch.mesh import extract


def blob_logits(idx, res):
    """A bumpy sphere: logit > 0 inside."""
    n = res + 1
    p = np.stack([idx // (n * n), (idx // n) % n, idx % n], -1).astype(np.float32)
    p = p / res - 0.5
    r = np.linalg.norm(p - np.float32([0.05, -0.02, 0.03]), axis=-1)
    return (0.3 - r + 0.04 * np.sin(9 * p[:, 0]) * np.cos(7 * p[:, 2])).astype(np.float32)


@pytest.mark.parametrize("res0,up", [(8, 2), (16, 1)])
def test_mesh_generator_matches_jax(res0, up):
    got, g_stats = extract.MeshGenerator(resolution0=res0, upsampling_steps=up).generate(
        blob_logits)
    want, w_stats = jax_extract.MeshGenerator(
        resolution0=res0, upsampling_steps=up, method="surface_nets").generate(blob_logits)
    assert g_stats["n_points_evaluated"] == w_stats["n_points_evaluated"]
    assert g_stats["n_points_evaluated"] > (res0 + 1) ** 3
    assert g_stats["final_resolution"] == w_stats["final_resolution"] == res0 * 2 ** up
    assert not got.is_empty
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.vertices, want.vertices)


def test_native_kernels_match_jax():
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(13, 13, 13)).astype(np.float32)
    fine, idx = mesh.refine_level(grid, 0.2, 1)
    j_fine, j_idx = jax_mesh.refine_level(grid, 0.2, 1)
    np.testing.assert_array_equal(fine, j_fine)
    np.testing.assert_array_equal(idx, j_idx)
    m = mesh.isosurface(grid, 0.1)
    j = jax_mesh.isosurface(grid, 0.1, method="surface_nets")
    np.testing.assert_array_equal(m.vertices, j.vertices)
    np.testing.assert_array_equal(m.faces, j.faces)
