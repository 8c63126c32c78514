"""The port's native mesh pieces beyond surface nets (marching tetrahedra,
simplification, inside-mesh tests, voxelization), its ``mesh/io.py`` and
``mesh/voxels.py``, against the JAX package's.  Both build the same C++
sources, so every output must be bit-equal."""

import io

import numpy as np
import pytest

from slice3d_tpu import mesh as jax_mesh
from slice3d_tpu.mesh import extract as jax_extract
from slice3d_tpu.mesh import io as jax_io
from slice3d_tpu.mesh import voxels as jax_voxels
from slice3d_tpu_torch import mesh
from slice3d_tpu_torch.mesh import extract
from slice3d_tpu_torch.mesh import io as mesh_io
from slice3d_tpu_torch.mesh import voxels


def sphere_grid(n=24, radius=0.35, bump=0.0):
    lin = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    g = radius - np.sqrt(x * x + y * y + z * z) + bump * np.sin(9 * x) * np.cos(7 * z)
    return g.astype(np.float32)


def sphere_mesh(n=24, radius=0.35, bump=0.0):
    m = mesh.isosurface(sphere_grid(n, radius, bump), 0.0)
    return mesh.Mesh((m.vertices / (n - 1) - 0.5).astype(np.float32), m.faces)


def assert_same_mesh(got, want):
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)


@pytest.mark.parametrize("iso", [0.0, 0.05])
def test_tetrahedra_matches_jax(iso):
    rng = np.random.default_rng(0)
    for grid in (sphere_grid(bump=0.03), rng.normal(size=(11, 12, 13)).astype(np.float32)):
        got = mesh.isosurface(grid, iso, method="tetrahedra")
        assert not got.is_empty
        assert_same_mesh(got, jax_mesh.isosurface(grid, iso, method="tetrahedra"))
    with pytest.raises(KeyError):
        mesh.isosurface(grid, iso, method="cubes")


@pytest.mark.parametrize("method", ["surface_nets", "tetrahedra"])
def test_extract_method_matches_jax(method):
    grid = sphere_grid(17, bump=0.02)
    got = extract.extract_mesh_from_grid(grid, 0.01, 1.2, method=method)
    assert_same_mesh(got, jax_extract.extract_mesh_from_grid(grid, 0.01, 1.2, method=method))

    def logits(idx, res):
        n = res + 1
        p = np.stack([idx // (n * n), (idx // n) % n, idx % n], -1).astype(np.float32) / res
        return (0.3 - np.linalg.norm(p - 0.5, axis=-1)).astype(np.float32)

    got, g_stats = extract.MeshGenerator(8, 1, method=method).generate(logits)
    want, w_stats = jax_extract.MeshGenerator(8, 1, method=method).generate(logits)
    assert g_stats["n_points_evaluated"] == w_stats["n_points_evaluated"]
    assert_same_mesh(got, want)


@pytest.mark.parametrize("divisor", [2, 8, 40])
def test_simplify_matches_jax(divisor):
    m = sphere_mesh(bump=0.02)
    target = len(m.faces) // divisor
    got = mesh.simplify_mesh(m, target)
    assert 0 < len(got.faces) <= target * 1.2
    assert_same_mesh(got, jax_mesh.simplify_mesh(jax_mesh.Mesh(m.vertices, m.faces), target))
    r = np.linalg.norm(got.vertices, axis=1)
    assert abs(np.median(r) - 0.35) < 0.03  # a sphere still
    empty = mesh.Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    assert mesh.simplify_mesh(empty, 10) is empty


def test_points_inside_matches_jax():
    m = sphere_mesh(bump=0.02)
    pts = np.random.default_rng(1).uniform(-0.5, 0.5, (4000, 3)).astype(np.float32)
    got = mesh.points_inside_mesh(m, pts)
    np.testing.assert_array_equal(got, jax_mesh.points_inside_mesh(m, pts))
    assert got.dtype == bool and got[np.linalg.norm(pts, axis=1) < 0.25].all()
    assert not got[np.linalg.norm(pts, axis=1) > 0.45].any()


@pytest.mark.parametrize("res", [8, 20])
def test_voxelize_matches_jax(res):
    m = sphere_mesh(bump=0.02)
    unit = mesh.Mesh(m.vertices + 0.5, m.faces)  # voxelize_mesh spans [0, 1]^3
    got = mesh.voxelize_mesh(unit, res)
    np.testing.assert_array_equal(got, jax_mesh.voxelize_mesh(unit, res))
    assert got.shape == (res,) * 3 and got.any() and not got.all()


def test_voxel_grid_matches_jax():
    m = sphere_mesh()
    got = voxels.VoxelGrid.from_mesh(m, 16)
    want = jax_voxels.VoxelGrid.from_mesh(jax_mesh.Mesh(m.vertices, m.faces), 16)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.loc, want.loc)
    assert got.scale == want.scale
    assert_same_mesh(got.to_mesh(), want.to_mesh())
    pts = np.random.default_rng(2).uniform(-0.6, 0.6, (500, 3))
    np.testing.assert_array_equal(got.contains(pts), want.contains(pts))


def test_binvox_matches_jax():
    data = np.random.default_rng(0).random((16, 16, 16)) > 0.7
    grid = voxels.VoxelGrid(data=data, loc=np.array([0.1, 0.2, 0.3]), scale=2.0)
    buf, jbuf = io.BytesIO(), io.BytesIO()
    voxels.write_binvox(grid, buf)
    jax_voxels.write_binvox(jax_voxels.VoxelGrid(data=data, loc=grid.loc, scale=2.0), jbuf)
    assert buf.getvalue() == jbuf.getvalue()
    buf.seek(0)
    back = voxels.read_binvox(buf)
    np.testing.assert_array_equal(back.data, data)
    np.testing.assert_allclose(back.loc, grid.loc, atol=1e-6)
    assert back.scale == 2.0


@pytest.mark.parametrize("as_text", [True, False])
def test_pointcloud_io_matches_jax(tmp_path, as_text):
    pts = np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32)
    mesh_io.export_pointcloud(pts, str(tmp_path / "a.ply"), as_text=as_text)
    jax_io.export_pointcloud(pts, str(tmp_path / "b.ply"), as_text=as_text)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    back = mesh_io.load_pointcloud(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(back, jax_io.load_pointcloud(str(tmp_path / "b.ply")))
    # text rows keep 6 decimals, binary rows every bit
    np.testing.assert_allclose(back, pts, atol=1e-5 if as_text else 0, rtol=0)


def test_read_off_matches_jax(tmp_path):
    m = sphere_mesh(12)
    path = tmp_path / "m.off"
    rows = ["OFF", f"{len(m.vertices)} {len(m.faces)} 0"]
    rows += [" ".join(f"{c:.6f}" for c in v) for v in m.vertices]
    rows += ["3 " + " ".join(str(i) for i in f) for f in m.faces]
    path.write_text("\n".join(rows) + "\n")
    got, want = mesh_io.read_off(str(path)), jax_io.read_off(str(path))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], m.vertices, atol=1e-6)
