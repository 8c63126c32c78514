"""Voxel-grid utilities + binvox IO (roles of src_convonet's voxels.py and
binvox_rw.py — secondary utilities kept for dataset tooling parity): the
port's copy of the JAX package's ``slice3d_tpu/mesh/voxels.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO

import numpy as np

from . import Mesh, isosurface, points_inside_mesh, voxelize_mesh

__all__ = ["VoxelGrid", "read_binvox", "write_binvox"]


@dataclass
class VoxelGrid:
    """Dense boolean occupancy over an axis-aligned box."""

    data: np.ndarray  # (n, n, n) bool
    loc: np.ndarray = None  # box center
    scale: float = 1.0  # box edge length

    def __post_init__(self):
        if self.loc is None:
            self.loc = np.zeros(3)
        self.loc = np.asarray(self.loc, np.float64)

    @classmethod
    def from_mesh(cls, mesh: Mesh, resolution: int, *, fill: bool = True) -> "VoxelGrid":
        """Voxelize a mesh: conservative surface shell + interior fill."""
        lo = mesh.vertices.min(axis=0)
        hi = mesh.vertices.max(axis=0)
        center = (lo + hi) / 2
        scale = float((hi - lo).max()) * 1.001 + 1e-9
        unit = Mesh(
            vertices=((mesh.vertices - center) / scale + 0.5).astype(np.float32),
            faces=mesh.faces,
        )
        occ = voxelize_mesh(unit, resolution)
        if fill:
            lin = (np.arange(resolution) + 0.5) / resolution
            x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
            centers = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
            # break ties: symmetric meshes put edges exactly on voxel-center
            # rays, which defeats ray-parity counting.  An irrational offset
            # of ~a quarter voxel stays within the voxel while clearing any
            # lattice-aligned edge by far more than fp32 noise.
            centers[:, :2] += 0.1618033989 / resolution
            inside = points_inside_mesh(unit, centers).reshape(occ.shape)
            occ = occ | inside
        return cls(data=occ, loc=center, scale=scale)

    def to_mesh(self) -> Mesh:
        """Isosurface of the occupancy field, mapped back to world coords."""
        n = self.data.shape[0]
        grid = self.data.astype(np.float32) - 0.5
        padded = np.pad(grid, 1, constant_values=-0.5)
        mesh = isosurface(padded, 0.0)
        if mesh.is_empty:
            return mesh
        verts = (mesh.vertices - 1.0 + 0.5) / n - 0.5  # voxel centers
        mesh.vertices = (verts * self.scale + self.loc).astype(np.float32)
        return mesh

    def contains(self, points: np.ndarray) -> np.ndarray:
        n = self.data.shape[0]
        local = (points - self.loc) / self.scale + 0.5
        idx = np.floor(local * n).astype(int)
        ok = ((idx >= 0) & (idx < n)).all(axis=1)
        out = np.zeros(len(points), bool)
        sel = idx[ok]
        out[ok] = self.data[sel[:, 0], sel[:, 1], sel[:, 2]]
        return out


def read_binvox(f: BinaryIO) -> VoxelGrid:
    """Read the binvox run-length format."""
    line = f.readline().strip()
    if not line.startswith(b"#binvox"):
        raise ValueError("not a binvox file")
    dims, translate, scale = None, (0.0, 0.0, 0.0), 1.0
    while True:
        line = f.readline().strip()
        if line.startswith(b"data"):
            break
        tok = line.split()
        if tok[0] == b"dim":
            dims = tuple(int(t) for t in tok[1:4])
        elif tok[0] == b"translate":
            translate = tuple(float(t) for t in tok[1:4])
        elif tok[0] == b"scale":
            scale = float(tok[1])
    raw = np.frombuffer(f.read(), dtype=np.uint8)
    values, counts = raw[::2], raw[1::2]
    data = np.repeat(values, counts).astype(bool)
    data = data.reshape(dims)  # binvox order: x, z, y
    data = np.transpose(data, (0, 2, 1))
    return VoxelGrid(data=data, loc=np.asarray(translate) + scale / 2, scale=scale)


def write_binvox(grid: VoxelGrid, f: BinaryIO) -> None:
    data = np.transpose(grid.data, (0, 2, 1)).astype(np.uint8).reshape(-1)
    f.write(b"#binvox 1\n")
    f.write(f"dim {grid.data.shape[0]} {grid.data.shape[1]} {grid.data.shape[2]}\n".encode())
    t = grid.loc - grid.scale / 2
    f.write(f"translate {t[0]} {t[1]} {t[2]}\n".encode())
    f.write(f"scale {grid.scale}\n".encode())
    f.write(b"data\n")
    # run-length encode
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        v = data[i]
        run = 1
        while i + run < n and data[i + run] == v and run < 255:
            run += 1
        out.append(int(v))
        out.append(run)
        i += run
    f.write(bytes(out))
