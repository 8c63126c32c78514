"""Value-grid construction and mesh extraction.

Dense masked refinement at MISE's ``resolution0 / upsampling_steps /
threshold`` operating point:

  1. the full coarse lattice ((res0+1)^3) is evaluated;
  2. per level, the known grid is trilinearly upsampled and only the fine
     lattice points touching a cell whose corners straddle the threshold
     (dilated once) are evaluated;
  3. surface nets (or marching tetrahedra, ``method``) extracts the mesh
     from the final (res+1)^3 grid.

Lattice point ``idx = x*n^2 + y*n + z`` of an n = res+1 lattice sits at
``box_size * ((x, y, z) / res - 0.5)``.  Values are logits (the pipeline
feeds -sdf): inside is above the threshold.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import numpy as np

from . import Mesh, isosurface, refine_level

__all__ = ["GridRefiner", "extract_mesh_from_grid", "MeshGenerator"]

# evaluator(per-object flat int32 lattice index lists, resolution) -> values
BatchEvaluator = Callable[[Sequence[np.ndarray], int], Sequence[np.ndarray]]


@dataclass
class GridRefiner:
    """Builds dense value grids by coarse-to-fine masked evaluation."""

    resolution0: int = 64
    upsampling_steps: int = 2
    threshold: float = 0.0  # in value ("logit") space
    dilate: int = 1

    def build_batch(self, evaluator: BatchEvaluator, dense_vals: np.ndarray,
                    stats_list: Sequence[Dict]) -> List[np.ndarray]:
        """dense_vals (B, >= (res0+1)^3) coarse-lattice values; ``evaluator``
        takes the B index lists of a level and returns B value arrays (each
        at least its list's length).  Returns B dense (res+1)^3 grids and
        records ``n_points_evaluated`` / ``final_resolution`` per object."""
        n0 = self.resolution0
        n_l0 = (n0 + 1) ** 3
        dense = np.asarray(dense_vals, np.float32)
        grids = [dense[i, :n_l0].reshape(n0 + 1, n0 + 1, n0 + 1) for i in range(len(dense))]
        n_eval = [n_l0] * len(grids)
        res = n0
        for _ in range(self.upsampling_steps):
            refined = [refine_level(g, self.threshold, self.dilate) for g in grids]
            grids = [r[0] for r in refined]
            idxs = [r[1] for r in refined]
            res *= 2
            if all(len(ix) == 0 for ix in idxs):
                continue
            vals_list = evaluator(idxs, res)
            for i, ix in enumerate(idxs):
                if len(ix):
                    grids[i].reshape(-1)[ix] = np.asarray(vals_list[i][:len(ix)], np.float32)
                    n_eval[i] += len(ix)
        for i, st in enumerate(stats_list):
            st["n_points_evaluated"] = n_eval[i]
            st["final_resolution"] = res
        return grids


def extract_mesh_from_grid(grid: np.ndarray, threshold: float = 0.0,
                           box_size: float = 1.0, method: str = "surface_nets") -> Mesh:
    """Pad, isosurface (``method``, see ``mesh.isosurface``), and map
    vertices to world coordinates: the (res+1)^3 lattice spans
    ``box_size * [-0.5, 0.5]``."""
    res = grid.shape[0] - 1
    padded = np.pad(grid, 1, mode="constant", constant_values=-1e6)
    mesh = isosurface(padded, threshold, method=method)
    if mesh.is_empty:
        return mesh
    verts = (mesh.vertices - 1.0) / res  # undo the pad, normalize to [0, 1]
    mesh.vertices = (box_size * (verts - 0.5)).astype(np.float32)
    return mesh


@dataclass
class MeshGenerator:
    """Value-grid -> mesh driver for one object, with per-stage timings."""

    resolution0: int = 64
    upsampling_steps: int = 2
    threshold: float = 0.5  # probability-space threshold (reference flag)
    box_size: float = 1.0
    dilate: int = 1
    method: str = "surface_nets"  # isosurfacer (see mesh.isosurface)

    @property
    def logit_threshold(self) -> float:
        return float(np.log(self.threshold) - np.log(1.0 - self.threshold))

    def refiner(self) -> GridRefiner:
        return GridRefiner(self.resolution0, self.upsampling_steps, self.logit_threshold,
                           self.dilate)

    def generate(self, evaluator: Callable[[np.ndarray, int], np.ndarray]):
        """``evaluator(flat int32 lattice indices, res) -> values`` for one
        object.  Returns (mesh, stats)."""
        stats: Dict = {}
        n0 = self.resolution0
        t0 = time.perf_counter()
        dense = np.asarray(evaluator(np.arange((n0 + 1) ** 3, dtype=np.int32), n0),
                           np.float32)
        grid = self.refiner().build_batch(
            lambda idxs, res: [evaluator(idxs[0], res)], dense[None], [stats])[0]
        stats["time_eval_points"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh = extract_mesh_from_grid(grid, self.logit_threshold, self.box_size,
                                      method=self.method)
        stats["time_marching"] = time.perf_counter() - t0
        return mesh, stats
