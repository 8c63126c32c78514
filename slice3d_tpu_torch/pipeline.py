"""Reconstruction pipeline: one object -> SDF lattice -> mesh.

Two models serve it: SliceNet (one input image, ``feed["img_input"]``) and
GTSlice (12 slice images, ``feed["img_slices"]``, e.g. the generation
route's sampled slices).  Per object: encode once (feature pyramids folded
through the first local Linear and packed, kept on the device), evaluate the
dense coarse lattice, refine it level by level through the host-side masked
refiner, extract the mesh with surface nets.  The coarse level runs as
groups of fixed-z slabs sampled with separable matmuls when the projection
allows it (ops/lattice_sample.py), else through the same per-point gather
path as the refinement levels.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import resolve_device
from .mesh import Mesh
from .mesh.extract import MeshGenerator, extract_mesh_from_grid
from .models.gtslice import GTSliceModel
from .models.slicenet import SliceNetModel
from .ops.lattice_sample import lattice_sample_sum, projection_is_separable
from .ops.projection import project_points

__all__ = ["Reconstructor"]

# test-mode canonical -> camera-aligned mapping: flip y and z
_FLIP = (1.0, -1.0, -1.0)


class Reconstructor:
    """SliceNet or GTSlice reconstruction at batch 1 on one device.

    Args:
      model: a ``SliceNetModel`` or a ``GTSliceModel`` (its ``dtype`` is the
        compute dtype; the fused encoder kernel takes bf16 on the card).
      resolution0 / upsampling_steps / threshold / chunk_size / box_size:
        the MISE operating point; refinement levels are evaluated in chunks
        of at most ``chunk_size`` points.
      slab_points: about how many points one coarse-level slab group holds
        (whole z-slabs of the (res0+1)^2 lattice plane).
      lattice_dense: sample the coarse level on separable slabs when the
        projection is separable (else, and when False, the gather path).
      device: where the model runs; CUDA unless the caller asks otherwise.
    """

    def __init__(self, model: Union[SliceNetModel, GTSliceModel], *,
                 resolution0: int = 64,
                 upsampling_steps: int = 2, threshold: float = 0.5,
                 chunk_size: int = 32768, box_size: float = 1.0,
                 slab_points: int = 32768, lattice_dense: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        for name, v in (("resolution0", resolution0), ("chunk_size", chunk_size),
                        ("slab_points", slab_points)):
            if not isinstance(v, (int, np.integer)) or v <= 0:
                raise ValueError(f"{name} must be a positive integer, got {v!r}")
        if not isinstance(upsampling_steps, (int, np.integer)) or upsampling_steps < 0:
            raise ValueError(f"upsampling_steps must be >= 0, got {upsampling_steps!r}")
        if not 0.0 < threshold < 1.0:
            raise ValueError(f"threshold must lie in (0, 1), got {threshold!r}")
        self.device = resolve_device(device)
        fused = any(layer.fused for layer in model.att_decoder.layers)
        if self.device.type == "cuda" and fused and model.dtype != torch.bfloat16:
            raise ValueError("the fused encoder kernel takes bf16 on the card: build "
                             "the model with dtype=torch.bfloat16 (or fused=False)")
        self.model = model.to(self.device).eval()
        self.chunk_size = int(chunk_size)
        self.box_size = float(box_size)
        self.lattice_dense = bool(lattice_dense)
        self.generator = MeshGenerator(resolution0=int(resolution0),
                                       upsampling_steps=int(upsampling_steps),
                                       threshold=float(threshold), box_size=self.box_size)
        nn0 = int(resolution0) + 1
        self.slab_group = min(nn0, max(1, int(round(slab_points / (nn0 * nn0)))))
        self._flip = torch.tensor(_FLIP, dtype=torch.float32, device=self.device)

    # -- queries -------------------------------------------------------------

    def _query_indices(self, packed, trans: torch.Tensor, idx: np.ndarray,
                       res: int) -> np.ndarray:
        """Logits at flat lattice indices ``idx = x*n^2 + y*n + z``."""
        n = res + 1
        out = []
        for s in range(0, len(idx), self.chunk_size):
            ix = torch.from_numpy(np.asarray(idx[s:s + self.chunk_size], np.int64))
            ix = ix.to(self.device)
            pts = torch.stack([ix // (n * n), (ix // n) % n, ix % n], -1).to(torch.float32)
            qry = ((pts / res - 0.5) * self.box_size) * self._flip
            out.append(-self.model.query_folded(packed, qry[None], trans)[0])
        return torch.cat(out).cpu().numpy()

    def _dense_lattice(self, packed, trans: torch.Tensor) -> np.ndarray:
        """Coarse-level logits over groups of z-slabs, separable sampling."""
        n0 = self.generator.resolution0
        nn0 = n0 + 1
        axis = (torch.arange(nn0, dtype=torch.float32, device=self.device) / n0 - 0.5) \
            * self.box_size
        vals = []
        for z0 in range(0, nn0, self.slab_group):
            zv = axis[z0:z0 + self.slab_group]  # (G,)
            g = len(zv)
            zeros = torch.zeros((g, nn0), device=self.device)
            ax = axis[None].expand(g, nn0)
            zcol = zv[:, None].expand(g, nn0)
            # probe rows: u depends only on (x, z), v only on (y, z)
            u = project_points((torch.stack([ax, zeros, zcol], -1) * self._flip)
                               .reshape(1, -1, 3), trans)[0, :, 0].reshape(g, nn0)
            v = project_points((torch.stack([zeros, ax, zcol], -1) * self._flip)
                               .reshape(1, -1, 3), trans)[0, :, 1].reshape(g, nn0)
            sampled = lattice_sample_sum(packed, u, v, self.model.n_slices)
            sampled = sampled.reshape(1, g * nn0 * nn0, *sampled.shape[-2:])
            # slab points in (slab, y, x) order
            qry = torch.stack([ax[:, None, :].expand(g, nn0, nn0),
                               ax[:, :, None].expand(g, nn0, nn0),
                               zv[:, None, None].expand(g, nn0, nn0)], -1)
            qry = qry.reshape(1, -1, 3) * self._flip
            vals.append(-self.model.query_presampled(qry, sampled)[0].reshape(g, nn0, nn0))
        # (z, y, x) -> flat lattice order idx = x*n^2 + y*n + z
        return torch.cat(vals).permute(2, 1, 0).reshape(-1).cpu().numpy()

    # -- reconstruction --------------------------------------------------------

    def _encode(self, feed: Dict[str, np.ndarray]) -> List[torch.Tensor]:
        """The model's folded, packed planes of one object."""
        if isinstance(self.model, GTSliceModel):
            img = torch.from_numpy(np.asarray(feed["img_slices"], np.float32))[None]
            return self.model.encode_folded(img.to(self.device))
        img = torch.from_numpy(np.asarray(feed["img_input"], np.float32))[None]
        return self.model.encode_folded(img.to(self.device))[0]

    @torch.no_grad()
    def build_grid(self, feed: Dict[str, np.ndarray]) -> Tuple[np.ndarray, Dict]:
        """feed: ``trans_mat_wo_rot_tp`` (4, 3) and the model's images:
        ``img_input`` (H, W, 3) for SliceNet, ``img_slices`` (12, H, W, 3)
        for GTSlice.  Returns (dense (res+1)^3 logit grid, stats)."""
        trans_np = np.asarray(feed["trans_mat_wo_rot_tp"], np.float32)
        trans = torch.from_numpy(trans_np)[None].to(self.device)
        stats: Dict = {}
        t0 = time.perf_counter()
        packed = self._encode(feed)
        n0 = self.generator.resolution0
        if self.lattice_dense and projection_is_separable(trans_np):
            dense = self._dense_lattice(packed, trans)
        else:
            dense = self._query_indices(packed, trans,
                                        np.arange((n0 + 1) ** 3, dtype=np.int64), n0)

        def evaluator(idxs: Sequence[np.ndarray], res: int) -> List[np.ndarray]:
            return [self._query_indices(packed, trans, ix, res) for ix in idxs]

        grid = self.generator.refiner().build_batch(evaluator, dense[None], [stats])[0]
        stats["time_eval_points"] = time.perf_counter() - t0
        return grid, stats

    def reconstruct(self, feed: Dict[str, np.ndarray]) -> Tuple[Mesh, Dict]:
        """One object: feed -> (mesh in world coordinates, stats)."""
        grid, stats = self.build_grid(feed)
        t0 = time.perf_counter()
        mesh = extract_mesh_from_grid(grid, self.generator.logit_threshold, self.box_size)
        stats["time_marching"] = time.perf_counter() - t0
        return mesh, stats
