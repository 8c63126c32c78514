"""Reconstruction pipeline: B objects -> SDF lattices -> meshes.

Two models serve it: SliceNet (one input image, ``feed["img_input"]``) and
GTSlice (12 slice images, ``feed["img_slices"]``, e.g. the generation
route's sampled slices).  Per batch of up to ``batch_size`` objects: encode
them in one call (feature pyramids folded through the first local Linear and
packed, kept on the device), evaluate each object's dense coarse lattice,
refine level by level through the host-side masked refiner, walking each
object's chunks in turn against the batch's stacked planes (``obj_index``),
and extract each mesh with surface nets.  The coarse level runs as groups of
fixed-z slabs sampled with separable matmuls when every projection of the
batch allows it (ops/lattice_sample.py), else through the same per-point
gather path as the refinement levels.  ``reconstruct_all`` marches batch i
on host threads while batch i+1 evaluates on the device.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

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
    """SliceNet or GTSlice reconstruction of up to ``batch_size`` objects at
    a time on one device.

    Args:
      model: a ``SliceNetModel`` or a ``GTSliceModel`` (its ``dtype`` is the
        compute dtype; both kernel routes of the encoder take bf16 on the
        card).
      resolution0 / upsampling_steps / threshold / chunk_size / box_size:
        the MISE operating point; refinement levels are evaluated in chunks
        of at most ``chunk_size`` points.
      slab_points: about how many points one coarse-level slab group holds
        (whole z-slabs of the (res0+1)^2 lattice plane).
      lattice_dense: sample the coarse level on separable slabs when every
        projection of the batch is separable (else, and when False, the
        gather path).
      batch_size: objects encoded and evaluated together
        (``reconstruct_batch``, ``reconstruct_all``); ``reconstruct`` takes
        one.
      device: where the model runs; CUDA unless the caller asks otherwise.
    """

    def __init__(self, model: Union[SliceNetModel, GTSliceModel], *,
                 resolution0: int = 64,
                 upsampling_steps: int = 2, threshold: float = 0.5,
                 chunk_size: int = 32768, box_size: float = 1.0,
                 slab_points: int = 32768, lattice_dense: bool = True,
                 batch_size: int = 1,
                 device: Optional[Union[str, torch.device]] = None):
        for name, v in (("resolution0", resolution0), ("chunk_size", chunk_size),
                        ("slab_points", slab_points), ("batch_size", batch_size)):
            if not isinstance(v, (int, np.integer)) or v <= 0:
                raise ValueError(f"{name} must be a positive integer, got {v!r}")
        if not isinstance(upsampling_steps, (int, np.integer)) or upsampling_steps < 0:
            raise ValueError(f"upsampling_steps must be >= 0, got {upsampling_steps!r}")
        if not 0.0 < threshold < 1.0:
            raise ValueError(f"threshold must lie in (0, 1), got {threshold!r}")
        self.device = resolve_device(device)
        kernels = {layer.route for layer in model.att_decoder.layers} - {"plain"}
        if self.device.type == "cuda" and kernels and model.dtype != torch.bfloat16:
            raise ValueError(f"the encoder's {sorted(kernels)} route takes bf16 on the card: "
                             "build the model with dtype=torch.bfloat16 (or route='plain')")
        self.model = model.to(self.device).eval()
        self.chunk_size = int(chunk_size)
        self.box_size = float(box_size)
        self.lattice_dense = bool(lattice_dense)
        self.batch_size = int(batch_size)
        self.generator = MeshGenerator(resolution0=int(resolution0),
                                       upsampling_steps=int(upsampling_steps),
                                       threshold=float(threshold), box_size=self.box_size)
        nn0 = int(resolution0) + 1
        self.slab_group = min(nn0, max(1, int(round(slab_points / (nn0 * nn0)))))
        self._flip = torch.tensor(_FLIP, dtype=torch.float32, device=self.device)

    # -- queries -------------------------------------------------------------

    def _query_indices(self, packed, trans: torch.Tensor, idx: np.ndarray, res: int,
                       obj: int) -> np.ndarray:
        """Logits of object ``obj`` of the batch at flat lattice indices
        ``idx = x*n^2 + y*n + z``, chunk by chunk; trans (1, 4, 3) is its
        projection."""
        n = res + 1
        obj_index = torch.tensor([obj], device=self.device)
        out = []
        for s in range(0, len(idx), self.chunk_size):
            ix = torch.from_numpy(np.asarray(idx[s:s + self.chunk_size], np.int64))
            ix = ix.to(self.device)
            pts = torch.stack([ix // (n * n), (ix // n) % n, ix % n], -1).to(torch.float32)
            qry = ((pts / res - 0.5) * self.box_size) * self._flip
            out.append(-self.model.query_folded(packed, qry[None], trans, obj_index)[0])
        return torch.cat(out).cpu().numpy()

    def _dense_lattice(self, packed, trans: torch.Tensor, obj: int) -> np.ndarray:
        """Coarse-level logits of object ``obj`` over groups of z-slabs,
        separable sampling; trans (1, 4, 3) is its projection."""
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
            sampled = lattice_sample_sum(packed, u, v, self.model.n_slices, obj_index=obj)
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

    def _stack_inputs(self, feeds: Sequence[Dict[str, np.ndarray]]
                      ) -> Tuple[torch.Tensor, np.ndarray]:
        """B feeds -> (the model's images (B, ...) on the device, the
        projections (B, 4, 3) on the host)."""
        key = "img_slices" if isinstance(self.model, GTSliceModel) else "img_input"
        imgs = np.stack([np.asarray(f[key], np.float32) for f in feeds])
        trans = np.stack([np.asarray(f["trans_mat_wo_rot_tp"], np.float32) for f in feeds])
        return torch.from_numpy(imgs).to(self.device), trans

    @torch.no_grad()
    def build_grids(self, feeds: Sequence[Dict[str, np.ndarray]]
                    ) -> Tuple[List[np.ndarray], List[Dict]]:
        """feeds: 1 to ``batch_size`` dicts of ``trans_mat_wo_rot_tp`` (4, 3)
        and the model's images: ``img_input`` (H, W, 3) for SliceNet,
        ``img_slices`` (12, H, W, 3) for GTSlice.  The objects are encoded in
        one call; each then walks its own coarse lattice and refinement
        chunks.  Returns (dense (res+1)^3 logit grids, stats) per object."""
        if not 1 <= len(feeds) <= self.batch_size:
            raise ValueError(f"{len(feeds)} feeds for a batch of at most {self.batch_size}")
        imgs, trans_np = self._stack_inputs(feeds)
        trans = torch.from_numpy(trans_np).to(self.device)
        stats_list: List[Dict] = [{} for _ in feeds]
        t0 = time.perf_counter()
        packed = self.model.encode_folded(imgs)
        if isinstance(self.model, SliceNetModel):
            packed = packed[0]
        n0 = self.generator.resolution0
        lattice = self.lattice_dense and all(projection_is_separable(t) for t in trans_np)
        coarse = np.arange((n0 + 1) ** 3, dtype=np.int64)
        dense = np.stack([
            self._dense_lattice(packed, trans[i:i + 1], i) if lattice
            else self._query_indices(packed, trans[i:i + 1], coarse, n0, i)
            for i in range(len(feeds))])

        def evaluator(idxs: Sequence[np.ndarray], res: int) -> List[np.ndarray]:
            # one object's chunks after another, each against its own planes
            return [self._query_indices(packed, trans[i:i + 1], ix, res, i) if len(ix)
                    else np.zeros((0,), np.float32) for i, ix in enumerate(idxs)]

        grids = self.generator.refiner().build_batch(evaluator, dense, stats_list)
        dt = time.perf_counter() - t0
        for stats in stats_list:
            stats["time_eval_points"] = dt
        return grids, stats_list

    def build_grid(self, feed: Dict[str, np.ndarray]) -> Tuple[np.ndarray, Dict]:
        """One object: feed -> (dense (res+1)^3 logit grid, stats)."""
        grids, stats = self.build_grids([feed])
        return grids[0], stats[0]

    def _march(self, grid: np.ndarray, stats: Dict) -> Mesh:
        t0 = time.perf_counter()
        mesh = extract_mesh_from_grid(grid, self.generator.logit_threshold, self.box_size)
        stats["time_marching"] = time.perf_counter() - t0
        return mesh

    def reconstruct(self, feed: Dict[str, np.ndarray]) -> Tuple[Mesh, Dict]:
        """One object (a batch of 1): feed -> (mesh in world coordinates,
        stats)."""
        grid, stats = self.build_grid(feed)
        return self._march(grid, stats), stats

    def reconstruct_batch(self, feeds: Sequence[Dict[str, np.ndarray]]
                          ) -> List[Tuple[Mesh, Dict]]:
        """Up to ``batch_size`` objects encoded and evaluated together."""
        grids, stats_list = self.build_grids(list(feeds))
        return [(self._march(g, st), st) for g, st in zip(grids, stats_list)]

    def reconstruct_all(self, feeds: Iterable[Dict[str, np.ndarray]],
                        on_result: Callable[[int, Mesh, Dict], None]) -> None:
        """Reconstruct many objects in batches of ``batch_size``, calling
        ``on_result(index, mesh, stats)`` in order.

        The tail batch is padded with copies of its last feed, so every
        batch has the same size and an object's values do not depend on
        where the split put it.  Marching (native code that releases the
        GIL) of batch i runs on worker threads while batch i+1 evaluates.
        """
        b = self.batch_size

        def batches():
            group = []
            for feed in feeds:
                group.append(feed)
                if len(group) == b:
                    yield group
                    group = []
            if group:
                yield group

        def finish(base, futures, stats_list):
            for j, fut in enumerate(futures):
                on_result(base + j, fut.result(), stats_list[j])

        with ThreadPoolExecutor(max(min(b, 8), 1)) as pool:
            pending = None
            base = 0
            for group in batches():
                n_real = len(group)
                grids, stats_list = self.build_grids(group + [group[-1]] * (b - n_real))
                futures = [pool.submit(self._march, grids[j], stats_list[j])
                           for j in range(n_real)]
                if pending is not None:
                    finish(*pending)
                pending = (base, futures, stats_list)
                base += n_real
            if pending is not None:
                finish(*pending)
