"""Reconstruction pipeline: B objects -> SDF lattices -> meshes.

Three models serve it: SliceNet (one input image, ``feed["img_input"]``),
GTSlice (12 slice images, ``feed["img_slices"]``, e.g. the generation
route's sampled slices) and DISN (one input image with the full camera,
``feed["trans_mat_right"]`` and ``feed["obj_rot_mat"]``).  Per batch of up
to ``batch_size`` objects: encode them in one call (kept on the device;
SliceNet's and GTSlice's feature pyramids folded through the first local
Linear and packed, DISN's raw pyramids and global feature), evaluate each
object's dense coarse lattice, refine level by level through the host-side
masked refiner, walking each object's chunks in turn against the batch's
stacked planes (``obj_index``), and extract each mesh (surface nets or
marching tetrahedra), optionally simplified and then polished against the
field (``refine_steps``, through autograd on the head's plain route).  The
folded models' coarse level runs as groups of fixed-z slabs sampled with
separable matmuls when every projection of the batch allows it
(ops/lattice_sample.py), else through the same per-point gather path as the
refinement levels; DISN always takes the gather path.  ``reconstruct_all``
marches batch i on host threads while batch i+1 evaluates.

A ``mesh`` (``parallel.create_mesh``) spreads the work over its data
devices, each holding a replica of the model (one a distinct device):
``shard_axis="batch"`` gives each device a contiguous part of the object
batch, ``"points"`` deals each object's head calls (its coarse slab groups,
each level's refinement chunks) to the devices in turn, against planes
encoded once and copied to each.  Every device's part is issued before any
is gathered, so the devices overlap.  A head call runs whole on one device,
so every point's value, and with them the points refined, are the unsharded
run's: the JAX package splits each call's points instead, but a bf16 GEMM on
the card rounds with its row count.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import resolve_device
from .mesh import Mesh, simplify_mesh
from .mesh.extract import MeshGenerator, extract_mesh_from_grid
from .mesh.refine import refine_mesh
from .parallel.mesh import Mesh as DeviceMesh
from .parallel.sharding import replicate, shard_batch
from .models.disn import DISNModel
from .models.gtslice import GTSliceModel
from .models.slicenet import SliceNetModel
from .ops.fused_encoder import KERNEL_DTYPES
from .ops.lattice_sample import lattice_sample_sum, projection_is_separable
from .ops.projection import project_points

__all__ = ["Reconstructor", "check_head_routes"]

# test-mode canonical -> camera-aligned mapping: flip y and z
_FLIP = (1.0, -1.0, -1.0)
EXTRACT_METHODS = ("surface_nets", "tetrahedra")

# what a batch's encode leaves on one device: (encoded, per-object extras),
# extras being the projections (B, 4, 3), or for DISN (trans_mat_right,
# obj_rot_mat)
Cond = Tuple[object, Tuple[torch.Tensor, ...]]
SHARD_AXES = ("batch", "points")


class _Encoded:
    """A batch's encode on the data devices: ``conds[d]`` is device d's Cond
    (None where a batch-sharded device got no object), ``per`` the objects
    a device holds under batch sharding (0: every device holds the whole
    batch)."""

    def __init__(self, conds: List[Optional[Cond]], per: int = 0):
        self.conds = conds
        self.per = per

    def where(self, obj: int) -> Tuple[int, int]:
        """(device index, the object's index in that device's Cond)."""
        return (obj // self.per, obj % self.per) if self.per else (0, obj)


def check_head_routes(device: torch.device, routes: Iterable[str],
                      dtype: Optional[torch.dtype]) -> None:
    """Raise unless a model whose encoder layers take ``routes`` and compute
    in ``dtype`` (None: the fp32 inputs' dtype) can run on ``device``: on a
    card, the kernel routes (``"fused"``, ``"split"``) take bf16 or fp32,
    the dtypes of the head's kernels; the plain route and the CPU take
    any."""
    kernels = sorted(set(routes) - {"plain"})
    dt = dtype or torch.float32
    if device.type == "cuda" and kernels and dt not in KERNEL_DTYPES:
        raise ValueError(f"the encoder's {kernels} route takes bf16 or fp32 on the card, not "
                         f"{dt}: build the model with dtype=torch.bfloat16 or None (fp32), or "
                         "route='plain'")


def _moved(x, device: torch.device):
    """A Cond (nested lists and tuples of tensors) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(_moved(v, device) for v in x)


def _gather(pieces: Sequence[torch.Tensor], lattice: bool = False) -> np.ndarray:
    """Device pieces of values, in order -> one host array; with ``lattice``
    (z, y, x) pieces -> flat lattice order idx = x*n^2 + y*n + z.  One copy
    to the host where the pieces share a device."""
    if len({p.device for p in pieces}) > 1:
        pieces = [p.cpu() for p in pieces]
    vals = torch.cat(list(pieces))
    if lattice:
        vals = vals.permute(2, 1, 0).reshape(-1)
    return vals.cpu().numpy()


class Reconstructor:
    """SliceNet, GTSlice or DISN reconstruction of up to ``batch_size``
    objects at a time on one device or over a mesh.

    Args:
      model: a ``SliceNetModel``, ``GTSliceModel`` or ``DISNModel`` (its
        ``dtype`` is the compute dtype, None for fp32; both kernel routes of
        the encoder take bf16 or fp32 on the card: ``check_head_routes``).
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
      simplify_nfaces: simplify each mesh to about this many faces (0: off).
      refine_steps: RMSprop steps of the mesh polish (0: off), after
        simplification, in face chunks of ``chunk_size``; its queries
        differentiate twice through the head's plain route, which shares the
        model's weights and dtype.
      extract_method: ``"surface_nets"`` or ``"tetrahedra"``.
      device: where the model runs; CUDA unless the caller asks otherwise.
      mesh: a ``parallel.Mesh`` whose data devices share the work (then
        ``device`` is its first data device); None: one device.
      shard_axis: what splits over the mesh, ``"batch"`` (objects;
        ``batch_size`` must divide by the data axis) or ``"points"`` (each
        object's head calls, dealt in turn; ``chunk_size`` must divide by
        the data axis).  Dealing whole calls needs no such rule, but the
        JAX package splits each call's points and refuses a chunk that does
        not divide; the port refuses it too, so that both packages accept
        the same options and ``reconstruction_mesh`` falls back alike.
    """

    def __init__(self, model: Union[SliceNetModel, GTSliceModel, DISNModel], *,
                 resolution0: int = 64,
                 upsampling_steps: int = 2, threshold: float = 0.5,
                 chunk_size: int = 32768, box_size: float = 1.0,
                 slab_points: int = 32768, lattice_dense: bool = True,
                 batch_size: int = 1, simplify_nfaces: int = 0, refine_steps: int = 0,
                 extract_method: str = "surface_nets",
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[DeviceMesh] = None, shard_axis: str = "batch"):
        for name, v in (("resolution0", resolution0), ("chunk_size", chunk_size),
                        ("slab_points", slab_points), ("batch_size", batch_size)):
            if not isinstance(v, (int, np.integer)) or v <= 0:
                raise ValueError(f"{name} must be a positive integer, got {v!r}")
        for name, v in (("upsampling_steps", upsampling_steps),
                        ("simplify_nfaces", simplify_nfaces), ("refine_steps", refine_steps)):
            if not isinstance(v, (int, np.integer)) or v < 0:
                raise ValueError(f"{name} must be >= 0, got {v!r}")
        if not 0.0 < threshold < 1.0:
            raise ValueError(f"threshold must lie in (0, 1), got {threshold!r}")
        if extract_method not in EXTRACT_METHODS:
            raise ValueError(f"unknown extract_method {extract_method!r}: one of "
                             f"{EXTRACT_METHODS}")
        if shard_axis not in SHARD_AXES:
            raise ValueError(f"unknown shard_axis {shard_axis!r}")
        if mesh is not None:
            n_data = mesh.shape["data"]
            if shard_axis == "points" and chunk_size % n_data:
                raise ValueError(f"chunk_size {chunk_size} not divisible by data axis size "
                                 f"{n_data}")
            if shard_axis == "batch" and batch_size % n_data:
                raise ValueError(f"batch_size {batch_size} not divisible by data axis size "
                                 f"{n_data}")
            device = mesh.data_devices[0]
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.device = resolve_device(device)
        self.is_disn = isinstance(model, DISNModel)
        if not self.is_disn:
            check_head_routes(self.device, (layer.route for layer in model.att_decoder.layers),
                              model.dtype)
        self.model = model.to(self.device).eval()
        self.chunk_size = int(chunk_size)
        self.box_size = float(box_size)
        self.lattice_dense = bool(lattice_dense)
        self.batch_size = int(batch_size)
        self.simplify_nfaces = int(simplify_nfaces)
        self.refine_steps = int(refine_steps)
        self.generator = MeshGenerator(resolution0=int(resolution0),
                                       upsampling_steps=int(upsampling_steps),
                                       threshold=float(threshold), box_size=self.box_size,
                                       method=extract_method)
        nn0 = int(resolution0) + 1
        self.slab_group = min(nn0, max(1, int(round(slab_points / (nn0 * nn0)))))
        self._flip = torch.tensor(_FLIP, dtype=torch.float32, device=self.device)
        # (model, flip) a data device; repeats of a device share its replica
        self._replicas = [(self.model, self._flip)]
        if mesh is not None:
            self._replicas = list(zip(replicate(self.model, mesh), replicate(self._flip, mesh)))

    @property
    def _shard_points(self) -> bool:
        return self.mesh is not None and self.shard_axis == "points"

    # -- queries -------------------------------------------------------------

    def _logits(self, cond: Cond, obj: int, pts: torch.Tensor,
                route: Optional[str] = None, d: int = 0) -> torch.Tensor:
        """Logits (inside positive) of object ``obj`` of ``cond`` at world
        points pts (M, 3) on data device ``d``, through its replica;
        ``route`` overrides the head's."""
        encoded, extras = cond
        model, flip = self._replicas[d]
        if self.is_disn:
            pyramids, feat_global = encoded
            trans_right, obj_rot = extras
            pts = pts[None]
            sdf = model.query([p[obj:obj + 1] for p in pyramids],
                              feat_global[obj:obj + 1], pts @ obj_rot[obj:obj + 1], pts,
                              trans_right[obj:obj + 1])
            return -sdf[0]
        obj_index = torch.tensor([obj], device=pts.device)
        qry = (pts * flip)[None]
        return -model.query_folded(encoded, qry, extras[0][obj:obj + 1], obj_index,
                                   route=route)[0]

    def _index_logits(self, enc: _Encoded, d: int, obj: int, idx: np.ndarray,
                      res: int) -> torch.Tensor:
        """One head call on data device ``d``: logits of object ``obj`` of
        its Cond at flat lattice indices ``idx = x*n^2 + y*n + z``."""
        n = res + 1
        ix = torch.from_numpy(np.asarray(idx, np.int64)).to(self._replicas[d][1].device)
        pts = torch.stack([ix // (n * n), (ix // n) % n, ix % n], -1).to(torch.float32)
        return self._logits(enc.conds[d], obj, (pts / res - 0.5) * self.box_size, d=d)

    def _query_indices(self, enc: _Encoded, idx: np.ndarray, res: int,
                       obj: int) -> List[torch.Tensor]:
        """Logits of object ``obj`` of the batch at flat lattice indices,
        chunk by chunk, issued on the devices and not yet gathered; under
        points sharding chunk j goes to data device j mod n."""
        d, local = enc.where(obj)
        n = len(enc.conds) if self._shard_points else 1
        return [self._index_logits(enc, d + j % n, local, idx[s:s + self.chunk_size], res)
                for j, s in enumerate(range(0, len(idx), self.chunk_size))]

    def _slab_logits(self, enc: _Encoded, d: int, obj: int, z0: int, g: int) -> torch.Tensor:
        """Coarse-level logits (g, y, x) of object ``obj`` of device ``d``'s
        Cond over the z-slabs z0 .. z0+g-1, separable sampling."""
        model, flip = self._replicas[d]
        packed, extras = enc.conds[d]
        trans = extras[0][obj:obj + 1]
        n0 = self.generator.resolution0
        nn0 = n0 + 1
        axis = (torch.arange(nn0, dtype=torch.float32, device=flip.device) / n0 - 0.5) \
            * self.box_size
        zv = axis[z0:z0 + g]  # (g,)
        zeros = torch.zeros((g, nn0), device=flip.device)
        ax = axis[None].expand(g, nn0)
        zcol = zv[:, None].expand(g, nn0)
        # probe rows: u depends only on (x, z), v only on (y, z)
        u = project_points((torch.stack([ax, zeros, zcol], -1) * flip)
                           .reshape(1, -1, 3), trans)[0, :, 0].reshape(g, nn0)
        v = project_points((torch.stack([zeros, ax, zcol], -1) * flip)
                           .reshape(1, -1, 3), trans)[0, :, 1].reshape(g, nn0)
        sampled = lattice_sample_sum(packed, u, v, model.n_slices, obj_index=obj)
        sampled = sampled.reshape(1, g * nn0 * nn0, *sampled.shape[-2:])
        # slab points in (slab, y, x) order
        qry = torch.stack([ax[:, None, :].expand(g, nn0, nn0),
                           ax[:, :, None].expand(g, nn0, nn0),
                           zv[:, None, None].expand(g, nn0, nn0)], -1)
        qry = qry.reshape(1, -1, 3) * flip
        return -model.query_presampled(qry, sampled)[0].reshape(g, nn0, nn0)

    def _dense_lattice(self, enc: _Encoded, obj: int) -> List[torch.Tensor]:
        """Coarse-level logits of object ``obj`` of a folded model over
        groups of z-slabs, issued and not yet gathered: (g, y, x) pieces in
        z order.  Under points sharding group j goes to data device j mod
        n."""
        nn0 = self.generator.resolution0 + 1
        d, local = enc.where(obj)
        n = len(enc.conds) if self._shard_points else 1
        return [self._slab_logits(enc, d + j % n, local, z0, min(self.slab_group, nn0 - z0))
                for j, z0 in enumerate(range(0, nn0, self.slab_group))]

    # -- reconstruction --------------------------------------------------------

    def _stack_inputs(self, feeds: Sequence[Dict[str, np.ndarray]],
                      device: Optional[torch.device] = None
                      ) -> Tuple[torch.Tensor, Tuple[np.ndarray, ...]]:
        """B feeds -> (the model's images (B, ...) on ``device``, default the
        Reconstructor's, the per-object camera matrices on the host): the
        projections (B, 4, 3), or DISN's full projections (B, 4, 3) and
        rotations (B, 3, 3)."""
        key = "img_slices" if isinstance(self.model, GTSliceModel) else "img_input"
        imgs = np.stack([np.asarray(f[key], np.float32) for f in feeds])
        names = (("trans_mat_right", "obj_rot_mat") if self.is_disn
                 else ("trans_mat_wo_rot_tp",))
        extras = tuple(np.stack([np.asarray(f[k], np.float32) for f in feeds]) for k in names)
        return torch.from_numpy(imgs).to(device or self.device), extras

    def _encode_cond(self, imgs: torch.Tensor, extras: Tuple[torch.Tensor, ...], d: int) -> Cond:
        """Encode images (B, ...) on data device ``d`` through its replica;
        ``extras``: their camera matrices, on that device too."""
        model = self._replicas[d][0]
        if self.is_disn:
            return model.encode(imgs), extras
        encoded = model.encode_folded(imgs)
        return (encoded[0] if isinstance(model, SliceNetModel) else encoded), extras

    def _encode_batch(self, feeds: Sequence[Dict[str, np.ndarray]]) -> _Encoded:
        """The batch's encode on the data devices: one device holds all of
        it; batch sharding gives device d the d-th contiguous part
        (``parallel.shard_batch``); points sharding encodes once and copies
        the planes to each device."""
        if self.mesh is None or self.shard_axis == "points":
            imgs, extras = self._stack_inputs(feeds)
            cond = self._encode_cond(imgs, tuple(torch.from_numpy(e).to(self.device)
                                                 for e in extras), 0)
            if self.mesh is None:
                return _Encoded([cond])
            copies: Dict[torch.device, Cond] = {}
            return _Encoded([copies.setdefault(dev, _moved(cond, dev))
                             for dev in self.mesh.data_devices])
        imgs, extras = self._stack_inputs(feeds, torch.device("cpu"))
        parts = zip(shard_batch(imgs, self.mesh),
                    *(shard_batch(torch.from_numpy(e), self.mesh) for e in extras))
        return _Encoded([self._encode_cond(p[0], tuple(p[1:]), d) if len(p[0]) else None
                         for d, p in enumerate(parts)], -(-len(feeds) // len(self._replicas)))

    @torch.no_grad()
    def _build(self, feeds: Sequence[Dict[str, np.ndarray]]
               ) -> Tuple[List[np.ndarray], List[Dict], _Encoded]:
        """Encode the batch, build every object's grid; returns (grids,
        stats, the encoded batch for the polish)."""
        if not 1 <= len(feeds) <= self.batch_size:
            raise ValueError(f"{len(feeds)} feeds for a batch of at most {self.batch_size}")
        stats_list: List[Dict] = [{} for _ in feeds]
        t0 = time.perf_counter()
        enc = self._encode_batch(feeds)
        n0 = self.generator.resolution0
        lattice = (not self.is_disn and self.lattice_dense
                   and all(projection_is_separable(np.asarray(f["trans_mat_wo_rot_tp"],
                                                              np.float32)) for f in feeds))
        coarse = np.arange((n0 + 1) ** 3, dtype=np.int64)
        # every object's work issued on its device(s) before any is gathered
        pending = [self._dense_lattice(enc, i) if lattice
                   else self._query_indices(enc, coarse, n0, i) for i in range(len(feeds))]
        dense = np.stack([_gather(p, lattice) for p in pending])

        def evaluator(idxs: Sequence[np.ndarray], res: int) -> List[np.ndarray]:
            # one object's chunks after another, each against its own planes
            pending = [self._query_indices(enc, ix, res, i) if len(ix) else None
                       for i, ix in enumerate(idxs)]
            return [_gather(p) if p is not None else np.zeros((0,), np.float32)
                    for p in pending]

        grids = self.generator.refiner().build_batch(evaluator, dense, stats_list)
        dt = time.perf_counter() - t0
        for stats in stats_list:
            stats["time_eval_points"] = dt
        return grids, stats_list, enc

    def build_grids(self, feeds: Sequence[Dict[str, np.ndarray]]
                    ) -> Tuple[List[np.ndarray], List[Dict]]:
        """feeds: 1 to ``batch_size`` dicts of the model's images
        (``img_input`` (H, W, 3) for SliceNet and DISN, ``img_slices``
        (12, H, W, 3) for GTSlice) and its camera (``trans_mat_wo_rot_tp``
        (4, 3); DISN: ``trans_mat_right`` (4, 3) and ``obj_rot_mat`` (3, 3)).
        The objects are encoded in one call; each then walks its own coarse
        lattice and refinement chunks.  Returns (dense (res+1)^3 logit grids,
        stats) per object."""
        grids, stats_list, _ = self._build(feeds)
        return grids, stats_list

    def build_grid(self, feed: Dict[str, np.ndarray]) -> Tuple[np.ndarray, Dict]:
        """One object: feed -> (dense (res+1)^3 logit grid, stats)."""
        grids, stats = self.build_grids([feed])
        return grids[0], stats[0]

    def _march(self, grid: np.ndarray, stats: Dict) -> Mesh:
        """Extract (and simplify) one mesh; runs on worker threads."""
        t0 = time.perf_counter()
        mesh = extract_mesh_from_grid(grid, self.generator.logit_threshold, self.box_size,
                                      method=self.generator.method)
        if self.simplify_nfaces and not mesh.is_empty:
            mesh = simplify_mesh(mesh, self.simplify_nfaces)
        stats["time_marching"] = time.perf_counter() - t0
        return mesh

    def _maybe_refine(self, mesh: Mesh, enc: _Encoded, obj: int, stats: Dict) -> Mesh:
        """The polish of ``refine_steps`` steps against object ``obj``'s
        field (the reference's refine_mesh), on the caller's thread and the
        device that holds the object."""
        if not self.refine_steps or mesh.is_empty:
            return mesh
        t0 = time.perf_counter()
        d, local = enc.where(obj)
        with torch.enable_grad():
            verts, losses = refine_mesh(
                mesh.vertices, mesh.faces,
                lambda p: self._logits(enc.conds[d], local, p, route="plain", d=d),
                steps=self.refine_steps, threshold=self.generator.threshold,
                face_chunk=self.chunk_size, device=self._replicas[d][1].device)
        stats["time_refine"] = time.perf_counter() - t0
        # the first and last steps' losses, each at its own step's draws
        stats["refine_loss_first"] = float(losses[0])
        stats["refine_loss_last"] = float(losses[-1])
        return Mesh(vertices=verts, faces=mesh.faces)

    @torch.no_grad()
    def predicted_slices(self, img_input: np.ndarray) -> np.ndarray:
        """SliceNet only: img_input (H, W, 3) -> its predicted slice images
        (S, H, W, 3), fp32 in [-1, 1] (``reconstruct_slices``' dump)."""
        if not isinstance(self.model, SliceNetModel):
            raise ValueError("predicted_slices requires a SliceNet model")
        img = torch.from_numpy(np.asarray(img_input, np.float32)[None]).to(self.device)
        return self.model.encode(img)[1].float().cpu().numpy()

    def reconstruct(self, feed: Dict[str, np.ndarray]) -> Tuple[Mesh, Dict]:
        """One object (a batch of 1): feed -> (mesh in world coordinates,
        stats)."""
        grids, stats_list, enc = self._build([feed])
        mesh = self._march(grids[0], stats_list[0])
        return self._maybe_refine(mesh, enc, 0, stats_list[0]), stats_list[0]

    def reconstruct_batch(self, feeds: Sequence[Dict[str, np.ndarray]]
                          ) -> List[Tuple[Mesh, Dict]]:
        """Up to ``batch_size`` objects encoded and evaluated together."""
        grids, stats_list, enc = self._build(list(feeds))
        return [(self._maybe_refine(self._march(g, st), enc, i, st), st)
                for i, (g, st) in enumerate(zip(grids, stats_list))]

    def reconstruct_all(self, feeds: Iterable[Dict[str, np.ndarray]],
                        on_result: Callable[[int, Mesh, Dict], None]) -> None:
        """Reconstruct many objects in batches of ``batch_size``, calling
        ``on_result(index, mesh, stats)`` in order.

        The tail batch is padded with copies of its last feed, so every
        batch has the same size and an object's values do not depend on
        where the split put it.  Marching and simplification (native code
        that releases the GIL) of batch i run on worker threads while batch
        i+1 evaluates; the polish, which runs the model, stays on this
        thread.
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

        def finish(base, futures, stats_list, enc):
            for j, fut in enumerate(futures):
                mesh = self._maybe_refine(fut.result(), enc, j, stats_list[j])
                on_result(base + j, mesh, stats_list[j])

        with ThreadPoolExecutor(max(min(b, 8), 1)) as pool:
            pending = None
            base = 0
            for group in batches():
                n_real = len(group)
                grids, stats_list, enc = self._build(group + [group[-1]] * (b - n_real))
                futures = [pool.submit(self._march, grids[j], stats_list[j])
                           for j in range(n_real)]
                if pending is not None:
                    finish(*pending)
                pending = (base, futures, stats_list, enc)
                base += n_real
            if pending is not None:
                finish(*pending)
