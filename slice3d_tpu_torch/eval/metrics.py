"""Mesh evaluation metrics: Chamfer-L1/L2, F-score, Hausdorff, IoU.

The port's ``slice3d_tpu/eval/metrics.py``.  Surface sampling stays numpy,
line for line, so a seed gives the JAX package's points.  The
nearest-neighbour reductions run on the card (CUDA unless the caller asks
otherwise) as a chunked brute-force minimum over the expanded squared
distance ``(|a|^2 - 2 a.b) + |b|^2``, one matmul per block of rows, in fp32
with TF32 off: the F-score counts distances under 0.01, where TF32's 10-bit
mantissa would move points across the threshold.

On the CPU the blocks take their plain version: the same sums written out
as the fp32 fused multiply-add chains that XLA's CPU backend runs for the
JAX function (``fma(x2, y2, fma(x1, y1, x0 y0))`` for ``|a|^2`` and
``2a.b``, each step rounded to fp32, emulated in fp64, where the products
are exact), so the CPU agrees with the JAX package bit for bit and a
threshold count or an ICP correspondence never flips between the two.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device

__all__ = ["sample_mesh_surface", "nearest", "nn_distances", "chamfer_metrics",
           "hausdorff_distance", "occupancy_iou"]

# elements of one block of squared distances (rows x |b|): 1 GiB in fp32,
# ~2,700 rows against 100,000 points
BLOCK_ELEMS = 1 << 28

Device = Optional[Union[str, torch.device]]


def sample_mesh_surface(vertices: np.ndarray, faces: np.ndarray, n: int,
                        seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling -> (n, 3) float32."""
    rng = np.random.default_rng(seed)
    tris = vertices[faces]  # (F, 3, 3)
    cross = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    if area.sum() <= 0:
        return np.zeros((n, 3), np.float32)
    probs = area / area.sum()
    idx = rng.choice(len(faces), size=n, p=probs)
    u = rng.random((n, 1)).astype(np.float32)
    v = rng.random((n, 1)).astype(np.float32)
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    t = tris[idx]
    pts = t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])
    return pts.astype(np.float32)


def _fma_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (N, 3) . y (M, 3) -> (N, M) fp32 as the chain
    ``fma(x2, y2, fma(x1, y1, x0 y0))``, each step rounded to fp32 (fp64
    holds the fp32 products exactly)."""
    x, y = x.to(torch.float64), y.to(torch.float64)
    acc = (x[:, None, 0] * y[None, :, 0]).to(torch.float32)
    for k in (1, 2):
        acc = (x[:, None, k] * y[None, :, k] + acc).to(torch.float32)
    return acc


def _row_sq(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 of each row of x (N, 3) as the same fp32 chain."""
    x = x.to(torch.float64)
    acc = (x[:, 0] * x[:, 0]).to(torch.float32)
    for k in (1, 2):
        acc = (x[:, k] * x[:, k] + acc).to(torch.float32)
    return acc


def _sq_dists(ac: torch.Tensor, b: torch.Tensor, b_sq: torch.Tensor) -> torch.Tensor:
    """(|ac|^2 - 2 ac.b) + |b|^2 for a block of rows: one fp32 matmul on the
    card, the fused multiply-add chains on the CPU."""
    if ac.is_cuda:
        d = torch.matmul(ac, b.t()).mul_(-2.0)
        return d.add_((ac * ac).sum(1, keepdim=True)).add_(b_sq[None])
    return (_row_sq(ac)[:, None] - _fma_dot(2.0 * ac, b)) + b_sq[None]


def nearest(a: np.ndarray, b: np.ndarray, device: Device = None,
            block_elems: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """For each point of a (N, 3): the squared distance to its nearest point
    of b (M, 3), clipped at 0, and that point's index (the first of equal
    ones).  Blocks of ``block_elems // M`` rows of a (default
    ``BLOCK_ELEMS`` on the card, 1/64 of it on the CPU)."""
    dev = resolve_device(device)
    ta = torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    tb = torch.as_tensor(np.asarray(b, np.float32)).to(dev)
    if block_elems is None:
        block_elems = BLOCK_ELEMS if dev.type == "cuda" else BLOCK_ELEMS // 64
    rows = max(1, int(block_elems) // max(len(tb), 1))
    b_sq = (tb * tb).sum(1) if dev.type == "cuda" else _row_sq(tb)
    mins, idx = [], []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, len(ta), rows):
            m, i = _sq_dists(ta[s:s + rows], tb, b_sq).min(1)
            mins.append(m.clamp_min_(0.0))
            idx.append(i)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not mins:
        return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
    return torch.cat(mins).cpu().numpy(), torch.cat(idx).cpu().numpy()


def nn_distances(a: np.ndarray, b: np.ndarray, device: Device = None) -> np.ndarray:
    """Euclidean nearest-neighbour distances from each a-point to b."""
    return np.sqrt(nearest(a, b, device)[0])


def chamfer_metrics(pred_pts: np.ndarray, gt_pts: np.ndarray, f_threshold: float = 0.01,
                    device: Device = None) -> Dict[str, float]:
    """Chamfer-L1/L2 + F-score/precision/recall (reference utils_eval.py:72-87)."""
    d_pred = nn_distances(pred_pts, gt_pts, device)  # pred -> gt  (precision side)
    d_gt = nn_distances(gt_pts, pred_pts, device)  # gt -> pred  (recall side)
    chamfer_l1 = 0.5 * (d_pred.mean() + d_gt.mean())
    chamfer_l2 = 0.5 * ((d_pred ** 2).mean() + (d_gt ** 2).mean())
    precision = float((d_pred < f_threshold).mean())
    recall = float((d_gt < f_threshold).mean())
    fscore = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "chamfer_l1": float(chamfer_l1),
        "chamfer_l2": float(chamfer_l2),
        "precision": precision,
        "recall": recall,
        "fscore": fscore,
    }


def hausdorff_distance(a: np.ndarray, b: np.ndarray, device: Device = None) -> float:
    return float(max(nn_distances(a, b, device).max(), nn_distances(b, a, device).max()))


def occupancy_iou(occ_pred: np.ndarray, occ_gt: np.ndarray) -> float:
    """IoU of boolean occupancies evaluated at shared sample points."""
    p = occ_pred.astype(bool)
    g = occ_gt.astype(bool)
    union = np.logical_or(p, g).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(p, g).sum() / union)
