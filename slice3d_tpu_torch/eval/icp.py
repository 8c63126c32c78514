"""Point-cloud ICP alignment for evaluation: the port's
``slice3d_tpu/eval/icp.py``.

Role of the reference's vendored ``src_convonet/utils/icp.py`` (aligning
predicted and GT meshes before scoring when the reconstruction frame is only
known up to a rigid transform).  The nearest-neighbour search runs on the
card through the Chamfer metrics' chunked minimum (``metrics.nearest``); the
rigid fit is the closed-form SVD solution (Umeyama/Kabsch) on the host, in
float64.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .metrics import Device, nearest, nn_distances

__all__ = ["best_fit_transform", "icp"]


def best_fit_transform(a: np.ndarray, b: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Least-squares rigid transform mapping a -> b (same-length
    correspondences).  Returns (T (4,4), R (3,3), t (3,))."""
    ca, cb = a.mean(axis=0), b.mean(axis=0)
    aa, bb = a - ca, b - cb
    h = aa.T @ bb
    u, _, vt = np.linalg.svd(h)
    r = vt.T @ u.T
    if np.linalg.det(r) < 0:  # reflection -> rotation
        vt[-1] *= -1.0
        r = vt.T @ u.T
    t = cb - r @ ca
    tm = np.eye(4)
    tm[:3, :3] = r
    tm[:3, 3] = t
    return tm, r, t


def icp(src: np.ndarray, dst: np.ndarray, *, max_iterations: int = 20,
        tolerance: float = 1e-6, device: Device = None
        ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Iterative closest point: rigidly align src onto dst.

    Returns (T (4,4) mapping original src into dst's frame, final
    per-point NN distances, iterations used).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    cur = src.copy()
    prev_err = None
    it = 0
    for it in range(1, max_iterations + 1):
        idx = nearest(cur, dst, device)[1]
        matched = dst[idx]
        _, r, t = best_fit_transform(cur, matched)
        cur = cur @ r.T + t
        err = float(np.mean(np.linalg.norm(cur - matched, axis=1)))
        if prev_err is not None and abs(prev_err - err) < tolerance:
            break
        prev_err = err
    tm, _, _ = best_fit_transform(src, cur)
    dists = nn_distances(cur.astype(np.float32), dst.astype(np.float32), device)
    return tm, dists, it
