"""Separable bilinear sampling for fixed-z slabs of the query lattice.

The reconstruct path projects with the rotation-free matrix
``K @ [I | t]``: ``u`` depends only on (x, z), ``v`` only on (y, z) and the
divisor only on z.  A fixed-z slab of the axis-aligned lattice therefore
projects onto a tensor grid ``{u_i} x {v_j}``, and sampling a whole slab is
two small matmuls per pyramid level, ``A_v @ plane @ A_u^T``, with 1-D hat
weights ``A[(i, col)] = relu(1 - |p_i - col|)`` (the separable form of
``hat_sample``).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from .hat_sample import hat_weights as hat_matrix_1d  # (..., N) coords -> (..., N, n)

__all__ = ["projection_is_separable", "hat_matrix_1d", "lattice_sample_sum"]


def projection_is_separable(trans_mat_tp: np.ndarray, atol: float = 1e-6) -> bool:
    """True if ``uvw = [q, 1] @ trans_mat_tp`` has u free of y, v free of x
    and w free of both (checked on the host; trans_mat_tp (..., 4, 3))."""
    t = np.asarray(trans_mat_tp)
    return bool(
        np.all(np.abs(t[..., 1, 0]) <= atol)      # u: no y term
        and np.all(np.abs(t[..., 0, 1]) <= atol)  # v: no x term
        and np.all(np.abs(t[..., 0, 2]) <= atol)  # w: no x term
        and np.all(np.abs(t[..., 1, 2]) <= atol)  # w: no y term
    )


def lattice_sample_sum(packed: Sequence[torch.Tensor], u_nodes: torch.Tensor,
                       v_nodes: torch.Tensor, n_slices: int,
                       obj_index: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Sample every level of one object's packed planes on G tensor grids
    and sum the levels (the shared-plane slab-group mode).

    packed: [(B, h, w, S*d)] folded planes of a batch; the scalar
    ``obj_index`` names the object whose plane set every node row samples.
    u_nodes (G, Nx) and v_nodes (G, Ny) are normalized [-1, 1] coords, one
    row per slab.  Returns (G, Ny, Nx, S, d): the values
    ``sample_packed_sum`` gives for the slab points, up to float
    reassociation.
    """
    obj = int(obj_index)
    total = None
    for plane in packed:
        if not 0 <= obj < plane.shape[0]:
            raise ValueError(f"obj_index {obj} outside the batch of {plane.shape[0]}")
        _, h, w, sd = plane.shape
        px = (u_nodes.to(torch.float32) + 1.0) * 0.5 * (w - 1)
        py = (v_nodes.to(torch.float32) + 1.0) * 0.5 * (h - 1)
        a_u = hat_matrix_1d(px, w, plane.dtype)  # (G, Nx, w)
        a_v = hat_matrix_1d(py, h, plane.dtype)  # (G, Ny, h)
        g, ny = a_v.shape[:2]
        # rows first: all G slabs' hat rows against the one plane
        tmp = torch.matmul(a_v.reshape(g * ny, h), plane[obj].reshape(h, w * sd))
        s = torch.matmul(a_u[:, None], tmp.reshape(g, ny, w, sd))  # (G, Ny, Nx, sd)
        total = s if total is None else total + s
    g, ny, nx = total.shape[:3]
    return total.reshape(g, ny, nx, n_slices, -1)
