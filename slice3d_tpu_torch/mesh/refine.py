"""Mesh polish: RMSprop on the vertex positions against the predicted field,
the port's ``slice3d_tpu/mesh/refine.py`` (reference ``Generator3D.refine_mesh``,
reg_slices/reconstruct.py:271-332).

Each step draws one Dirichlet(0.5, 0.5, 0.5) barycentric point per face and
moves the vertices so that

* the points sit on the decision boundary, ``(sigmoid(logit) - threshold)^2``,
* the face normals align with the negated, normalized gradient of the
  predicted occupancy there (a second-order term: the gradient is taken with
  ``create_graph=True`` and differentiated again),

both summed over the faces and divided by their count, the normal term
weighted 0.01.  The faces are walked in chunks, each chunk's gradient taken
on its own and summed, so memory stays at one chunk's graph.  The update is
optax's ``rmsprop`` written out: decay 0.9, eps 1e-8 inside the square root,
the second moment starting at 0 (``torch.optim.RMSprop`` differs on all
three).  The draws are numpy's (``default_rng(seed).dirichlet``) unless the
caller passes its own.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from .. import resolve_device

__all__ = ["refine_mesh"]

DECAY = 0.9
EPS = 1e-8


def _normalize(v: torch.Tensor) -> torch.Tensor:
    # sqrt(sum + eps) keeps the gradient finite for degenerate triangles
    return v / torch.sqrt(torch.sum(v * v, dim=1, keepdim=True) + 1e-20)


def _chunk_loss(v: torch.Tensor, faces: torch.Tensor, eps: torch.Tensor,
                logit_fn: Callable[[torch.Tensor], torch.Tensor], threshold: float,
                n_real: float) -> torch.Tensor:
    fv = v[faces]  # (C, 3, 3)
    face_point = torch.sum(fv * eps[:, :, None], dim=1)
    normal = _normalize(torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 1], dim=1))
    face_value = torch.sigmoid(logit_fn(face_point).to(torch.float32))
    (grad,) = torch.autograd.grad(face_value.sum(), face_point, create_graph=True)
    normal_target = _normalize(-grad)
    t_target = torch.sum((face_value - threshold) ** 2)
    t_normal = torch.sum(torch.sum((normal - normal_target) ** 2, dim=1))
    return t_target / n_real + 0.01 * t_normal / n_real


def refine_mesh(verts: np.ndarray, faces: np.ndarray,
                logit_fn: Callable[[torch.Tensor], torch.Tensor], *, steps: int = 30,
                lr: float = 1e-4, threshold: float = 0.5, seed: int = 0,
                face_chunk: int = 2048,
                draws: Optional[Callable[[int, int], np.ndarray]] = None,
                device: Optional[Union[str, torch.device]] = None):
    """Refine ``verts`` (V, 3) of ``faces`` (F, 3) against ``logit_fn``:
    (M, 3) points on ``device`` -> (M,) pseudo-logits (inside positive),
    differentiable twice.  ``steps`` / ``lr`` / ``threshold`` are the
    reference's operating point (RMSprop lr 1e-4, sigmoid-space threshold).
    ``draws(step, F)`` gives a step's (F, 3) barycentric weights.

    Returns (refined verts (V, 3) float32, per-step losses (steps,)): step
    k's loss is that of the vertices before its update, at its draws."""
    if len(faces) == 0 or steps <= 0:
        return np.asarray(verts), np.zeros((0,), np.float32)
    dev = resolve_device(device)
    n_faces = len(faces)
    if draws is None:
        rng = np.random.default_rng(seed)

        def draws(step, n):
            return rng.dirichlet(np.full(3, 0.5), size=n)

    v = torch.as_tensor(np.asarray(verts, np.float32)).to(dev)
    f = torch.as_tensor(np.asarray(faces, np.int64)).to(dev)
    nu = torch.zeros_like(v)
    n_real = float(max(n_faces, 1))
    losses = []
    for step in range(steps):
        eps = torch.as_tensor(np.asarray(draws(step, n_faces), np.float32)[:n_faces]).to(dev)
        leaf = v.detach().requires_grad_(True)
        grad = torch.zeros_like(v)
        loss = torch.zeros((), device=dev)
        for s in range(0, n_faces, face_chunk):
            chunk = _chunk_loss(leaf, f[s:s + face_chunk], eps[s:s + face_chunk], logit_fn,
                                threshold, n_real)
            (g,) = torch.autograd.grad(chunk, leaf)
            grad += g
            loss += chunk.detach()
        nu = (1.0 - DECAY) * grad * grad + DECAY * nu
        v = v + grad * torch.rsqrt(nu + EPS) * (-lr)
        losses.append(loss)
    return v.cpu().numpy(), torch.stack(losses).cpu().numpy()
