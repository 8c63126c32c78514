"""Blender camera projection chain for Slice3D inputs (plain NumPy, host).

The port's own copy of ``camera_matrices`` and the geometry it needs.  A
Blender camera with a 35 mm lens on a 32 mm sensor orbits the origin at
``distance``; the model needs

* ``obj_rot_mat`` (3, 3): rotates canonical query points into the
  camera-aligned frame, applied as ``q @ obj_rot_mat``;
* ``trans_mat_wo_rot_tp`` (4, 3): the rotation-free projection applied as
  ``[q, 1] @ trans_mat_wo_rot_tp`` before the perspective divide.

DISN instead projects the unrotated canonical points with the full camera
matrix (``full_projection_matrix``, the feed's ``trans_mat_right``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["intrinsics", "blender_rt", "canonical_rot4", "camera_matrices",
           "full_projection_matrix", "sdf_sample_transform"]

FOCAL_MM = 35.0
SENSOR_MM = 32.0

# Blender's fixed camera-to-object frame change, and the y/z flip from its
# -Z-forward/+Y-up camera to the +Z-forward/+Y-down projection convention.
_CAM_ROT = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
_CAM_FIX = np.diag([1.0, -1.0, -1.0])


def intrinsics(img_w: float = 1.0, img_h: float = 1.0) -> np.ndarray:
    """Pinhole intrinsics; with unit image size projections land in [0, 1]."""
    f_u = FOCAL_MM * img_w / SENSOR_MM
    f_v = FOCAL_MM * img_h / SENSOR_MM
    return np.array([[f_u, 0.0, img_w / 2.0], [0.0, f_v, img_h / 2.0],
                     [0.0, 0.0, 1.0]])


def blender_rt(az: float, el: float, distance: float) -> np.ndarray:
    """World-to-camera extrinsics ``[R | t]`` (3, 4); angles in radians."""
    sa, ca = np.sin(-az), np.cos(-az)
    se, ce = np.sin(-el), np.cos(-el)
    r_world2obj = np.array([[ca * ce, -sa, ca * se], [sa * ce, ca, sa * se],
                            [-se, 0.0, ce]]).T
    r_obj2cam = _CAM_ROT.T
    rot = _CAM_FIX @ r_obj2cam @ r_world2obj
    trans = _CAM_FIX @ (-(r_obj2cam @ np.array([distance, 0.0, 0.0])))
    return np.concatenate([rot, trans[:, None]], axis=1)


def canonical_rot4() -> np.ndarray:
    """Constant canonical-frame rotation (4, 4): ``(x, y, z) -> (x, -z, y)``."""
    m = np.zeros((4, 4))
    m[0, 0] = 1.0
    m[1, 2] = -1.0
    m[2, 1] = 1.0
    m[3, 3] = 1.0
    return m


def camera_matrices(az_meta: float, el_meta: float, distance: float):
    """(obj_rot_mat (3, 3), trans_mat_wo_rot_tp (4, 3)) from the raw
    azimuth (negated before use, as the dataset stores it), elevation and
    distance."""
    k = intrinsics(1.0, 1.0)
    rt = blender_rt(-float(az_meta), float(el_meta), float(distance))
    rot_full = rt @ canonical_rot4()  # (3, 4)
    obj_rot_mat = rot_full.T[:3, :]
    # rotation-free projection: only the constant translation column stays
    tmp = np.concatenate([np.eye(3), rot_full[:, 3:4]], axis=1)
    return obj_rot_mat, (k @ tmp).T


def full_projection_matrix(az_meta: float, el_meta: float, distance: float) -> np.ndarray:
    """Transposed full projection (4, 3), ``(K @ RT @ canonical_rot4).T``,
    from the same raw angles and distance as ``camera_matrices``."""
    k = intrinsics(1.0, 1.0)
    rt = blender_rt(-float(az_meta), float(el_meta), float(distance))
    return (k @ (rt @ canonical_rot4())).T


def sdf_sample_transform(points: np.ndarray, sdf: np.ndarray, scale: float, offset) -> tuple:
    """Apply the per-object random normalization recorded at render time.

    The renderer scaled the object by ``scale`` and shifted it by ``offset``
    (Blender frame); SDF samples live in the unscaled frame and were
    extracted at iso-level 0.003 (reference: reg_slices/src/datasets.py:146-148).
    Returns the rescaled (points, sdf).
    """
    offset = np.asarray(offset, dtype=np.float64)
    off = np.array([offset[0], offset[2], -offset[1]])
    pts = points * scale + off
    vals = (sdf - 0.003) * scale
    return pts, vals
