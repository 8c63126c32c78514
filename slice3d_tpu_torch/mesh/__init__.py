"""Host-side mesh stage: masked grid refinement, isosurface extraction
(surface nets or marching tetrahedra), simplification, inside-mesh tests,
voxelization and OBJ text.

The native kernels live in ``native/`` (``mesh_native.cpp``,
``mesh_tet.cpp``, ``mesh_extra.cpp``: the JAX package's sources) and are
built with g++ on first use into the package's git-ignored build directory.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

from ..native import build_library

__all__ = ["Mesh", "isosurface", "refine_level", "simplify_mesh", "points_inside_mesh",
           "voxelize_mesh", "obj_string", "export_obj", "load_library"]

_SRCS = [os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", name)
         for name in ("mesh_native.cpp", "mesh_tet.cpp", "mesh_extra.cpp")]

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


@dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int64

    @property
    def is_empty(self) -> bool:
        return len(self.vertices) == 0 or len(self.faces) == 0


def load_library() -> ctypes.CDLL:
    """Build (if stale) and load the native mesh library."""
    lib = build_library("s3d_torch_mesh", _SRCS,
                        ["g++", "-O3", "-std=c++17", "-fPIC", "-shared"])
    if lib.s3d_isosurface_sn.argtypes is None:
        i64 = ctypes.c_int64
        for fn in (lib.s3d_isosurface, lib.s3d_isosurface_sn):
            fn.restype = ctypes.c_int
            fn.argtypes = [_F32P, i64, i64, i64, ctypes.c_float,
                           ctypes.POINTER(_F32P), _I64P, ctypes.POINTER(_I64P), _I64P]
        lib.s3d_simplify.restype = ctypes.c_int
        lib.s3d_simplify.argtypes = [_F32P, i64, _I64P, i64, i64,
                                     ctypes.POINTER(_F32P), _I64P, ctypes.POINTER(_I64P), _I64P]
        lib.s3d_points_inside.restype = ctypes.c_int
        lib.s3d_points_inside.argtypes = [_F32P, i64, _I64P, i64, _F32P, i64, _U8P]
        lib.s3d_voxelize.restype = ctypes.c_int
        lib.s3d_voxelize.argtypes = [_F32P, i64, _I64P, i64, i64, _U8P]
        lib.s3d_refine_level.restype = ctypes.c_int
        lib.s3d_refine_level.argtypes = [
            _F32P, i64, ctypes.c_float, i64, _F32P, ctypes.POINTER(_I32P), _I64P,
        ]
        lib.s3d_free.argtypes = [ctypes.c_void_p]
        lib.s3d_obj_serialize.restype = i64
        lib.s3d_obj_serialize.argtypes = [_F32P, i64, _I64P, i64, ctypes.c_char_p, i64]
    return lib


def _take_mesh(lib, call, what: str) -> Mesh:
    """Run a native call that mallocs (verts, faces) and return them as a
    Mesh; ``call(verts_p, nv, faces_p, nf)`` passes the four out-pointers."""
    verts_p, faces_p = _F32P(), _I64P()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    rc = call(ctypes.byref(verts_p), ctypes.byref(nv), ctypes.byref(faces_p),
              ctypes.byref(nf))
    try:
        if rc != 0:
            raise RuntimeError(f"{what} failed")
        verts = (np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy()
                 if nv.value else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(faces_p, shape=(nf.value, 3)).copy()
                 if nf.value else np.zeros((0, 3), np.int64))
    finally:
        lib.s3d_free(verts_p)
        lib.s3d_free(faces_p)
    return Mesh(vertices=verts, faces=faces)


def isosurface(grid: np.ndarray, iso: float = 0.0, method: str = "surface_nets") -> Mesh:
    """Iso-surface of a dense (nx, ny, nz) grid; values > iso are inside.
    ``method``: ``"surface_nets"`` (one vertex per straddling cell) or
    ``"tetrahedra"`` (6-tet marching, vertices on the lattice edges).
    Vertices are in lattice coordinates, faces outward."""
    lib = load_library()
    fn = {"surface_nets": lib.s3d_isosurface_sn, "tetrahedra": lib.s3d_isosurface}[method]
    g = np.ascontiguousarray(grid, dtype=np.float32)
    return _take_mesh(lib, lambda *out: fn(g.ctypes.data_as(_F32P), g.shape[0], g.shape[1],
                                           g.shape[2], ctypes.c_float(iso), *out),
                      "isosurface extraction")


def refine_level(grid: np.ndarray, threshold: float, dilate: int = 1):
    """One coarse->fine level of dense masked refinement.

    Returns (fine grid (2n+1)^3 float32, the trilinear 2x upsample; idx int32,
    ascending flat indices of the fine lattice points touching a cell whose
    corners straddle ``threshold``, dilated ``dilate`` times).
    """
    lib = load_library()
    g = np.ascontiguousarray(grid, dtype=np.float32)
    n1 = g.shape[0]
    f1 = 2 * (n1 - 1) + 1
    fine = np.empty((f1, f1, f1), np.float32)
    idx_p = _I32P()
    nidx = ctypes.c_int64()
    rc = lib.s3d_refine_level(g.ctypes.data_as(_F32P), n1, ctypes.c_float(threshold),
                              dilate, fine.ctypes.data_as(_F32P),
                              ctypes.byref(idx_p), ctypes.byref(nidx))
    try:
        if rc != 0:
            raise RuntimeError("refine_level failed")
        idx = (np.ctypeslib.as_array(idx_p, shape=(nidx.value,)).copy()
               if nidx.value else np.zeros((0,), np.int32))
    finally:
        lib.s3d_free(idx_p)
    return fine, idx


def _mesh_buffers(mesh: Mesh):
    return (np.ascontiguousarray(mesh.vertices, np.float32),
            np.ascontiguousarray(mesh.faces, np.int64))


def simplify_mesh(mesh: Mesh, target_faces: int) -> Mesh:
    """Quadric edge-collapse simplification to about ``target_faces``."""
    if mesh.is_empty:
        return mesh
    lib = load_library()
    v, f = _mesh_buffers(mesh)
    return _take_mesh(lib, lambda *out: lib.s3d_simplify(
        v.ctypes.data_as(_F32P), len(v), f.ctypes.data_as(_I64P), len(f), int(target_faces),
        *out), "simplification")


def points_inside_mesh(mesh: Mesh, points: np.ndarray) -> np.ndarray:
    """Boolean containment of each (N, 3) point in a closed mesh."""
    lib = load_library()
    v, f = _mesh_buffers(mesh)
    p = np.ascontiguousarray(points, np.float32)
    out = np.zeros(len(p), np.uint8)
    rc = lib.s3d_points_inside(v.ctypes.data_as(_F32P), len(v), f.ctypes.data_as(_I64P),
                               len(f), p.ctypes.data_as(_F32P), len(p),
                               out.ctypes.data_as(_U8P))
    if rc != 0:
        raise RuntimeError("inside-mesh test failed")
    return out.astype(bool)


def voxelize_mesh(mesh: Mesh, resolution: int) -> np.ndarray:
    """Conservative surface voxelization over [0, 1]^3: (r, r, r) bool."""
    lib = load_library()
    v, f = _mesh_buffers(mesh)
    occ = np.zeros((resolution,) * 3, np.uint8)
    rc = lib.s3d_voxelize(v.ctypes.data_as(_F32P), len(v), f.ctypes.data_as(_I64P), len(f),
                          resolution, occ.ctypes.data_as(_U8P))
    if rc != 0:
        raise RuntimeError("voxelization failed")
    return occ.astype(bool)


def obj_string(mesh: Mesh) -> str:
    """The mesh as Wavefront OBJ text (1-indexed faces), formatted natively;
    byte-identical to :func:`obj_string_py`."""
    nv, nf = len(mesh.vertices), len(mesh.faces)
    if nv == 0:
        return ""
    lib = load_library()
    v = np.ascontiguousarray(mesh.vertices, np.float32)
    f = np.ascontiguousarray(mesh.faces, np.int64)
    # "v " + 3 x (sign, digits, '.', 6 decimals) + separators: <= 64 B a row
    cap = 64 * (nv + nf) + 16
    buf = ctypes.create_string_buffer(cap)
    n = lib.s3d_obj_serialize(v.ctypes.data_as(_F32P), nv, f.ctypes.data_as(_I64P), nf,
                              buf, cap)
    if n < 0:  # a coordinate too wide for the row budget
        return obj_string_py(mesh)
    return buf.raw[:n].decode("ascii")


def obj_string_py(mesh: Mesh) -> str:
    """The Python formatter the native serializer reproduces."""
    rows = [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in mesh.vertices]
    rows += [f"f {t[0]} {t[1]} {t[2]}\n" for t in np.asarray(mesh.faces) + 1]
    return "".join(rows)


def export_obj(mesh: Mesh, path: str) -> None:
    """Write the mesh as Wavefront OBJ (1-indexed faces)."""
    with open(path, "w") as f:
        f.write(obj_string(mesh))
