"""Pointcloud / mesh file IO (PLY, OFF): the port's copy of the JAX package's
``slice3d_tpu/mesh/io.py``.

Parity target: ``reg_slices/src_convonet/utils/io.py`` (export_pointcloud /
load_pointcloud / read_off).  The reference depends on the ``plyfile``
package; that is not available here, so the tiny subset of PLY actually
used (a single float32 x/y/z vertex element, ascii or binary-little-endian)
is read and written directly.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def export_pointcloud(vertices: np.ndarray, out_file: str,
                      as_text: bool = True) -> None:
    """Write an (N, 3) float array as a PLY vertex cloud.

    ``as_text`` selects ascii vs binary_little_endian — both forms load
    back with :func:`load_pointcloud` and with standard viewers.
    """
    vertices = np.ascontiguousarray(np.asarray(vertices, np.float32))
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError(f"expected (N, 3) vertices, got {vertices.shape}")
    fmt = "ascii 1.0" if as_text else "binary_little_endian 1.0"
    header = "\n".join([
        "ply",
        f"format {fmt}",
        f"element vertex {len(vertices)}",
        "property float x",
        "property float y",
        "property float z",
        "end_header",
    ]) + "\n"
    with open(out_file, "wb") as f:
        f.write(header.encode("ascii"))
        if as_text:
            for x, y, z in vertices:
                f.write(f"{x:g} {y:g} {z:g}\n".encode("ascii"))
        else:
            f.write(vertices.astype("<f4").tobytes())


def load_pointcloud(in_file: str) -> np.ndarray:
    """Read the vertex x/y/z columns of an ascii or binary PLY file.

    Returns (N, 3) float32.  Extra vertex properties are skipped; elements
    other than ``vertex`` are ignored (and must follow it in the file).
    """
    with open(in_file, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{in_file}: not a PLY file")
        binary = False
        n_vertex = 0
        props: List[Tuple[str, str]] = []  # (dtype, name) of vertex elem
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{in_file}: unterminated PLY header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts:
                continue
            if parts[0] == "format":
                binary = parts[1] == "binary_little_endian"
                if parts[1] not in ("ascii", "binary_little_endian"):
                    raise ValueError(f"unsupported PLY format {parts[1]}")
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[1], parts[2]))
            elif parts[0] == "end_header":
                break

        _SIZES = {"float": "f4", "float32": "f4", "double": "f8",
                  "float64": "f8", "uchar": "u1", "uint8": "u1",
                  "char": "i1", "int8": "i1", "short": "i2", "ushort": "u2",
                  "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4"}
        names = [name for _, name in props]
        for axis in ("x", "y", "z"):
            if axis not in names:
                raise ValueError(f"{in_file}: vertex element has no '{axis}'")
        if binary:
            dt = np.dtype([(name, "<" + _SIZES[typ]) for typ, name in props])
            rec = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt,
                                count=n_vertex)
            cols = [rec[a].astype(np.float32) for a in ("x", "y", "z")]
        else:
            rows = np.loadtxt(
                [f.readline() for _ in range(n_vertex)], dtype=np.float32,
                ndmin=2)
            ix = [names.index(a) for a in ("x", "y", "z")]
            cols = [rows[:, i] for i in ix]
    return np.stack(cols, axis=1)


def read_off(file: str):
    """Read an OFF mesh; returns (vertices, faces) as lists of tuples.

    Accepts the ModelNet quirk where the counts share the first line with
    the ``OFF`` keyword.  Triangular faces only, matching the reference
    loader's contract (``src_convonet/utils/io.py:27``).
    """
    if not os.path.exists(file):
        raise FileNotFoundError(file)
    with open(file, "r") as fp:
        tokens: List[str] = []
        first = fp.readline().strip()
        if not first[:3].upper() == "OFF":
            raise ValueError(f"{file}: invalid OFF file")
        rest = first[3:].strip()
        if rest:  # counts glued onto the keyword line (ModelNet bug)
            tokens.extend(rest.split())
        tokens.extend(fp.read().split())

    n_vert, n_face = int(tokens[0]), int(tokens[1])
    # tokens[2] is the edge count — unused, as in every OFF reader
    pos = 3
    vertices = []
    for _ in range(n_vert):
        vertices.append(tuple(float(t) for t in tokens[pos:pos + 3]))
        pos += 3
    faces = []
    for _ in range(n_face):
        arity = int(tokens[pos])
        if arity != 3:
            raise ValueError(f"{file}: only triangular meshes supported")
        face = tuple(int(t) for t in tokens[pos:pos + 4])
        for idx in face[1:]:
            if not 0 <= idx < n_vert:
                raise ValueError(f"{file}: face index {idx} out of range")
        faces.append(face)
        pos += 4
    return vertices, faces
