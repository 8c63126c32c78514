"""Evaluate reconstructed meshes against ground truth (the port's root
``eval.py``), with the nearest-neighbour search on the card.

    python -m slice3d_tpu_torch.eval --name_exp exp1 --name_dataset objaverse \\
        [--dir_gt_meshes data/objaverse/meshes] [--n_pts 100000] [--icp_align] \\
        [--out summary.json] [--device cpu]

Compares ``experiments/<exp>/results/<dataset>/<id>.obj`` with GT meshes (or,
without ``--dir_gt_meshes``, with the surface band of the ``02_sdfs``
samples): Chamfer-L1/L2, F-score, Hausdorff (GT meshes only) and IoU through
the native inside-mesh test.  ``--icp_align`` rigidly aligns the prediction
onto the GT first.  The root CLI's flags plus ``--device`` (default
``cuda``).  ``main(argv)`` returns the mean over the shapes, or None.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np

from ..mesh import Mesh, points_inside_mesh
from .icp import icp
from .metrics import chamfer_metrics, hausdorff_distance, occupancy_iou, sample_mesh_surface

__all__ = ["load_obj", "main"]


def load_obj(path: str) -> Mesh:
    """The ``v`` and ``f`` rows of a Wavefront OBJ file (1-indexed faces,
    ``v/vt/vn`` face tokens read by their vertex index)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                faces.append([int(tok.split("/")[0]) - 1 for tok in line.split()[1:4]])
    return Mesh(vertices=np.asarray(verts, np.float32).reshape(-1, 3),
                faces=np.asarray(faces, np.int64).reshape(-1, 3))


def main(argv=None) -> Optional[Dict[str, float]]:
    p = argparse.ArgumentParser(prog="python -m slice3d_tpu_torch.eval")
    p.add_argument("--name_exp", type=str, required=True)
    p.add_argument("--name_dataset", type=str, default="objaverse")
    p.add_argument("--dir_data", type=str, default="./data")
    p.add_argument("--dir_experiments", type=str, default="experiments")
    p.add_argument("--dir_gt_meshes", type=str, default="",
                   help="directory of GT <id>.obj meshes; if empty, evaluate "
                        "against 02_sdfs surface-band samples")
    p.add_argument("--n_pts", type=int, default=100000)
    p.add_argument("--f_threshold", type=float, default=0.01)
    p.add_argument("--icp_align", action="store_true",
                   help="rigidly align predicted points onto GT with ICP before scoring")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = args.device

    root = os.path.join(args.dir_data, args.name_dataset)
    res_dir = os.path.join(args.dir_experiments, args.name_exp, "results", args.name_dataset)
    with open(os.path.join(root, "03_splits", "test.lst")) as f:
        ids = f.read().split()

    rows = []
    for sid in ids:
        mesh_path = os.path.join(res_dir, f"{sid}.obj")
        if not os.path.exists(mesh_path):
            print(f"skip {sid}: no result mesh")
            continue
        pred = load_obj(mesh_path)
        if pred.is_empty:
            print(f"skip {sid}: empty mesh")
            continue
        pred_pts = sample_mesh_surface(pred.vertices, pred.faces, args.n_pts)

        def align_to(gt_pts):
            """ICP-align the prediction (points and mesh) onto the GT."""
            nonlocal pred, pred_pts
            tm, _, _ = icp(pred_pts, gt_pts, device=dev)
            r, t = tm[:3, :3], tm[:3, 3]
            pred_pts = (pred_pts @ r.T + t).astype(np.float32)
            pred = Mesh(vertices=(pred.vertices @ r.T + t).astype(np.float32),
                        faces=pred.faces)

        row = {"id": sid}
        if args.dir_gt_meshes:
            gt = load_obj(os.path.join(args.dir_gt_meshes, f"{sid}.obj"))
            gt_pts = sample_mesh_surface(gt.vertices, gt.faces, args.n_pts, seed=1)
            if args.icp_align:
                align_to(gt_pts)
            row.update(chamfer_metrics(pred_pts, gt_pts, args.f_threshold, device=dev))
            row["hausdorff"] = hausdorff_distance(pred_pts, gt_pts, device=dev)
            # IoU at uniform volume samples
            rng = np.random.default_rng(0)
            vol = rng.uniform(-0.5, 0.5, size=(args.n_pts, 3)).astype(np.float32)
            row["iou"] = occupancy_iou(points_inside_mesh(pred, vol),
                                       points_inside_mesh(gt, vol))
        else:
            sdf = np.load(os.path.join(root, "02_sdfs", f"{sid}.npy"))
            band = np.abs(sdf[:, 3]) < 0.01
            gt_pts = sdf[band, :3].astype(np.float32)
            if len(gt_pts) < 10:
                print(f"skip {sid}: no surface-band GT samples")
                continue
            if args.icp_align:
                align_to(gt_pts)
            row.update(chamfer_metrics(pred_pts, gt_pts, args.f_threshold, device=dev))
            occ_gt = sdf[:, 3] <= 0
            occ_pred = points_inside_mesh(pred, sdf[:, :3].astype(np.float32))
            row["iou"] = occupancy_iou(occ_pred, occ_gt)
        rows.append(row)
        print(row)

    summary = None
    if rows:
        keys = [k for k in rows[0] if k != "id"]
        summary = {k: float(np.mean([r[k] for r in rows])) for k in keys}
        summary["n"] = len(rows)
        print("MEAN:", json.dumps(summary))
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"per_shape": rows, "mean": summary}, f, indent=2)
    return summary
