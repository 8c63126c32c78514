"""Reconstruct meshes for a test split on the card (the port's ``reconstruct.py``).

    python -m slice3d_tpu_torch.reconstruct --name_model slicenet \\
        --name_dataset custom_sin_img --mode test --random_init [--device cpu]
    python -m slice3d_tpu_torch.reconstruct --name_model gtslice \\
        --name_dataset objaverse --name_exp my_exp --name_ckpt model.ckpt \\
        --mode test --from_which_slices gt --mc_batch_size 4
    python -m slice3d_tpu_torch.reconstruct --name_model disn --est_campose \\
        --name_exp_cam cam_exp --name_ckpt_cam cam.ckpt --mc_refine_steps 30 \\
        --simplify_nfaces 20000 --mc_extract tetrahedra ...

Takes the JAX package's root ``reconstruct.py`` flags (``config.Options``)
plus ``--device`` (default ``cuda``), and writes the same layout:
``experiments/<exp>/results/<dataset>/<shape_id>.obj``.  Objects run through
``Reconstructor.reconstruct_all`` in batches of ``--mc_batch_size``, marching
one batch on host threads while the next evaluates.  On more than one card
the batch (``--mc_shard_axis batch``, when it divides) or each head call's
points (``--mc_shard_axis points``) shard over the cards
(``parallel.reconstruction_mesh``); ``--multi_gpu`` is accepted, as the
sharding is automatic.  ``--est_campose``
replaces each feed's ``obj_rot_mat`` and ``trans_mat_right`` with CameraNet's
estimate (DISN reads them; SliceNet and GTSlice project with
``trans_mat_wo_rot_tp`` and keep their answer).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict

import numpy as np
import torch

from . import camera, resolve_device
from .config import Options, options_from_args
from .data.dataset import Slice3DDataset
from .mesh import export_obj
from .models.build import load_camnet, load_model
from .models.camnet import ROT_MAT_INV
from .parallel import device_count, reconstruction_mesh
from .pipeline import Reconstructor

__all__ = ["campose_predictor", "main"]

Feed = Dict[str, np.ndarray]


def campose_predictor(opts: Options, device=None) -> Callable[[Feed], Feed]:
    """The estimated-camera-pose step (the JAX CLI's, reference
    reconstruct.py:390-406): CameraNet predicts the inverse rotation; the
    reference's sign fixes and row swap map it into the dataset's
    ``obj_rot_mat`` convention, and the predicted full projection
    ``(K @ (ROT_MAT_INV @ pred_RT_inv).T).T`` with unit intrinsics
    replaces ``trans_mat_right``."""
    dev = resolve_device(device)
    model = load_camnet(opts).to(dev)
    k = camera.intrinsics(1.0, 1.0).astype(np.float32)

    def apply(feed: Feed) -> Feed:
        with torch.no_grad():
            out = model(torch.from_numpy(np.asarray(feed["img_input"], np.float32)[None])
                        .to(dev))
        rot = out["pred_rotation_mat_inv"][0].cpu().numpy().copy()
        rot[0, 1] *= -1.0
        rot[0, 2] *= -1.0
        rot[2, 1] *= -1.0
        rot[2, 2] *= -1.0
        rot[1, 0] *= -1.0
        rot[[1, 2]] = rot[[2, 1]]
        feed["obj_rot_mat"] = rot.astype(np.float32)
        pred_regress = ROT_MAT_INV @ out["pred_RT_inv"][0].cpu().numpy()  # norm_mat = I
        feed["trans_mat_right"] = (k @ pred_regress.T).T.astype(np.float32)
        return feed

    return apply


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    own, rest = parser.parse_known_args(argv)
    opts = options_from_args(rest)

    # the split follows --mode as in the reference CLI; train-mode
    # invocations still reconstruct the test split
    split = opts.mode if opts.mode in ("val", "test", "trainval") else "test"
    dataset = Slice3DDataset(
        opts.dataset_root, split=split, img_size=opts.img_size, n_qry=opts.n_qry,
        n_views=opts.n_views, from_which_slices=opts.from_which_slices,
        use_white_bg=opts.use_white_bg, load_slices=(opts.name_model == "gtslice"),
        load_sdf=False, load_full_projection=(opts.name_model == "disn"),
        categories=opts.categories)

    ckpt_path = os.path.join(opts.exp_dir, "ckpt", opts.name_ckpt) if opts.name_ckpt else None
    batch = max(opts.mc_batch_size, 1)
    mesh = reconstruction_mesh(opts.mc_shard_axis, batch, opts.mc_chunk_size,
                               device_count(own.device))
    recon = Reconstructor(load_model(opts, ckpt_path), resolution0=opts.mc_res0,
                          upsampling_steps=opts.mc_up_steps, threshold=opts.mc_threshold,
                          chunk_size=opts.mc_chunk_size, batch_size=batch,
                          simplify_nfaces=opts.simplify_nfaces,
                          refine_steps=opts.mc_refine_steps, extract_method=opts.mc_extract,
                          device=own.device, mesh=mesh, shard_axis=opts.mc_shard_axis)
    cam_predict = campose_predictor(opts, own.device) if opts.est_campose else None

    out_dir = os.path.join(opts.exp_dir, "results", opts.name_dataset)
    os.makedirs(out_dir, exist_ok=True)
    todo = []
    for idx in range(len(dataset)):
        _, shape_id = dataset.files[idx]
        path_mesh = os.path.join(out_dir, f"{shape_id}.obj")
        if os.path.exists(path_mesh) and not opts.overwrite_res:
            continue
        todo.append((idx, shape_id, path_mesh))
    if not todo:
        print("all result meshes exist (use --overwrite_res to redo)")
        return

    def feeds():
        for idx, _, _ in todo:
            feed = dataset[idx]
            yield cam_predict(feed) if cam_predict is not None else feed

    t_start = time.perf_counter()

    def on_result(j, mesh, stats):
        _, shape_id, path_mesh = todo[j]
        export_obj(mesh, path_mesh)
        polish = (f", refine {stats['time_refine']:.2f}s, loss {stats['refine_loss_first']:.6g}"
                  f" -> {stats['refine_loss_last']:.6g}" if "time_refine" in stats else "")
        print(f"[{j + 1}/{len(todo)}] {shape_id}: {len(mesh.vertices)} verts, "
              f"{len(mesh.faces)} faces (eval {stats['time_eval_points']:.2f}s over "
              f"{stats['n_points_evaluated']} pts, mc {stats['time_marching']:.2f}s{polish})")

    recon.reconstruct_all(feeds(), on_result)
    total = time.perf_counter() - t_start
    print(f"{len(todo)} objects in {total:.2f}s "
          f"({60.0 * len(todo) / max(total, 1e-9):.1f} objects/min)")


if __name__ == "__main__":
    main()
