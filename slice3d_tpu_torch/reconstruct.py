"""Reconstruct meshes for a test split on the card (the port's ``reconstruct.py``).

    python -m slice3d_tpu_torch.reconstruct --name_model slicenet \\
        --name_dataset custom_sin_img --mode test --random_init [--device cpu]
    python -m slice3d_tpu_torch.reconstruct --name_model gtslice \\
        --name_dataset objaverse --name_exp my_exp --name_ckpt model.ckpt \\
        --mode test --from_which_slices gt --mc_batch_size 4

Takes the JAX package's root ``reconstruct.py`` flags (``config.Options``)
plus ``--device`` (default ``cuda``), and writes the same layout:
``experiments/<exp>/results/<dataset>/<shape_id>.obj``.  Objects run through
``Reconstructor.reconstruct_all`` in batches of ``--mc_batch_size``, marching
one batch on host threads while the next evaluates.  Options whose machinery
is not ported raise (``config.require_ported``).
"""

from __future__ import annotations

import argparse
import os
import time

from .config import options_from_args, require_ported
from .data.dataset import Slice3DDataset
from .mesh import export_obj
from .models.build import load_model
from .pipeline import Reconstructor

__all__ = ["main"]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    own, rest = parser.parse_known_args(argv)
    opts = options_from_args(rest)
    require_ported(opts)

    # the split follows --mode as in the reference CLI; train-mode
    # invocations still reconstruct the test split
    split = opts.mode if opts.mode in ("val", "test", "trainval") else "test"
    dataset = Slice3DDataset(
        opts.dataset_root, split=split, img_size=opts.img_size, n_qry=opts.n_qry,
        n_views=opts.n_views, from_which_slices=opts.from_which_slices,
        use_white_bg=opts.use_white_bg, load_slices=(opts.name_model == "gtslice"),
        load_sdf=False, categories=opts.categories)

    ckpt_path = os.path.join(opts.exp_dir, "ckpt", opts.name_ckpt) if opts.name_ckpt else None
    recon = Reconstructor(load_model(opts, ckpt_path), resolution0=opts.mc_res0,
                          upsampling_steps=opts.mc_up_steps, threshold=opts.mc_threshold,
                          chunk_size=opts.mc_chunk_size, batch_size=max(opts.mc_batch_size, 1),
                          device=own.device)

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

    t_start = time.perf_counter()

    def on_result(j, mesh, stats):
        _, shape_id, path_mesh = todo[j]
        export_obj(mesh, path_mesh)
        print(f"[{j + 1}/{len(todo)}] {shape_id}: {len(mesh.vertices)} verts, "
              f"{len(mesh.faces)} faces (eval {stats['time_eval_points']:.2f}s over "
              f"{stats['n_points_evaluated']} pts, mc {stats['time_marching']:.2f}s)")

    recon.reconstruct_all((dataset[idx] for idx, _, _ in todo), on_result)
    total = time.perf_counter() - t_start
    print(f"{len(todo)} objects in {total:.2f}s "
          f"({60.0 * len(todo) / max(total, 1e-9):.1f} objects/min)")


if __name__ == "__main__":
    main()
