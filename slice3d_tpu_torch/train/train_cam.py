"""Training of the camera-pose estimator of ``reconstruct --est_campose``
(the JAX package's ``slice3d_tpu/train/train_cam.py``).

The reference's own trainer is dead code (reg_slices/src/
train_cam_est_disn.py imports modules that do not exist, and its dataset
has hard-coded local paths), so both packages train the working equivalent
over the standard dataset layout: the point cloud is the near-surface band
of the ``02_sdfs`` samples, and the ground-truth regression matrix comes
from the recorded camera chain.  CameraNet runs its BatchNorms on batch
statistics, Adam (b1 0.9, b2 0.999, eps 1e-8) at a constant LR minimises
``camera_pose_loss``, and checkpoints (the model's state_dict under
``"model"``) go to ``<dir_experiments>/<name_exp_cam>/ckpt``, where
``models/build.py::load_camnet`` reads them.  In a process group the step is
data-parallel as ``train_reg``'s: loader shards, global BatchNorm
statistics, gradients and the loss averaged over the group, rank 0 writing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .. import camera, resolve_device
from ..config import Options
from ..data.dataset import Slice3DDataset
from ..data.pipeline import BatchLoader
from ..models.camnet import CameraNet, camera_pose_loss, init_camnet
from ..parallel import all_reduce_gradients, all_reduce_mean, is_main_process
from .checkpoint import save_checkpoint
from .train_reg import reset_batchnorm_statistics

__all__ = ["CamEstDataset", "CamTrainState", "CamTrainer"]


@dataclass
class CamEstDataset:
    """Pose-estimation samples from the Slice3D layout: the input view, 2,048
    near-surface points, the regression matrix, an identity normalisation
    and the unit intrinsics."""

    root: str
    split: str = "train"
    img_size: int = 128
    n_views: int = 12
    n_pcd: int = 2048
    use_white_bg: bool = False

    def __post_init__(self):
        self._ds = Slice3DDataset(self.root, split=self.split, img_size=self.img_size,
                                  n_views=self.n_views, use_white_bg=self.use_white_bg,
                                  load_slices=False, load_sdf=False)

    def __len__(self) -> int:
        return len(self._ds)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        _, shape_id = self._ds.files[index]
        view = self._ds.view_index()
        img = self._ds.load_input_view(shape_id, view)
        _, _, scale, offset = self._ds.load_camera(shape_id, view)
        pts, vals = self._ds.load_sdf_samples(shape_id, scale, offset)
        pcd = pts[np.argsort(np.abs(vals))[:self.n_pcd]]
        if len(pcd) < self.n_pcd:
            reps = int(np.ceil(self.n_pcd / max(len(pcd), 1)))
            pcd = np.tile(pcd, (reps, 1))[:self.n_pcd]
        # the regression matrix: the transpose of RT @ the canonical rotation
        meta = self._ds.load_meta(shape_id)
        rt = camera.blender_rt(-meta[1][view], meta[2][view], meta[3][view])
        regress_mat = (rt @ camera.canonical_rot4()).T  # (4, 3)
        return {"img_input": img.astype(np.float32), "pcd": pcd.astype(np.float32),
                "regress_mat": regress_mat.astype(np.float32),
                "norm_mat": np.eye(4, dtype=np.float32),
                "K": camera.intrinsics(1.0, 1.0).astype(np.float32)}


@dataclass
class CamTrainState:
    model: CameraNet
    optimizer: torch.optim.Adam
    step: int = 0


class CamTrainer:
    """CameraNet at ``img_size`` under Adam at ``lr``; runs on CUDA unless
    ``device`` says otherwise."""

    def __init__(self, lr: float = 3e-4, *, img_size: int = 128,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.lr = lr
        self.img_size = img_size

    def init_state(self, seed: int = 0) -> CamTrainState:
        """A CameraNet drawn from ``seed`` (BatchNorm statistics at 0 / 1) on
        the trainer's device, with Adam over every parameter."""
        model = reset_batchnorm_statistics(init_camnet(seed, img_size=self.img_size))
        model = model.to(self.device)
        optimizer = torch.optim.Adam(list(model.parameters()), lr=self.lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        return CamTrainState(model=model, optimizer=optimizer)

    def train_step(self, state: CamTrainState, batch: Mapping[str, Any]
                   ) -> Tuple[CamTrainState, torch.Tensor]:
        """One update (in place); returns (state, the loss as a 0-d tensor,
        the group's mean).  Each parameter's ``.grad`` keeps the applied
        gradient (averaged over the group) until the next step."""
        t = {k: torch.as_tensor(batch[k]).to(self.device, torch.float32)
             for k in ("img_input", "pcd", "regress_mat", "norm_mat", "K")}
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = model(t["img_input"])
        loss, _ = camera_pose_loss(out["pred_RT_inv"], t["pcd"], t["regress_mat"],
                                   t["norm_mat"], t["K"])
        loss.backward()
        all_reduce_gradients(state.model.parameters())
        state.optimizer.step()
        state.step += 1
        return state, all_reduce_mean({"loss": loss.detach()})["loss"]

    def save(self, state: CamTrainState, dir_ckpt: str, epoch: int, loss: float) -> str:
        return save_checkpoint(os.path.join(dir_ckpt, f"{epoch}_{state.step}_{loss:.4}.ckpt"),
                               {"model": state.model.state_dict()})

    def train(self, opts: Options) -> CamTrainState:
        """The run of root ``train_cam.py``: ``n_epochs`` over the train split,
        a log line every ``freq_log`` steps, a checkpoint every ``freq_ckpt``
        epochs."""
        ds = CamEstDataset(opts.dataset_root, split="train", img_size=opts.img_size,
                           n_views=opts.n_views, use_white_bg=opts.use_white_bg)
        loader = BatchLoader(ds, opts.n_bs, shuffle=True, num_workers=opts.n_wk)
        state = self.init_state()
        dir_ckpt = os.path.join(opts.dir_experiments, opts.name_exp_cam, "ckpt")
        loss = float("nan")
        for epoch in range(opts.n_epochs):
            for batch in loader:
                state, loss_t = self.train_step(state, batch)
                loss = float(loss_t)
                if is_main_process() and state.step % opts.freq_log == 0:
                    print(f"[cam] epoch {epoch} step {state.step} loss {loss:.3e}")
            if is_main_process() and epoch % opts.freq_ckpt == 0:
                print(f"saved {self.save(state, dir_ckpt, epoch, loss)}")
        return state
