"""Camera pose estimator: the port's ``slice3d_tpu/models/camnet.py``
(reference ``reg_slices/src/model_cam_est.py``).

VGG16-BN trunk -> 1024-d fc -> two branches: an ortho6d rotation head
(6d -> Gram-Schmidt rotation matrix) and a distance-ratio head
(sigmoid * 0.35 + 0.7).  The predicted inverse extrinsics are assembled with
the fixed Blender frame constants; the training loss is the MSE between a
point cloud moved by the predicted and by the ground-truth regression
matrices.  Parameter names are the reference's (``global_features.0.*`` with
torchvision's absolute indices, ``fc``, ``branch_ortho6d.{0,1,2}.0``,
``branch_dist.{0,1,2}.0``), the ones ``torch_import.camnet_model`` reads;
``fc`` takes the torch-flattened NCHW map, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear
from .random_init import random_init_
from .vgg import vgg16_bn_features

__all__ = ["CameraNet", "rotation_from_ortho6d", "camera_pose_loss", "init_camnet",
           "ROT_MAT_INV"]

CAM_MAX_DIST = 1.75
_R_OBJ2CAM_INV = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
_R_CAMFIX = np.diag(np.array([1.0, -1.0, -1.0], np.float32))
# canonical-frame inverse rotation (reference model_cam_est.py:140-143)
ROT_MAT_INV = np.array([[1.0, 0.0, 0.0, 0.0],
                        [0.0, 0.0, 1.0, 0.0],
                        [0.0, -1.0, 0.0, 0.0],
                        [0.0, 0.0, 0.0, 1.0]], np.float32)


def rotation_from_ortho6d(poses: torch.Tensor) -> torch.Tensor:
    """(B, 6) -> (B, 3, 3) by Gram-Schmidt (Zhou et al.'s continuous
    representation): columns x | y | z."""
    x_raw, y_raw = poses[:, :3], poses[:, 3:]

    def norm(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8)

    x = norm(x_raw)
    z = norm(torch.linalg.cross(x, y_raw, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def _branch(cin: int, widths: Sequence[int]) -> nn.Sequential:
    """The reference's branch layout: Sequential(Linear, ReLU) blocks, the
    last without the ReLU."""
    blocks = []
    for i, w in enumerate(widths):
        layers = [Linear(cin, w)] + ([nn.ReLU()] if i + 1 < len(widths) else [])
        blocks.append(nn.Sequential(*layers))
        cin = w
    return nn.Sequential(*blocks)


class CameraNet(nn.Module):
    """``img_size`` sets ``fc``'s input (512 x (img_size / 32)^2); ``dtype``
    is the compute dtype (None: the input's); parameters stay fp32."""

    def __init__(self, img_size: int = 128, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        side = img_size // 32
        self.global_features = nn.Sequential(vgg16_bn_features())
        self.fc = Linear(512 * side * side, 1024)
        self.branch_ortho6d = _branch(1024, (512, 256, 6))
        self.branch_dist = _branch(1024, (128, 64, 1))

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """img (B, H, W, 3) NHWC -> the predicted inverse extrinsics:
        ``pred_rotation_mat_inv`` (B, 3, 3), ``distance_ratio`` (B,) and
        ``pred_RT_inv`` (B, 4, 3), all fp32."""
        x = img.permute(0, 3, 1, 2)
        x = x.to(self.dtype or x.dtype).contiguous()
        final = self.global_features(x)
        b = final.shape[0]
        feat = F.relu(self.fc(final.reshape(b, -1)))
        rot_inv = rotation_from_ortho6d(self.branch_ortho6d(feat).to(torch.float32))
        distance_ratio = torch.sigmoid(self.branch_dist(feat).to(torch.float32)) * 0.35 + 0.7
        cam_loc = torch.cat([distance_ratio * CAM_MAX_DIST,
                             torch.zeros((b, 2), device=feat.device)], dim=-1)[:, None, :]
        trans_inv = -(cam_loc @ torch.from_numpy(_R_OBJ2CAM_INV).to(feat.device)
                      @ torch.from_numpy(_R_CAMFIX.T.copy()).to(feat.device))
        return {"pred_rotation_mat_inv": rot_inv, "distance_ratio": distance_ratio[..., 0],
                "pred_RT_inv": torch.cat([rot_inv, trans_inv], dim=1)}


def camera_pose_loss(pred_rt_inv: torch.Tensor, pcd: torch.Tensor, regress_mat: torch.Tensor,
                     norm_mat_inv: torch.Tensor, k: torch.Tensor):
    """Point-cloud alignment MSE and the predicted projection matrix
    (reference get_loss, model_cam_est.py:133-173)."""
    b, n, _ = pcd.shape
    homo = torch.cat([pcd, torch.ones((b, n, 1), dtype=pcd.dtype, device=pcd.device)], dim=-1)
    rot = torch.from_numpy(ROT_MAT_INV).to(pcd.device, pcd.dtype)
    pred_regress = norm_mat_inv @ rot[None] @ pred_rt_inv  # (B, 4, 3)
    diff = homo @ pred_regress - homo @ regress_mat
    loss = torch.mean(diff ** 2)
    pred_trans_mat = (k @ pred_regress.transpose(1, 2)).transpose(1, 2)
    return loss, pred_trans_mat


def init_camnet(seed: int = 0, generator: Optional[torch.Generator] = None, *,
                img_size: int = 128, dtype: Optional[torch.dtype] = None) -> CameraNet:
    """A CameraNet with every weight and BatchNorm statistic drawn from
    ``generator`` (seeded with ``seed`` when not given; see
    ``random_init_``), in eval mode on the CPU."""
    g = generator if generator is not None else torch.Generator().manual_seed(seed)
    return random_init_(CameraNet(img_size, dtype=dtype), g)
