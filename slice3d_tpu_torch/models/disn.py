"""DISN baseline: single-view implicit SDF from local and global image
features, the port's ``slice3d_tpu/models/disn.py`` (reference
``reg_slices/src/model_disn.py``).

A VGG16-BN trunk (``img_encoder``, blocks ``conv1_2 .. conv_last``) gives a
5-level pre-BN pyramid (1472 channels), sampled at each query's projection,
and a global feature: the /32 map, average-pooled to 4x4 by the JAX rule
(window = stride = h // 4, only when the map is not 4x4 already), flattened
in torch's NCHW order and passed through the reference's dropout MLP
(``img_encoder.classifier``, Linears at 0, 3, 6; dropout is off at
inference).  A 3 -> 64 -> 256 -> 512 point MLP feeds two heads whose
outputs sum to the SDF.  ``global_dim`` is 128, the configuration the
reference's encoder can run (see the JAX module).

DISN rotates the queries by the camera rotation for its point MLP and
projects the unrotated queries with the full camera matrix
(``trans_mat_right``); it has no folded planes.  Public methods take and
return the JAX package's layouts: NHWC images and planes, (B, M, ...) point
batches.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.projection import project_points
from .layers import Linear
from .random_init import random_init_
from .sdf_head import relu_mlp, sample_slice_pyramids
from .vgg import REF_ENCODER_BLOCKS, VGG16BNBackbone

__all__ = ["DISNModel", "init_disn", "global_pool_side"]

C_LOCAL = 64 + 128 + 256 + 512 + 512


def global_pool_side(img_size: int) -> int:
    """Side of the pooled global map for an ``img_size`` input: the /32 map
    as it is when 4x4, else pooled with window = stride = max(h // 4, 1)."""
    h = img_size // 32
    return h if h == 4 else h // max(h // 4, 1)


class DISNModel(nn.Module):
    """``img_size`` sets the global head's input (512 x side^2, see
    ``global_pool_side``); ``dtype`` is the compute dtype (None: the
    input's); parameters stay fp32 and are cast at use."""

    def __init__(self, global_dim: int = 128, img_size: int = 128,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        side = global_pool_side(img_size)
        self.img_encoder = VGG16BNBackbone(REF_ENCODER_BLOCKS, with_final=True)
        self.img_encoder.classifier = nn.Sequential(
            Linear(512 * side * side, 1024), nn.ReLU(), nn.Dropout(),
            Linear(1024, 1024), nn.ReLU(), nn.Dropout(), Linear(1024, global_dim))
        self.pts_feat_extractor = relu_mlp(3, (64, 256, 512))
        self.fc_local = relu_mlp(C_LOCAL + 512, (512, 256, 1), relu_last=False)
        self.fc_global = relu_mlp(global_dim + 512, (512, 256, 1), relu_last=False)

    def encode(self, img_input: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """img_input (B, H, W, 3) -> (pyramids [(B, h, w, c)], global (B, D))."""
        x = img_input.permute(0, 3, 1, 2)
        taps, final = self.img_encoder(x.to(self.dtype or x.dtype).contiguous())
        h, w = final.shape[2:]
        if (h, w) != (4, 4):
            kh, kw = max(h // 4, 1), max(w // 4, 1)
            final = F.avg_pool2d(final, (kh, kw), (kh, kw))
        feat_global = self.img_encoder.classifier(final.reshape(final.shape[0], -1))
        return [t.permute(0, 2, 3, 1) for t in taps], feat_global

    def query(self, pyramids, feat_global: torch.Tensor, qry_rot: torch.Tensor,
              qry_norot: torch.Tensor, trans_mat_right: torch.Tensor) -> torch.Tensor:
        """qry_rot / qry_norot (B, M, 3), trans_mat_right (B, 4, 3) -> fp32
        sdf (B, M)."""
        uv = project_points(qry_norot, trans_mat_right)
        local = sample_slice_pyramids(pyramids, uv, n_slices=1)[:, :, 0, :]
        feat_qry = self.pts_feat_extractor(qry_rot.to(local.dtype))
        g = feat_global[:, None, :].expand(-1, qry_rot.shape[1], -1)
        sdf = (self.fc_local(torch.cat([local, feat_qry], dim=-1))
               + self.fc_global(torch.cat([g, feat_qry], dim=-1)))
        return sdf[..., 0].to(torch.float32)

    def forward(self, img_input: torch.Tensor, qry_norot: torch.Tensor,
                trans_mat_right: torch.Tensor, obj_rot_mat: torch.Tensor) -> torch.Tensor:
        qry_rot = torch.einsum("bmi,bij->bmj", qry_norot, obj_rot_mat)
        pyramids, feat_global = self.encode(img_input)
        return self.query(pyramids, feat_global, qry_rot, qry_norot, trans_mat_right)


def init_disn(seed: int = 0, generator: Optional[torch.Generator] = None, *,
              img_size: int = 128, dtype: Optional[torch.dtype] = None) -> DISNModel:
    """A DISN with every weight and BatchNorm statistic drawn from
    ``generator`` (seeded with ``seed`` when not given; see
    ``random_init_``), in eval mode on the CPU."""
    g = generator if generator is not None else torch.Generator().manual_seed(seed)
    return random_init_(DISNModel(img_size=img_size, dtype=dtype), g)
