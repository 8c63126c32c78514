"""GTSlice: 12 slice images -> an implicit SDF.

The reference ``Slices3DGTModel``: a VGG16-BN encoder (``img_encoder``,
blocks ``conv1_2 .. conv_last``) gives each slice a 5-level pyramid (1472
channels), query points are projected and sampled, and the 13-token head
(``pts_feat_extractor``, ``fc_local``, ``att_decoder``, ``fc_out``)
regresses the SDF.  Parameter names are the reference's, the ones
``torch_import.gtslice_model`` reads.  Public methods take and return the
JAX package's layouts: NHWC images and planes, (B, M, ...) point batches.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.projection import project_points
from .random_init import random_init_
from .sdf_head import SDFTransformerHead, pack_planes, relu_mlp, sample_packed_sum
from .vgg import REF_ENCODER_BLOCKS, VGG16BNBackbone

__all__ = ["GTSliceModel", "init_gtslice"]

C_LOCAL = 64 + 128 + 256 + 512 + 512


class GTSliceModel(SDFTransformerHead):
    """``dtype`` is the compute dtype (None: the input's); parameters stay
    fp32 and are cast at use."""

    def __init__(self, n_slices: int = 12, route: str = "fused",
                 dtype: Optional[torch.dtype] = None):
        pts_feat_extractor = relu_mlp(3, (32, 64, 128))
        fc_local = relu_mlp(C_LOCAL, (128, 128))
        super().__init__({"pts_feat_extractor": pts_feat_extractor, "fc_local": fc_local},
                         point_net=pts_feat_extractor, local_first=fc_local[0],
                         local_rest=fc_local[1:], route=route)
        self.n_slices = n_slices
        self.dtype = dtype
        self.img_encoder = VGG16BNBackbone(REF_ENCODER_BLOCKS)

    def encode(self, img_slices: torch.Tensor) -> List[torch.Tensor]:
        """img_slices (B, S, H, W, 3) -> pyramids [(B*S, h, w, c)]: 64@H,
        128@H/2, 256@H/4, 512@H/8, 512@H/16 (pre-BN taps)."""
        b, s, h, w, c = img_slices.shape
        x = img_slices.reshape(b * s, h, w, c).permute(0, 3, 1, 2)
        taps = self.img_encoder(x.to(self.dtype or x.dtype).contiguous())
        return [t.permute(0, 2, 3, 1) for t in taps]

    def encode_folded(self, img_slices: torch.Tensor) -> List[torch.Tensor]:
        """Encode, fold ``fc_local``'s first Linear into the planes and pack
        the slice axis: [(B, h, w, S*128)]."""
        packed = pack_planes(self.fold_pyramids(self.encode(img_slices)), self.n_slices)
        return [p.contiguous() for p in packed]

    def query_folded(self, packed, qry: torch.Tensor, trans_mat_tp: torch.Tensor,
                     obj_index: Optional[torch.Tensor] = None,
                     route: Optional[str] = None) -> torch.Tensor:
        """qry (b, M, 3) camera-aligned -> sdf (b, M) over folded planes;
        ``obj_index`` (b,) maps each query row to a plane set of the batch
        (default: row i to set i); ``route`` overrides the encoder layers'
        route for this call."""
        uv = project_points(qry, trans_mat_tp)
        sampled = sample_packed_sum(packed, uv, self.n_slices, obj_index=obj_index)
        return self.from_folded(qry, sampled, route)

    def query_presampled(self, qry: torch.Tensor, sampled: torch.Tensor) -> torch.Tensor:
        """Head only, on folded features sampled elsewhere (the lattice-slab
        path): qry (B, M, 3), sampled (B, M, S, d) -> sdf (B, M)."""
        return self.from_folded(qry, sampled)


def init_gtslice(seed: int = 0, generator: Optional[torch.Generator] = None, *,
                 n_slices: int = 12, route: str = "fused",
                 dtype: Optional[torch.dtype] = None) -> GTSliceModel:
    """A GTSlice with every weight and BatchNorm statistic drawn from
    ``generator`` (seeded with ``seed`` when not given; see
    ``random_init_``), in eval mode on the CPU."""
    g = generator if generator is not None else torch.Generator().manual_seed(seed)
    return random_init_(GTSliceModel(n_slices, route=route, dtype=dtype), g)
