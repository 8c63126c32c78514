"""SliceNet: one input view -> 12 slices + an implicit SDF.

The slice U-Net gives the reconstructed slice images and the 992-channel
pyramid sampled at projected query points; the 13-token transformer head
regresses the SDF.  Parameter names follow the reference ``Slices3DRegModel``
``state_dict`` (``slices_generator.*``, ``fc_p``, ``fc_s``, ``att_decoder``,
``fc_out``).  Public methods take and return the JAX package's layouts:
NHWC images and planes, (B, M, ...) point batches.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..ops.projection import project_points
from .layers import Linear, TransformerEncoderLayer
from .sdf_head import SDFTransformerHead, pack_planes, prepare_queries, sample_packed_sum
from .unet_slices import SliceUNet

__all__ = ["SliceNetModel", "init_slicenet"]


class SliceNetModel(SDFTransformerHead):
    """``dtype`` is the compute dtype (None: the input's); parameters stay
    fp32 and are cast at use."""

    def __init__(self, n_slices: int = 12, route: str = "fused",
                 dtype: Optional[torch.dtype] = None):
        fc_p, fc_s = Linear(3, 128), Linear(992, 128)
        super().__init__({"fc_p": fc_p, "fc_s": fc_s}, point_net=fc_p, local_first=fc_s,
                         local_rest=nn.Identity(), route=route)
        self.n_slices = n_slices
        self.dtype = dtype
        self.slices_generator = SliceUNet(n_slices)

    def encode(self, img_input: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """img_input (B, H, W, 3) -> (pyramids [(B*S, h, w, c)],
        slices_rec (B*S, H, W, 3))."""
        x = img_input.permute(0, 3, 1, 2)
        x = x.to(self.dtype or x.dtype).contiguous()
        feats, slices = self.slices_generator(x)
        nhwc = [f.permute(0, 2, 3, 1) for f in feats]
        return nhwc, slices.permute(0, 2, 3, 1)

    def forward(self, img_input: torch.Tensor, qry_norot: torch.Tensor,
                trans_mat_tp: torch.Tensor, obj_rot_mat: Optional[torch.Tensor] = None, *,
                test_mode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training entry: (sdf (B, M) fp32, slices_rec (B*S, H, W, 3))."""
        qry = prepare_queries(qry_norot, obj_rot_mat, test_mode=test_mode)
        pyramids, slices_rec = self.encode(img_input)
        return self.query(pyramids, qry, trans_mat_tp), slices_rec

    def encode_folded(self, img_input: torch.Tensor):
        """Encode, fold ``fc_s`` into the planes, pack the slice axis.
        Returns (packed [(B, h, w, S*128)], slices_rec)."""
        pyramids, slices_rec = self.encode(img_input)
        packed = pack_planes(self.fold_pyramids(pyramids), self.n_slices)
        return [p.contiguous() for p in packed], slices_rec

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


@torch.no_grad()
def init_slicenet(seed: int = 0, generator: Optional[torch.Generator] = None, *,
                  n_slices: int = 12, route: str = "fused",
                  dtype: Optional[torch.dtype] = None) -> SliceNetModel:
    """A SliceNet with random weights drawn from ``generator`` (seeded with
    ``seed`` when not given), in eval mode on the CPU.

    torch's default schemes: U(+-1/sqrt(fan_in)) for conv/linear weights and
    biases, N(0, 1) embeddings, Xavier-uniform attention input projection
    with zero biases; BatchNorm and LayerNorm keep their identity init.
    """
    g = generator if generator is not None else torch.Generator().manual_seed(seed)
    model = SliceNetModel(n_slices, route=route, dtype=dtype)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            bound = 1.0 / math.sqrt(w.shape[1] * w[0][0].numel())
            w.uniform_(-bound, bound, generator=g)
            if mod.bias is not None:
                mod.bias.uniform_(-bound, bound, generator=g)
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(generator=g)
        elif isinstance(mod, TransformerEncoderLayer):
            w = mod.self_attn.in_proj_weight
            bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            w.uniform_(-bound, bound, generator=g)
    for mod in model.modules():
        if isinstance(mod, TransformerEncoderLayer):
            mod.self_attn.in_proj_bias.zero_()
            mod.self_attn.out_proj.bias.zero_()
    return model.eval()
