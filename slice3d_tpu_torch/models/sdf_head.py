"""Implicit-SDF decoding: sample the folded slice planes, attend, regress.

A query-point token and 12 slice tokens (a local transform of the
bilinearly sampled pyramid) pass a 3-layer, 13-token post-LN transformer;
``fc_out`` reads token 0.  Each model hands the head its own transforms:

  * SliceNet: ``fc_p`` (Linear 3 -> 128) and ``fc_s`` (Linear 992 -> 128);
  * GTSlice: ``pts_feat_extractor`` (3 -> 32 -> 64 -> 128, ReLU after each)
    and ``fc_local`` (1472 -> 128 -> ReLU -> 128 -> ReLU).

Fast inference path: the first local Linear commutes with bilinear
sampling.  :meth:`SDFTransformerHead.fold_pyramids` pre-multiplies each
pyramid level by its slice of that Linear once per object,
:func:`pack_planes` puts the 12 slices of a pixel in one row,
:func:`sample_packed_sum` samples and sums the 128-wide folded levels per
point, and the rest of the local transform runs after sampling.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import torch
from torch import nn

from ..ops.grid_sample import grid_sample_2d
from ..ops.hat_sample import hat_sample_sum
from .layers import Linear, TransformerEncoder

__all__ = ["pack_planes", "sample_packed_sum", "sample_slice_pyramids", "relu_mlp",
           "SDFTransformerHead"]

# levels with h * w at most this many rows sample through the hat matmul,
# larger ones through four row gathers
HAT_MAX_ROWS = 1024


def pack_planes(planes: Sequence[torch.Tensor], n_slices: int) -> List[torch.Tensor]:
    """(B*S, h, w, d) planes -> [(B, h, w, S*d)]: one row carries every
    slice's features of a pixel."""
    packed = []
    for p in planes:
        bs, h, w, d = p.shape
        q = p.reshape(bs // n_slices, n_slices, h, w, d).permute(0, 2, 3, 1, 4)
        packed.append(q.reshape(bs // n_slices, h, w, n_slices * d))
    return packed


def sample_packed_sum(packed: Sequence[torch.Tensor], uv: torch.Tensor, n_slices: int,
                      obj_index: Optional[torch.Tensor] = None,
                      hat_max_rows: int = HAT_MAX_ROWS) -> torch.Tensor:
    """Bilinearly sample packed planes [(B, h, w, S*d)] at uv (b, M, 2) in
    [-1, 1] (align_corners=True, zero padding) and sum the levels.
    Returns (b, M, S, d).

    ``obj_index`` (b,) int64 selects the plane set each uv row samples
    (default: row i samples set i, b == B); the batched pipeline walks one
    object's chunk at a time against the stacked planes of its batch.  The
    gather levels fold the selection into the flat row index, so no plane is
    copied."""
    b, m, _ = uv.shape
    x = uv[..., 0].to(torch.float32)
    y = uv[..., 1].to(torch.float32)
    total, rest = hat_sample_sum(packed, uv, obj_index=obj_index, max_rows=hat_max_rows)
    sel = torch.arange(b, device=uv.device) if obj_index is None else obj_index
    for plane in rest:
        bp, h, w, sd = plane.shape
        flat_plane = plane.reshape(bp * h * w, sd)
        base = (sel * (h * w))[:, None]
        px = (x + 1.0) * 0.5 * (w - 1)
        py = (y + 1.0) * 0.5 * (h - 1)
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        wx = (px - x0).to(plane.dtype)
        wy = (py - y0).to(plane.dtype)
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)

        def corner(xi, yi, weight):
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            weight = torch.where(valid, weight, torch.zeros_like(weight))
            flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1) + base
            rows = flat_plane.index_select(0, flat.reshape(-1)).reshape(b, m, sd)
            return rows * weight[..., None]

        s = (corner(x0i, y0i, (1 - wx) * (1 - wy))
             + corner(x0i + 1, y0i, wx * (1 - wy))
             + corner(x0i, y0i + 1, (1 - wx) * wy)
             + corner(x0i + 1, y0i + 1, wx * wy))
        total = s if total is None else total + s
    return total.reshape(b, m, n_slices, -1)


def sample_slice_pyramids(pyramids: Sequence[torch.Tensor], uv: torch.Tensor,
                          n_slices: int) -> torch.Tensor:
    """Sample every level of every slice's (unfolded) pyramid at uv:
    pyramids [(B*S, h, w, c_l)], uv (B, M, 2) -> (B, M, S, sum(c_l))."""
    b, m, _ = uv.shape
    uv_tiled = uv.repeat_interleave(n_slices, dim=0)  # (B*S, M, 2)
    feat = torch.cat([grid_sample_2d(p, uv_tiled) for p in pyramids], dim=-1)
    return feat.reshape(b, n_slices, m, feat.shape[-1]).transpose(1, 2)


def relu_mlp(cin: int, widths: Sequence[int], relu_last: bool = True) -> nn.Sequential:
    """Linear -> ReLU per width (Linears at indices 0, 2, 4, ...), without
    the last ReLU unless ``relu_last``: the JAX package's ``MLP`` under the
    reference's ``nn.Sequential`` names."""
    layers: List[nn.Module] = []
    for i, w in enumerate(widths):
        layers.append(Linear(cin, w))
        if relu_last or i + 1 < len(widths):
            layers.append(nn.ReLU())
        cin = w
    return nn.Sequential(*layers)


class SDFTransformerHead(nn.Module):
    """The token head: [query token; slice tokens] -> SDF.

    The model builds its own point and local transforms and hands them over:
    ``nets`` maps the reference's names to those modules (registered first,
    in that order, at the top of the model's ``state_dict``); ``point_net``
    embeds the query point, ``local_first`` is the local transform's first
    Linear (folded into the planes) and ``local_rest`` the rest of it, run
    after sampling.  ``route`` is the encoder layers' route (``"fused"``,
    ``"split"`` or ``"plain"``, see ``layers.TransformerEncoderLayer``).
    """

    def __init__(self, nets: Mapping[str, nn.Module], point_net: nn.Module,
                 local_first: nn.Linear, local_rest: nn.Module, d_model: int = 128,
                 n_layers: int = 3, n_heads: int = 4, route: str = "fused"):
        super().__init__()
        for name, net in nets.items():
            self.add_module(name, net)
        self.att_decoder = TransformerEncoder(n_layers, d_model, n_heads,
                                              final_head_tokens=1, route=route)
        self.fc_out = nn.Sequential(Linear(d_model, 1))
        # the roles, kept out of the module tree: their parameters are
        # registered above under the reference's names
        object.__setattr__(self, "point_net", point_net)
        object.__setattr__(self, "local_first", local_first)
        object.__setattr__(self, "local_rest", local_rest)

    def fold_pyramids(self, pyramids: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """(N, h, w, c_l) levels -> (N, h, w, d_model), each multiplied by its
        slice of the first local Linear.  The bias rides on the first level
        only, so the sum of the sampled levels is that Linear applied to
        ``concat(levels)`` (projected coords are clamped in range, so each
        point's bilinear weights sum to 1)."""
        outs = []
        offset = 0
        for i, p in enumerate(pyramids):
            c = p.shape[-1]
            w_slice = self.local_first.weight[:, offset:offset + c].to(p.dtype)
            folded = torch.matmul(p, w_slice.t())
            if i == 0:
                folded = folded + self.local_first.bias.to(p.dtype)
            outs.append(folded)
            offset += c
        return outs

    def from_folded(self, qry: torch.Tensor, sampled_sum: torch.Tensor,
                    route: Optional[str] = None) -> torch.Tensor:
        """qry (B, M, 3) camera-aligned; sampled_sum (B, M, S, d) summed
        folded samples (== the first local Linear of the sampled pyramid).
        Returns fp32 sdf (B, M); the head computes in sampled_sum's dtype.
        ``route`` overrides the encoder layers' route for this call."""
        feat_q = self.point_net(qry.to(sampled_sum.dtype))
        tokens = torch.cat([feat_q[:, :, None, :], self.local_rest(sampled_sum)], dim=2)
        tokens = self.att_decoder(tokens, route)
        return self.fc_out(tokens[:, :, 0, :])[..., 0].to(torch.float32)
