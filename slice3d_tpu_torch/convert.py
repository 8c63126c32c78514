"""Flax variables (numpy trees) -> the port's SliceNet ``state_dict``.

The inverse of the JAX package's checkpoint importer for SliceNet: a
variables tree as ``init_variables`` or the torch importer produces it
(``{"params": ..., "batch_stats": ...}`` with numpy or array leaves) becomes
a ``state_dict`` under the reference torch names, which
``SliceNetModel.load_state_dict`` takes as it is.

Layout rules: conv HWIO -> OIHW; Dense (in, out) -> (out, in); ConvTranspose
(kH, kW, O, I) -> (I, O, kH, kW); the fused ``qkv`` kernel transposed is
``in_proj_weight``; BatchNorm ``mean``/``var`` -> ``running_mean``/
``running_var``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["slicenet_state_dict"]

# (conv index, conv block, conv child, bn block, bn child) of the reference's
# sliced VGG16-BN: blocks are features[:4] [4:11] [11:21] [21:31] [31:41]
# [41:44], and slicing keeps torchvision's absolute child indices.
_REF_VGG_SLICES = [
    (0, 0, 0, 0, 1), (1, 0, 3, 1, 4), (2, 1, 7, 1, 8), (3, 1, 10, 2, 11),
    (4, 2, 14, 2, 15), (5, 2, 17, 2, 18), (6, 2, 20, 3, 21), (7, 3, 24, 3, 25),
    (8, 3, 27, 3, 28), (9, 3, 30, 4, 31), (10, 4, 34, 4, 35), (11, 4, 37, 4, 38),
    (12, 4, 40, 5, 41),
]
_BLOCKS = ("down1", "down2", "down3", "down4", "down5", "down5_")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def _conv(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _dense(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    _norm(sd, prefix, p)
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _encoder_layer(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.self_attn.in_proj_weight"] = _t(np.asarray(p["qkv"]["kernel"]).T)
    sd[f"{prefix}.self_attn.in_proj_bias"] = _t(p["qkv"]["bias"])
    _dense(sd, f"{prefix}.self_attn.out_proj", p["out_proj"])
    _dense(sd, f"{prefix}.linear1", p["ff1"])
    _dense(sd, f"{prefix}.linear2", p["ff2"])
    _norm(sd, f"{prefix}.norm1", p["norm1"])
    _norm(sd, f"{prefix}.norm2", p["norm2"])


def slicenet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """SliceNet flax variables -> the port's (reference-named) state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    up, us = params["slices_generator"], stats["slices_generator"]
    g = "slices_generator"
    sd: Dict[str, torch.Tensor] = {}
    enc_p, enc_s = up["encoder"], us["encoder"]
    for ci, cb, cidx, bb, bidx in _REF_VGG_SLICES:
        _conv(sd, f"{g}.{_BLOCKS[cb]}.{cidx}", enc_p[f"conv{ci}"])
        _bn(sd, f"{g}.{_BLOCKS[bb]}.{bidx}", enc_p[f"bn{ci}"], enc_s[f"bn{ci}"])
    sd[f"{g}.emds.weight"] = _t(up["emds"]["embedding"])
    _conv(sd, f"{g}.trans_c", up["trans_c"])
    for i in (1, 2, 3, 4):
        _conv(sd, f"{g}.trans_up{i}", up[f"trans_up{i}"])
        _conv_transpose(sd, f"{g}.up{i}.up", up[f"up{i}"]["up"])
        for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
            conv_p = up[f"up{i}"]["conv"]
            _conv(sd, f"{g}.up{i}.conv.double_conv.{ci}", conv_p[f"conv{j}"])
            _bn(sd, f"{g}.up{i}.conv.double_conv.{bi}", conv_p[f"bn{j}"],
                us[f"up{i}"]["conv"][f"bn{j}"])
    _conv(sd, f"{g}.outc.conv", up["outc"])

    head = params["head"]
    _dense(sd, "fc_p", head["fc_p"])
    _dense(sd, "fc_s", head["fc_s"])
    for i in range(len(head["att_decoder"])):
        _encoder_layer(sd, f"att_decoder.layers.{i}", head["att_decoder"][f"layer{i}"])
    _dense(sd, "fc_out.0", head["fc_out"])
    return sd
