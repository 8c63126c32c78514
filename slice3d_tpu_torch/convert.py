"""Flax variables (numpy trees) -> the port's ``state_dict``s.

The inverse of the JAX package's checkpoint importer
(``slice3d_tpu/convert/torch_import.py``): a variables tree as
``init_variables``, the trainers or the torch importer produce it
(``{"params": ..., "batch_stats": ...}`` with numpy or array leaves) becomes
a ``state_dict`` under the reference torch names, which the port's models
take as it is.  Covered: SliceNet, GTSlice, DISN, CameraNet and the
latent-diffusion model (kl-f8 VAE, ADM UNet, VGG16-BN conditioner).

Layout rules: conv HWIO -> OIHW; Dense (in, out) -> (out, in); a Dense that
the reference holds as a 1x1 Conv1d -> (out, in, 1); ConvTranspose
(kH, kW, O, I) -> (I, O, kH, kW); the fused ``qkv`` kernel transposed is
``in_proj_weight``; BatchNorm ``mean``/``var`` -> ``running_mean``/
``running_var``; GroupNorm/LayerNorm ``scale`` -> ``weight``; a Dense over a
flattened feature map (DISN's and CameraNet's first global Linear) goes from
the JAX package's NHWC flatten order back to torch's NCHW one.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = ["slicenet_state_dict", "gtslice_state_dict", "disn_state_dict",
           "camnet_state_dict", "vae_state_dict",
           "ldm_unet_state_dict", "cond_encoder_state_dict",
           "latent_diffusion_state_dict", "ldm_train_payload", "train_reg_payload"]

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
_REF_BLOCKS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3", "conv_last")
_TRANS = ("trans1_2", "trans2_2", "trans3_3", "trans4_3", "trans5_3")


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


def _dense_nchw(sd: Dict, prefix: str, p: Mapping, channels: int = 512) -> None:
    """A Dense over an NHWC-flattened (h, w, c) map -> a Linear over the
    NCHW-flattened one (the inverse of ``nchw_flat_linear_params``)."""
    kernel = np.asarray(p["kernel"])  # (h * w * c, o)
    side = int(round(np.sqrt(kernel.shape[0] // channels)))
    w = kernel.T.reshape(-1, side, side, channels).transpose(0, 3, 1, 2)
    sd[f"{prefix}.weight"] = _t(w.reshape(w.shape[0], -1))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn(sd: Dict, prefix: str, p: Mapping, s: Optional[Mapping]) -> None:
    """BatchNorm parameters, and its statistics unless ``s`` is None."""
    _norm(sd, prefix, p)
    if s is None:
        return
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


def _vgg(sd: Dict, blocks: Sequence[str], p: Mapping, s: Optional[Mapping]) -> None:
    """A VGG16BNBackbone subtree (conv0..12, bn0..12) under six block names
    (without BatchNorm statistics when ``s`` is None)."""
    for ci, cb, cidx, bb, bidx in _REF_VGG_SLICES:
        _conv(sd, f"{blocks[cb]}.{cidx}", p[f"conv{ci}"])
        _bn(sd, f"{blocks[bb]}.{bidx}", p[f"bn{ci}"], None if s is None else s[f"bn{ci}"])


def _leaf(sd: Dict, prefix: str, p: Mapping) -> None:
    """A conv (4-D kernel), Dense (2-D kernel) or norm (``scale``) module."""
    if "scale" in p:
        _norm(sd, prefix, p)
    elif np.ndim(p["kernel"]) == 4:
        _conv(sd, prefix, p)
    else:
        _dense(sd, prefix, p)


def _tree(sd: Dict, prefix: str, p: Mapping) -> None:
    """Every module of a subtree whose child names are the reference's."""
    for name, child in p.items():
        if "kernel" in child or "scale" in child:
            _leaf(sd, f"{prefix}.{name}", child)
        else:
            _tree(sd, f"{prefix}.{name}", child)


def slicenet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """SliceNet flax variables -> the port's (reference-named) state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    up, us = params["slices_generator"], stats["slices_generator"]
    g = "slices_generator"
    sd: Dict[str, torch.Tensor] = {}
    _vgg(sd, [f"{g}.{b}" for b in _BLOCKS], up["encoder"], us["encoder"])
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


def gtslice_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """GTSlice flax variables -> the port's (reference-named) state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _vgg(sd, [f"img_encoder.{b}" for b in _REF_BLOCKS], params["img_encoder"],
         stats["img_encoder"])
    head = params["head"]
    for i, idx in enumerate((0, 2, 4)):
        _dense(sd, f"pts_feat_extractor.{idx}", head["pts_mlp"][f"fc{i}"])
    for i, idx in enumerate((0, 2)):
        _dense(sd, f"fc_local.{idx}", head["fc_local"][f"fc{i}"])
    for i in range(len(head["att_decoder"])):
        _encoder_layer(sd, f"att_decoder.layers.{i}", head["att_decoder"][f"layer{i}"])
    _dense(sd, "fc_out.0", head["fc_out"])
    return sd


def _mlp(sd: Dict, prefix: str, p: Mapping, indices: Sequence[int]) -> None:
    for i, idx in enumerate(indices):
        _dense(sd, f"{prefix}.{idx}", p[f"fc{i}"])


def disn_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """DISN flax variables -> the port's (reference-named) state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _vgg(sd, [f"img_encoder.{b}" for b in _REF_BLOCKS], params["img_encoder"],
         stats["img_encoder"])
    gh = params["global_head"]
    _dense_nchw(sd, "img_encoder.classifier.0", gh["fc0"])
    _dense(sd, "img_encoder.classifier.3", gh["fc1"])
    _dense(sd, "img_encoder.classifier.6", gh["fc2"])
    for name in ("pts_feat_extractor", "fc_local", "fc_global"):
        _mlp(sd, name, params[name], (0, 2, 4))
    return sd


def camnet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """CameraNet flax variables -> the port's (reference-named) state_dict:
    the trunk is ``global_features.0``, torchvision's whole vgg16_bn
    ``features`` with its absolute indices."""
    params, stats = variables["params"], variables["batch_stats"]
    p, s = params["backbone"], stats["backbone"]
    sd: Dict[str, torch.Tensor] = {}
    for ci, _, cidx, _, bidx in _REF_VGG_SLICES:
        _conv(sd, f"global_features.0.{cidx}", p[f"conv{ci}"])
        _bn(sd, f"global_features.0.{bidx}", p[f"bn{ci}"], s[f"bn{ci}"])
    _dense_nchw(sd, "fc", params["fc"])
    for branch in ("branch_ortho6d", "branch_dist"):
        for i in range(3):
            _dense(sd, f"{branch}.{i}.0", params[branch][f"fc{i}"])
    return sd


# flax VAE module names -> the reference's
_VAE_NAMES = [(r"down(\d+)_block(\d+)$", r"down.\1.block.\2"),
              (r"down(\d+)_downsample$", r"down.\1.downsample"),
              (r"up(\d+)_block(\d+)$", r"up.\1.block.\2"),
              (r"up(\d+)_upsample$", r"up.\1.upsample"),
              (r"mid_block1$", "mid.block_1"), (r"mid_attn$", "mid.attn_1"),
              (r"mid_block2$", "mid.block_2")]


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def vae_state_dict(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """AutoencoderKL flax params -> reference names (``encoder.down.{i}...``)
    under ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    for part in ("encoder", "decoder"):
        for name, child in params[part].items():
            ref = name
            for pat, rep in _VAE_NAMES:
                ref = re.sub(pat, rep, ref)
            where = _key(prefix, f"{part}.{ref}")
            if "kernel" in child or "scale" in child:
                _leaf(sd, where, child)
            else:
                _tree(sd, where, child)
    _conv(sd, _key(prefix, "quant_conv"), params["quant_conv"])
    _conv(sd, _key(prefix, "post_quant_conv"), params["post_quant_conv"])
    return sd


_ADM_RES = {"in_norm": "in_layers.0", "in_conv": "in_layers.2",
            "emb_proj": "emb_layers.1", "out_norm": "out_layers.0",
            "out_conv": "out_layers.3", "skip": "skip_connection"}


def _conv1d(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def ldm_unet_state_dict(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """LDMUNet flax params -> reference ``UNetModel`` names under ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    top = {"time_embed_0": "time_embed.0", "time_embed_2": "time_embed.2",
           "out_norm": "out.0", "out_conv": "out.2"}
    for name, child in params.items():
        if name in top:
            _leaf(sd, _key(prefix, top[name]), child)
            continue
        m = re.fullmatch(r"(input|middle|output)_(\d+)(?:_(\d+))?", name)
        if m is None:
            raise KeyError(f"unexpected LDMUNet module {name!r}")
        kind, a, b = m.groups()
        where = (_key(prefix, f"middle_block.{a}") if kind == "middle"
                 else _key(prefix, f"{kind}_blocks.{a}.{b}"))
        if "kernel" in child:  # input_0_0, the input conv
            _conv(sd, where, child)
        elif "qkv" in child:
            _norm(sd, f"{where}.norm", child["norm"])
            _conv1d(sd, f"{where}.qkv", child["qkv"])
            _conv1d(sd, f"{where}.proj_out", child["proj_out"])
        else:
            for sub, p in child.items():
                _leaf(sd, f"{where}.{_ADM_RES[sub]}", p)
    return sd


def cond_encoder_state_dict(variables: Mapping, prefix: str = "cond_stage_model"
                            ) -> Dict[str, torch.Tensor]:
    """CondImageEncoder flax variables -> reference ``ImageEncoderVGG16BN``
    names under ``prefix`` (BatchNorm statistics included when the variables
    have ``batch_stats``)."""
    params, stats = variables["params"], variables.get("batch_stats")
    sd: Dict[str, torch.Tensor] = {}
    _vgg(sd, [_key(prefix, b) for b in _REF_BLOCKS], params["backbone"],
         None if stats is None else stats["backbone"])
    for i, name in enumerate(_TRANS):
        if f"trans{i}" in params:
            _conv(sd, _key(prefix, name), params[f"trans{i}"])
    return sd


def latent_diffusion_state_dict(variables: Mapping, scale_factor: float = 1.0
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``LatentDiffusion`` variables (``first_stage``, ``model``,
    ``cond_stage``) -> the port's ``LatentDiffusion`` state_dict:
    ``first_stage_model.*``, ``model.diffusion_model.*``,
    ``cond_stage_model.*`` and the ``scale_factor`` buffer (kept in the JAX
    trainer's state, not its variables, hence the argument)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = vae_state_dict(params["first_stage"], "first_stage_model")
    sd.update(ldm_unet_state_dict(params["model"], "model.diffusion_model"))
    sd.update(cond_encoder_state_dict({"params": params["cond_stage"],
                                       "batch_stats": stats["cond_stage"]}))
    sd["scale_factor"] = torch.tensor(float(scale_factor))
    return sd


def ldm_train_payload(params: Mapping, batch_stats: Mapping, ema_params: Mapping,
                      logvar, scale_factor: float, step: int = 0) -> Dict:
    """The JAX ``LDMTrainState``'s ``params``, ``batch_stats``, ``ema_params``
    (``{"model", "cond_stage"}``), ``logvar`` and ``scale_factor`` (numpy
    trees) -> the port trainer's payload (``LDMTrainer.load_payload``): the
    model's state_dict with the BatchNorm running statistics and
    ``scale_factor``, the EMA by parameter name (the UNet's and the
    conditioner's parameters, no statistics), ``logvar`` and the step.  The
    optimizer state is not carried: AdamW starts fresh."""
    model = latent_diffusion_state_dict({"params": params, "batch_stats": batch_stats},
                                        scale_factor)
    ema = ldm_unet_state_dict(ema_params["model"], "model.diffusion_model")
    ema.update(cond_encoder_state_dict({"params": ema_params["cond_stage"]}))
    return {"model": model, "ema": ema, "logvar": _t(logvar), "step": int(step)}


_STATS = ("running_mean", "running_var", "num_batches_tracked")


def train_reg_payload(tree: Mapping, name_model: str) -> Dict:
    """A JAX ``train_reg`` checkpoint (``RegressionTrainer.save``'s tree:
    ``variables``, optax.adam's ``opt_state``, ``n_epoch``, ``n_iter``) ->
    the port's ``RegressionTrainer`` payload: the model's state_dict, Adam's
    moments by parameter name (optax's ``mu`` / ``nu`` through the same
    layout map as the parameters become torch's ``exp_avg`` /
    ``exp_avg_sq``; its ``count`` the step), and the epoch and step."""
    to_sd = slicenet_state_dict if name_model == "slicenet" else gtslice_state_dict
    variables = tree["variables"]
    adam = tree["opt_state"]["0"]  # (ScaleByAdamState, ScaleByScheduleState)

    def moments(m):
        sd = to_sd({"params": m, "batch_stats": variables["batch_stats"]})
        return {k: v for k, v in sd.items() if not k.endswith(_STATS)}

    return {"model": to_sd(variables),
            "adam": {"count": int(np.asarray(adam["count"])), "exp_avg": moments(adam["mu"]),
                     "exp_avg_sq": moments(adam["nu"])},
            "n_epoch": int(np.asarray(tree["n_epoch"])), "n_iter": int(np.asarray(tree["n_iter"]))}
