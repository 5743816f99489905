"""Weights from the JAX package into the port: ``from_jax_params``.

The inverse of ``havatar_tpu/checkpoints/convert.py``: JAX variables, as
nested dicts of numpy arrays, become a port ``state_dict`` with the
reference PyTorch names and layouts:

  flax [in, out]                   -> torch Linear [out, in]
  flax HWIO                        -> torch Conv2d OIHW
  flax DHWIO                       -> torch Conv3d OIDHW
  [k, k, in, out] modulated weight -> [1, out, in, k, k]
  ConstantInput [1, s, s, C]       -> [1, C, s, s]
  ToRGB bias [1, 1, 1, C]          -> [1, C, 1, 1]
  init_lc [1, 1, 1, 1, C]          -> [1, C, 1, 1, 1]
  EqualLinear weights stay divided by lr_mul.

Covers the renderer (field MLP, the plane generators of all three
``enc_mode``s, the skinning volume decoder and its ``init_lc`` buffer),
``StyleUNetSR``, ``WaveletDiscriminator`` (the inverse of
``convert_discriminator``), and the flat
``field.*`` / ``skin.*`` keys of ``tests/golden/render_production.npz``.
``dense_params_from_jax`` carries a field's bare dense-layer dict into the
fused field ops' parameter tuple.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    """A float32 tensor that owns a copy of ``a`` (which may be read-only)."""
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _linear(d: Mapping, prefix: str, weight: str = "weight") -> StateDict:
    """EqualLinear ('weight') or flax Dense ('kernel') -> Linear layout."""
    out = {f"{prefix}.weight": _t(np.asarray(d[weight]).T)}
    if "bias" in d:
        out[f"{prefix}.bias"] = _t(d["bias"])
    return out


def _oihw(w) -> torch.Tensor:
    return _t(np.asarray(w).transpose(3, 2, 0, 1))


def _conv_layer(d: Mapping, prefix: str, downsample: bool) -> StateDict:
    """ConvLayer: the reference Sequential ([Blur], EqualConv2d, act)."""
    i = 1 if downsample else 0
    out = {f"{prefix}.{i}.weight": _oihw(d["conv"]["weight"])}
    if "bias" in d["conv"]:
        out[f"{prefix}.{i}.bias"] = _t(d["conv"]["bias"])
    if "act_bias" in d:
        out[f"{prefix}.{i + 1}.bias"] = _t(d["act_bias"])
    return out


def _modconv(d: Mapping, prefix: str) -> StateDict:
    return {f"{prefix}.weight": _oihw(d["weight"])[None],
            **_linear(d["modulation"], f"{prefix}.modulation")}


def _styled_conv(d: Mapping, prefix: str) -> StateDict:
    return {**_modconv(d["conv"], f"{prefix}.conv"),
            f"{prefix}.noise.weight": _t(d["noise"]["weight"]),
            f"{prefix}.activate.bias": _t(d["act_bias"])}


def _generator(tree: Mapping, prefix: str) -> StateDict:
    """PlaneGenerator or StyleUNetSR params -> state_dict entries."""
    p = f"{prefix}." if prefix else ""
    sd: StateDict = {}
    for key, sub in tree.items():
        m = re.fullmatch(r"([a-z_]+?)(\d*)", key)
        kind, n = m.group(1), m.group(2)
        if key == "style":
            for fc, lin in sub.items():
                sd.update(_linear(lin, f"{p}style.{int(fc[2:]) + 1}"))
        elif key == "input":
            sd[f"{p}input.input"] = _t(np.asarray(sub["input"])
                                       .transpose(0, 3, 1, 2))
        elif key == "conv_in":
            sd.update(_conv_layer(sub, f"{p}conv_in", downsample=True))
        elif key == "conv_out":
            sd.update(_conv_layer(sub, f"{p}conv_out", downsample=False))
        elif key == "conv_first":
            sd.update(_styled_conv(sub, f"{p}conv1"))
        elif kind == "conv" and n:
            sd.update(_styled_conv(sub, f"{p}convs.{n}"))
        elif kind == "from_rgb" and n:
            sd.update(_conv_layer(sub["conv"], f"{p}from_rgbs.{n}.conv",
                                  downsample=False))
        elif kind == "cond_conv" and n:
            sd.update(_conv_layer(sub["conv1"], f"{p}cond_convs.{n}.conv1",
                                  downsample=False))
            sd.update(_conv_layer(sub["conv2"], f"{p}cond_convs.{n}.conv2",
                                  downsample=True))
        elif kind == "comb_conv" and n:
            sd.update(_conv_layer(sub, f"{p}comb_convs.{n}",
                                  downsample=False))
        elif kind == "to_rgb" and n:
            sd.update(_modconv(sub["conv"], f"{p}to_rgbs.{n}.conv"))
            sd[f"{p}to_rgbs.{n}.bias"] = _t(np.asarray(sub["bias"])
                                            .transpose(0, 3, 1, 2))
        else:
            raise KeyError(f"no port counterpart for generator key {key!r}")
    return sd


def _two_head_generator(tree: Mapping, prefix: str) -> StateDict:
    """TwoHeadPlaneGenerator params -> state_dict entries; the second
    head's modules carry the reference's suffix ``1``."""
    p = f"{prefix}." if prefix else ""
    sd: StateDict = {}
    for key, sub in tree.items():
        m = re.fullmatch(r"(conv_in|conv_out)([01])"
                         r"|(cond_conv|comb_conv)([01])_(\d+)"
                         r"|head([01])_conv(\d+)", key)
        if key in ("style", "input", "conv_first") or re.fullmatch(
                r"conv\d+", key):
            sd.update(_generator({key: sub}, prefix))
        elif m is None:
            raise KeyError(f"no port counterpart for generator key {key!r}")
        elif m.group(1):
            sfx = "1" if m.group(2) == "1" else ""
            sd.update(_conv_layer(sub, f"{p}{m.group(1)}{sfx}",
                                  downsample=m.group(1) == "conv_in"))
        elif m.group(3) == "cond_conv":
            sfx = "1" if m.group(4) == "1" else ""
            for c, down in (("conv1", False), ("conv2", True)):
                sd.update(_conv_layer(
                    sub[c], f"{p}cond_convs{sfx}.{m.group(5)}.{c}",
                    downsample=down))
        elif m.group(3) == "comb_conv":
            sfx = "1" if m.group(4) == "1" else ""
            sd.update(_conv_layer(sub, f"{p}comb_convs{sfx}.{m.group(5)}",
                                  downsample=False))
        else:
            sfx = "1" if m.group(6) == "1" else ""
            sd.update(_styled_conv(sub, f"{p}convs_head{sfx}.{m.group(7)}"))
    return sd


def _discriminator(tree: Mapping) -> StateDict:
    """WaveletDiscriminator params -> state_dict entries: ``from_rgb{i}``
    and the last ``from_rgb_final`` become ``from_rgbs.{i}``, ``conv{i}``
    (ConvBlocks) ``convs.{i}``, ``final_linear{i}`` ``final_linear.{i}``,
    the pose head's ``mapping{i}`` ``mapping.{i}``."""
    n_blocks = sum(1 for k in tree if re.fullmatch(r"conv\d+", k))
    sd: StateDict = {}
    for key, sub in tree.items():
        m = re.fullmatch(r"([a-z_]+?)(\d*)", key)
        kind, n = m.group(1), m.group(2)
        if key == "from_rgb_final" or (kind == "from_rgb" and n):
            i = n_blocks if key == "from_rgb_final" else int(n)
            sd.update(_conv_layer(sub["conv"], f"from_rgbs.{i}.conv",
                                  downsample=False))
        elif kind == "conv" and n:
            for c, down in (("conv1", False), ("conv2", True)):
                sd.update(_conv_layer(sub[c], f"convs.{n}.{c}",
                                      downsample=down))
        elif key == "final_conv":
            sd.update(_conv_layer(sub, "final_conv", downsample=False))
        elif kind in ("final_linear", "mapping") and n:
            sd.update(_linear(sub, f"{kind}.{n}"))
        else:
            raise KeyError(f"no port counterpart for discriminator key "
                           f"{key!r}")
    return sd


def _volume_decoder(params: Mapping, buffers: Mapping,
                    prefix: str) -> StateDict:
    sd: StateDict = {}
    for key, v in params.items():
        m = re.fullmatch(r"up(\d+)_(weight|bias)", key)
        if m:
            name = f"{prefix}.filters.{m.group(1)}.up.1.{m.group(2)}"
        elif key in ("final_weight", "final_bias"):
            name = f"{prefix}.final_conv.{key[len('final_'):]}"
        else:
            raise KeyError(f"no port counterpart for volume key {key!r}")
        a = np.asarray(v)
        sd[name] = _t(a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a)
    if "init_lc" in buffers:
        sd[f"{prefix}.init_lc"] = _t(np.asarray(buffers["init_lc"])
                                     .transpose(0, 4, 1, 2, 3))
    return sd


def renderer_state_dict(variables: Mapping) -> StateDict:
    """AvatarRenderer variables {"params": {"field", "skinning"},
    "buffers": {"skinning"}} -> the port AvatarRenderer's state_dict. A
    partial tree (e.g. no plane generators) gives a partial state_dict."""
    params = variables["params"]
    sd: StateDict = {}
    field = params.get("field", {})
    for key, sub in field.items():
        if key in ("XY_gen", "YZ_gen"):
            conv = _two_head_generator if "conv_in0" in sub else _generator
            sd.update(conv(sub, f"model_coarse.{key}"))
        elif key in ("layer0", "layer1"):
            sd.update(_linear(sub, f"model_coarse.layers_xyz.{key[-1]}",
                              weight="kernel"))
        elif key in ("fc_alpha", "fc_rgbFeat", "fc_rgb"):
            sd.update(_linear(sub, f"model_coarse.{key}", weight="kernel"))
        else:
            raise KeyError(f"no port counterpart for field key {key!r}")
    if "skinning" in params:
        sd.update(_volume_decoder(
            params["skinning"]["canonical_volume"],
            variables.get("buffers", {}).get("skinning", {})
            .get("canonical_volume", {}),
            "headpose_skin_net.canonical_Wvolume"))
    return sd


def _unflatten_golden(flat: Mapping) -> Dict[str, Any]:
    """``field.<layer>.<leaf>`` / ``skin.params.<name>`` /
    ``skin.buffers.<name>`` keys -> renderer variables."""
    field: Dict[str, Dict[str, Any]] = {}
    vol_p: Dict[str, Any] = {}
    vol_b: Dict[str, Any] = {}
    for k in flat:
        if k.startswith("field."):
            _, name, leaf = k.split(".")
            field.setdefault(name, {})[leaf] = flat[k]
        elif k.startswith("skin.params."):
            vol_p[k[len("skin.params."):]] = flat[k]
        elif k.startswith("skin.buffers."):
            vol_b[k[len("skin.buffers."):]] = flat[k]
    params: Dict[str, Any] = {"field": field}
    if vol_p:
        params["skinning"] = {"canonical_volume": vol_p}
    return {"params": params,
            "buffers": {"skinning": {"canonical_volume": vol_b}}}


DENSE_LAYERS = ("layer0", "layer1", "fc_rgbFeat", "fc_alpha", "fc_rgb")


def dense_params_from_jax(params: Mapping) -> Tuple[torch.Tensor, ...]:
    """A JAX field's dense layers, ``{"layer0": {"kernel", "bias"}, ...}``
    (``DoublePlaneNeRFField.mlp_params``, ``scripts/micro_pallas.py``'s
    dict, or the ``params`` of a field), -> the ten tensors in the port's
    ``DoublePlaneNeRFField.dense_params()`` order (w0, b0, w1, b1, w_feat,
    b_feat, w_alpha, b_alpha, w_rgb, b_rgb), in Linear layout."""
    out = []
    for name in DENSE_LAYERS:
        sd = _linear(params[name], name, weight="kernel")
        out += [sd[f"{name}.weight"], sd[f"{name}.bias"]]
    return tuple(out)


def from_jax_params(variables: Mapping) -> StateDict:
    """JAX variables -> port state_dict. Accepts

    * renderer variables ``{"params": {"field": ..., "skinning": ...},
      "buffers": ...}`` -> ``AvatarRenderer`` keys;
    * StyleUNetSR params, bare or as ``{"params": ...}`` -> ``StyleUNetSR``
      keys;
    * WaveletDiscriminator params, bare or as ``{"params": ...}`` ->
      ``WaveletDiscriminator`` keys;
    * a flat mapping with ``field.*`` / ``skin.*`` keys (the production
      golden) -> the field MLP and skinning-decoder keys of
      ``AvatarRenderer``.

    Parameters and buffers cross (and, being linear maps of them, their
    gradients); a JAX trainer's optimizer state does not: a parity test of
    training steps starts both sides from zero moments.
    """
    keys = list(variables.keys())
    if any(k.startswith(("field.", "skin.")) for k in keys):
        return renderer_state_dict(_unflatten_golden(variables))
    params = variables.get("params", variables)
    if "field" in params or "skinning" in params:
        return renderer_state_dict(variables)
    if "final_linear0" in params:
        return _discriminator(params)
    return _generator(params, "")


# ---------------------------------------------------------------------------
# The preprocessing networks: JAX's BN-folded pytrees -> the port's modules
# ---------------------------------------------------------------------------
# JAX folds each BatchNorm into its conv (HWIO weight, bias) when it
# converts a reference file; the port keeps the BatchNorm. A folded pair
# crosses as the conv's weight and an identity BatchNorm that adds the
# bias: scale 1, running mean 0 and running variance 1 - eps (so that
# var + eps is 1 and the scale divides by one).

def _set_conv(conv, w, b=None) -> None:
    with torch.no_grad():
        conv.weight.copy_(_oihw(w))
        if b is not None:
            if conv.bias is None:
                raise ValueError(f"{conv} has no bias for the JAX bias")
            conv.bias.copy_(_t(b))


def _set_folded(conv, bn, w, b) -> None:
    _set_conv(conv, w)
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.copy_(_t(b))
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)


def _seq(seq, d: Mapping) -> None:
    """A (conv, BN[, act]) Sequential from {"w", "b"}, or a bare conv."""
    if isinstance(seq, torch.nn.Conv2d):
        _set_conv(seq, d["w"], d.get("b"))
    else:
        _set_folded(seq[0], seq[1], d["w"], d["b"])


def _ds_head(mod, p: Mapping) -> None:
    """DSConv2d (any ``old``) from {dw_w, dw_b, pw_w, pw_b}."""
    convs = [m for m in mod.conv if isinstance(m, torch.nn.Conv2d)]
    bns = [m for m in mod.conv if isinstance(m, torch.nn.BatchNorm2d)]
    for i, k in enumerate(("dw", "pw")):
        if bns:
            _set_folded(convs[i], bns[i], p[f"{k}_w"], p[f"{k}_b"])
        else:
            _set_conv(convs[i], p[f"{k}_w"], p[f"{k}_b"])


def _openseeface_from_jax(net, params: Mapping):
    from havatar_tpu_torch.preprocess import landmark_net as L

    _set_folded(net.conv_stem, net.bn1, params["stem"]["w"],
                params["stem"]["b"])
    for si, stage in enumerate(net.blocks):
        for bi, blk in enumerate(stage):
            p = params["blocks"][f"{si}_{bi}"]
            if isinstance(blk, L.ConvBnAct):
                _set_folded(blk.conv, blk.bn1, p["conv_w"], p["conv_b"])
                continue
            if isinstance(blk, L.InvertedResidual):
                _set_folded(blk.conv_pw, blk.bn1, p["pw_w"], p["pw_b"])
                _set_folded(blk.conv_dw, blk.bn2, p["dw_w"], p["dw_b"])
                _set_folded(blk.conv_pwl, blk.bn3, p["pwl_w"], p["pwl_b"])
            else:
                _set_folded(blk.conv_dw, blk.bn1, p["dw_w"], p["dw_b"])
                _set_folded(blk.conv_pw, blk.bn2, p["pw_w"], p["pw_b"])
            if blk.se is not None:
                se = p["se"]
                _set_conv(blk.se.conv_reduce, se["reduce_w"], se["reduce_b"])
                _set_conv(blk.se.conv_expand, se["expand_w"], se["expand_b"])
    for name in ("up1", "up2", "up3"):
        if hasattr(net, name):
            _ds_head(getattr(net, name).conv, params[name])
    _ds_head(net.group, params["group"])
    return net.eval()


def landmark_net_from_jax(params: Mapping, model_type: int = 3):
    """JAX landmark params (``convert_torch_landmark_model`` or
    ``init_landmark_params``) -> ``LandmarkNet`` on the CPU."""
    from havatar_tpu_torch.preprocess.landmark_net import LandmarkNet

    return _openseeface_from_jax(LandmarkNet(model_type), params)


def detection_net_from_jax(params: Mapping):
    """JAX ``convert_torch_detection_model`` params (the large backbone at
    0.1, its defaults) -> ``DetectionNet``."""
    from havatar_tpu_torch.preprocess.landmark_net import DetectionNet

    return _openseeface_from_jax(DetectionNet(), params)


def gaze_net_from_jax(params: Mapping):
    """JAX ``convert_torch_gaze_model`` params -> ``GazeNet``."""
    from havatar_tpu_torch.preprocess.landmark_net import GazeNet

    return _openseeface_from_jax(GazeNet(), params)


def retinaface_from_jax(params: Mapping):
    """JAX ``convert_torch_retinaface`` params -> ``RetinaFace``."""
    from havatar_tpu_torch.preprocess.retinaface import RetinaFace

    net = RetinaFace()
    _seq(net.body.stage1[0], params["stem"])
    for stage, name in ((net.body.stage1[1:], "stage1"),
                        (net.body.stage2, "stage2"),
                        (net.body.stage3, "stage3")):
        for blk, p in zip(stage, params[name]):
            _set_folded(blk[0], blk[1], p["dw"]["w"], p["dw"]["b"])
            _set_folded(blk[3], blk[4], p["pw"]["w"], p["pw"]["b"])
    f = params["fpn"]
    for mod, key in (("output1", "out1"), ("output2", "out2"),
                     ("output3", "out3"), ("merge1", "merge1"),
                     ("merge2", "merge2")):
        _seq(getattr(net.fpn, mod), f[key])
    for k in (1, 2, 3):
        ssh, p = getattr(net, f"ssh{k}"), params[f"ssh{k}"]
        for mod, key in (("conv3X3", "c3"), ("conv5X5_1", "c5_1"),
                         ("conv5X5_2", "c5"), ("conv7X7_2", "c7_1"),
                         ("conv7X7_3", "c7")):
            _seq(getattr(ssh, mod), p[key])
    for k in range(3):
        _seq(net.ClassHead[k].conv1x1, params["class_head"][k])
        _seq(net.BboxHead[k].conv1x1, params["bbox_head"][k])
    return net.eval()


def rvm_from_jax(params: Mapping):
    """JAX ``convert_torch_rvm`` params -> ``MattingNetwork``."""
    from havatar_tpu_torch.preprocess.rvm import MattingNetwork

    net = MattingNetwork()
    bb = params["backbone"]
    feats = net.backbone.features
    _seq(feats[0], bb["stem"])
    _seq(feats[16], bb["head"])
    for i, p in enumerate(bb["blocks"]):
        layers = list(feats[i + 1].block)
        j = 0
        if "expand" in p:
            _seq(layers[0], p["expand"])
            j = 1
        _seq(layers[j], p["dw"])
        if "se_fc1" in p:
            _seq(layers[j + 1].fc1, p["se_fc1"])
            _seq(layers[j + 1].fc2, p["se_fc2"])
        _seq(layers[-1], p["project"])
    _seq(net.aspp.aspp1, params["aspp"]["aspp1"])
    _seq(net.aspp.aspp2[1], params["aspp"]["aspp2"])
    dec = params["decoder"]
    for name in ("decode4", "decode3", "decode2", "decode1"):
        blk = getattr(net.decoder, name)
        _seq(blk.gru.ih[0], dec[name]["gru"]["ih"])
        _seq(blk.gru.hh[0], dec[name]["gru"]["hh"])
        if name != "decode4":
            _seq(blk.conv, dec[name]["conv"])
    conv0 = net.decoder.decode0.conv
    _seq(conv0[0:2], dec["decode0"]["conv0"])
    _seq(conv0[3:5], dec["decode0"]["conv1"])
    _seq(net.project_mat.conv, params["project_mat"])
    if "refiner" in params:
        r, conv = params["refiner"], net.refiner.conv
        _seq(net.refiner.box_filter, r["box_filter"])
        _seq(conv[0:2], r["conv0"])
        _seq(conv[3:5], r["conv1"])
        _seq(conv[6], r["conv2"])
    return net.eval()
