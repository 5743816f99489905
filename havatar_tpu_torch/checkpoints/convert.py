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
``StyleUNetSR``, and the flat
``field.*`` / ``skin.*`` keys of ``tests/golden/render_production.npz``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

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


def from_jax_params(variables: Mapping) -> StateDict:
    """JAX variables -> port state_dict. Accepts

    * renderer variables ``{"params": {"field": ..., "skinning": ...},
      "buffers": ...}`` -> ``AvatarRenderer`` keys;
    * StyleUNetSR params, bare or as ``{"params": ...}`` -> ``StyleUNetSR``
      keys;
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
    return _generator(params, "")
