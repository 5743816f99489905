"""OpenSeeFace's landmark, detection and gaze networks, and their decodes.

Port of ``havatar_tpu/preprocess/landmark_net.py``. The reference's
preprocessing finds the face with OpenSeeFace (tracker.py:498-560, its torch
blueprint models_pytorch/model.py:10-283): MobileNetV3 backbones (geffnet's
arch tables) with UNet-style upsampling heads,

* ``LandmarkNet`` (model types 0-3; JAX ``apply_landmark_net``): a 224^2
  crop -> [B, 198, 28, 28] (66 confidence maps, 66 x- and 66 y-offset maps);
* ``DetectionNet`` (JAX ``apply_detection_net``): a 224^2 frame -> (maps,
  their 3x3 max-pool), each [B, 2, 56, 56];
* ``GazeNet`` (JAX ``apply_gaze_net``): 32^2 eye crops -> [B, 3, 8, 8];

plus the numpy decodes (``decode_landmarks``, ``decode_detections``,
``logit_arr``) and the input normalisation (``preprocess_crop``), copied
from the JAX module. The modules keep the reference's geffnet key layout,
each BatchNorm in eval mode beside its conv (JAX folds them at conversion),
so ``lm_model{N}.pth``, ``detection.pth`` and the gaze file load with
``load_state_dict``; a module's ``state_dict()`` feeds JAX's
``convert_torch_*_model`` unchanged. Inputs and outputs are NCHW.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from havatar_tpu_torch.device import DeviceLike, resolve_device
from havatar_tpu_torch.preprocess.nets import load_reference, read_state_dict, seed_

# MobileNetV3 arch tables (geffnet arch_def strings, models_pytorch/
# model.py:27-50 / :73-96). Each block: (type, kernel, stride, exp_ratio,
# out_ch, has_se, act)
_SMALL = [
    [("ds", 3, 2, 1.0, 16, True, "relu")],
    [("ir", 3, 2, 4.5, 24, False, "relu"),
     ("ir", 3, 1, 3.67, 24, False, "relu")],
    [("ir", 5, 2, 4.0, 40, True, "hswish"),
     ("ir", 5, 1, 6.0, 40, True, "hswish"),
     ("ir", 5, 1, 6.0, 40, True, "hswish")],
    [("ir", 5, 1, 3.0, 48, True, "hswish"),
     ("ir", 5, 1, 3.0, 48, True, "hswish")],
    [("ir", 5, 2, 6.0, 96, True, "hswish"),
     ("ir", 5, 1, 6.0, 96, True, "hswish"),
     ("ir", 5, 1, 6.0, 96, True, "hswish")],
    [("cn", 1, 1, 1.0, 576, False, "hswish")],
]

_LARGE = [
    [("ds", 3, 1, 1.0, 16, False, "relu")],
    [("ir", 3, 2, 4.0, 24, False, "relu"),
     ("ir", 3, 1, 3.0, 24, False, "relu")],
    [("ir", 5, 2, 3.0, 40, True, "relu"),
     ("ir", 5, 1, 3.0, 40, True, "relu"),
     ("ir", 5, 1, 3.0, 40, True, "relu")],
    [("ir", 3, 2, 6.0, 80, False, "hswish"),
     ("ir", 3, 1, 2.5, 80, False, "hswish"),
     ("ir", 3, 1, 2.3, 80, False, "hswish"),
     ("ir", 3, 1, 2.3, 80, False, "hswish")],
    [("ir", 3, 1, 6.0, 112, True, "hswish"),
     ("ir", 3, 1, 6.0, 112, True, "hswish")],
    [("ir", 5, 2, 6.0, 160, True, "hswish"),
     ("ir", 5, 1, 6.0, 160, True, "hswish"),
     ("ir", 5, 1, 6.0, 160, True, "hswish")],
    [("cn", 1, 1, 1.0, 960, False, "hswish")],
]

#: model_type -> (backbone variant, channel multiplier) (tracker.py:498-560)
LM_MODELS = {
    0: ("small", 0.5),
    1: ("small", 1.0),
    2: ("large", 0.75),
    3: ("large", 1.0),
}


def round_channels(ch: float, multiplier: float = 1.0, divisor: int = 8) -> int:
    """geffnet round_channels / make_divisible."""
    if not multiplier:
        return int(ch)
    return make_divisible(ch * multiplier, divisor)


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def lm_arch(model_type: int):
    """(table, channel multiplier, r2 tap stage, r3 tap stage)."""
    variant, cm = LM_MODELS[model_type]
    table = _SMALL if variant == "small" else _LARGE
    r2_i, r3_i = (1, 2) if variant == "small" else (2, 4)
    return table, cm, r2_i, r3_i


# ---------------------------------------------------------------------------
# Blocks (geffnet names: conv_stem/bn1, blocks.{stage}.{block}.*)
# ---------------------------------------------------------------------------

def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


_ACT = {"relu": F.relu, "hswish": F.hardswish}


def _conv(cin: int, cout: int, k: int = 1, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    """Bias-free torch Conv2d with the reference's symmetric k // 2
    padding."""
    return nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False)


class SqueezeExcite(nn.Module):
    """geffnet SqueezeExcite: mean -> 1x1 reduce (relu) -> 1x1 expand
    (hard-sigmoid gate)."""

    def __init__(self, ch: int, rd: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(ch, rd, 1)
        self.conv_expand = nn.Conv2d(rd, ch, 1)

    def forward(self, x):
        s = F.relu(self.conv_reduce(x.mean((2, 3), keepdim=True)))
        return x * hard_sigmoid(self.conv_expand(s))


class ConvBnAct(nn.Module):
    """The ``cn`` block: conv -> BN -> act."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, act: str):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride)
        self.bn1 = nn.BatchNorm2d(cout)
        self.act = _ACT[act]

    def forward(self, x):
        return self.act(self.bn1(self.conv(x)))


class DepthwiseSeparable(nn.Module):
    """The ``ds`` block: dw -> BN -> act [-> SE] -> pw -> BN (+ x)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 has_se: bool, act: str):
        super().__init__()
        self.conv_dw = _conv(cin, cin, k, stride, groups=cin)
        self.bn1 = nn.BatchNorm2d(cin)
        self.se = SqueezeExcite(cin, make_divisible(cin * 0.25)) if has_se else None
        self.conv_pw = _conv(cin, cout)
        self.bn2 = nn.BatchNorm2d(cout)
        self.act = _ACT[act]
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = self.act(self.bn1(self.conv_dw(x)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class InvertedResidual(nn.Module):
    """The ``ir`` block: pw -> BN -> act -> dw -> BN -> act [-> SE] -> pwl
    -> BN (+ x)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, exp: float,
                 has_se: bool, act: str):
        super().__init__()
        mid = make_divisible(cin * exp)
        self.conv_pw = _conv(cin, mid)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv_dw = _conv(mid, mid, k, stride, groups=mid)
        self.bn2 = nn.BatchNorm2d(mid)
        self.se = SqueezeExcite(mid, make_divisible(mid * 0.25)) if has_se else None
        self.conv_pwl = _conv(mid, cout)
        self.bn3 = nn.BatchNorm2d(cout)
        self.act = _ACT[act]
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = self.act(self.bn1(self.conv_pw(x)))
        h = self.act(self.bn2(self.conv_dw(h)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


def _backbone(table, cm: float) -> Tuple[nn.ModuleList, List[int], int]:
    """(blocks, each stage's out channels, stem channels)."""
    stem = round_channels(16, cm)
    cin, stages, outs = stem, [], []
    for stage in table:
        blocks = []
        for btype, k, stride, e, c, has_se, act in stage:
            cout = round_channels(c, cm)
            if btype == "cn":
                blocks.append(ConvBnAct(cin, cout, k, stride, act))
            elif btype == "ds":
                blocks.append(DepthwiseSeparable(cin, cout, k, stride,
                                                 has_se, act))
            else:
                blocks.append(InvertedResidual(cin, cout, k, stride, e,
                                               has_se, act))
            cin = cout
        stages.append(nn.ModuleList(blocks))
        outs.append(cin)
    return nn.ModuleList(stages), outs, stem


class DSConv2d(nn.Module):
    """OpenSeeFace's DSConv2d head (model.py:106-127), ``conv`` a Sequential:

    * old=0: dw -> BN -> relu6 -> grouped pw -> BN -> relu6 (landmarks);
    * old=1: dw -> BN -> grouped pw -> BN -> relu6 (detection);
    * old=2: dw (+bias) -> grouped pw (+bias), no BN, no act (gaze).
    """

    def __init__(self, cin: int, cout: int, kpl: int = 1, groups: int = 1,
                 old: int = 0):
        super().__init__()
        mid = cin * kpl
        bias = old == 2
        dw = nn.Conv2d(cin, mid, 3, 1, 1, groups=cin, bias=bias)
        pw = nn.Conv2d(mid, cout, 1, groups=groups, bias=bias)
        if old == 0:
            layers = [dw, nn.BatchNorm2d(mid), nn.ReLU6(), pw,
                      nn.BatchNorm2d(cout), nn.ReLU6()]
        elif old == 1:
            layers = [dw, nn.BatchNorm2d(mid), pw, nn.BatchNorm2d(cout),
                      nn.ReLU6()]
        else:
            layers = [dw, pw]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return self.conv(x)


def upsample_align_corners(x, size: Tuple[int, int]):
    """Bilinear resize with torch's align_corners=True (a 1x1 source, the
    gaze net's bottleneck, fills the output with its one value)."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


class UNetUp(nn.Module):
    """UNetUp (model.py:132-141): upsample to the skip's size
    (align_corners) -> concat(skip, x) -> DSConv2d."""

    def __init__(self, cin: int, cout: int, old: int):
        super().__init__()
        self.conv = DSConv2d(cin, cout, old=old)

    def forward(self, x, skip):
        x = upsample_align_corners(x, tuple(skip.shape[2:]))
        return self.conv(torch.cat([skip, x], 1))


class _OpenSeeFaceNet(nn.Module):
    """Stem, backbone, ``len(taps)`` UNetUp stages (deepest tap first) and
    the grouped head."""

    def __init__(self, table, cm: float, taps: Tuple[int, ...],
                 up_ch: Tuple[int, ...], head: Tuple[int, int, int], old: int):
        super().__init__()
        self.blocks, outs, stem = _backbone(table, cm)
        self.conv_stem = _conv(3, stem, 3, 2)
        self.bn1 = nn.BatchNorm2d(stem)
        self.taps = taps
        cin = outs[-1]
        for i, (tap, cout) in enumerate(zip(reversed(taps), up_ch)):
            setattr(self, f"up{i + 1}", UNetUp(cin + outs[tap], cout, old))
            cin = cout
        cout, kpl, groups = head
        self.group = DSConv2d(cin, cout, kpl, groups, old)

    def features(self, x):
        h = F.hardswish(self.bn1(self.conv_stem(x)))
        skips = {}
        for si, stage in enumerate(self.blocks):
            for block in stage:
                h = block(h)
            skips[si] = h
        for i, tap in enumerate(reversed(self.taps)):
            h = getattr(self, f"up{i + 1}")(h, skips[tap])
        return self.group(h)


class LandmarkNet(_OpenSeeFaceNet):
    """OpenSeeFaceLandmarks (model.py:232-283; JAX ``apply_landmark_net``):
    [B, 3, 224, 224] normalised crops -> [B, 198, 28, 28] heatmaps."""

    def __init__(self, model_type: int = 3):
        table, cm, r2_i, r3_i = lm_arch(model_type)
        super().__init__(table, cm, (r2_i, r3_i), (256, 198), (198, 4, 3), 0)
        self.model_type = model_type

    def forward(self, x):
        return self.features(x)


class DetectionNet(_OpenSeeFaceNet):
    """OpenSeeFaceDetect (model.py:177-222; JAX ``apply_detection_net``):
    [B, 3, 224, 224] -> (maps [B, 2, 56, 56], their 3x3 max-pool, whose
    equality with the maps is the peak NMS)."""

    def __init__(self):
        # the large backbone at channel multiplier 0.1 (JAX's
        # ``detect_arch`` defaults, the ones the tracker builds)
        super().__init__(_LARGE, 0.1, (1, 2, 4), (256, 128, 64), (2, 4, 2), 1)

    def forward(self, x):
        h = self.features(x)
        return h, F.max_pool2d(h, 3, 1, 1)


class GazeNet(_OpenSeeFaceNet):
    """OpenSeeFaceGaze (model.py:144-175; JAX ``apply_gaze_net``):
    [B, 3, 32, 32] eye crops -> [B, 3, 8, 8] (confidence, x- and y-offset
    logits); taps after stages 0, 1 and 3, the 576-channel head at 1^2."""

    def __init__(self):
        super().__init__(_SMALL, 1.0, (0, 1, 3), (64, 32, 15), (3, 4, 3), 2)

    def forward(self, x):
        return self.features(x)


# ---------------------------------------------------------------------------
# Weights: reference files, and seeded stand-ins for them
# ---------------------------------------------------------------------------

def load_landmark_weights(path: str, model_type: int = 3,
                          device: DeviceLike = None) -> LandmarkNet:
    """``lm_model{N}.pth`` (a torch state dict) or an ``.npz`` of the same
    tensors -> the landmark net on ``device`` (JAX
    ``load_landmark_weights``)."""
    net = load_reference(LandmarkNet(model_type), read_state_dict(path))
    return net.to(resolve_device(device))


def load_detection_weights(path: str, device: DeviceLike = None) -> DetectionNet:
    """``detection.pth`` -> the detection net on ``device``."""
    net = load_reference(DetectionNet(), read_state_dict(path))
    return net.to(resolve_device(device))


def load_gaze_weights(path: str, device: DeviceLike = None) -> GazeNet:
    """The gaze net's state dict -> the gaze net on ``device``."""
    return load_reference(GazeNet(), read_state_dict(path)).to(
        resolve_device(device))


def confident_heads_(net: nn.Module) -> nn.Module:
    """Set the last BatchNorm of a seeded landmark or detection net so its
    maps look like a face's (tests/test_tracker_driver.py:make_lm_heatmap):
    landmark confidences 0.5 plus a tenth of the seeded variation, offsets
    0.5 (no sub-cell shift) plus a hundredth; detection confidence 0.7 plus
    a tenth (a peak above the 0.6 threshold), radius 0.3 (a box of 0.6 x
    112 = 67 pixels of 224) plus a hundredth. The variation still places
    each peak, so the landmarks spread over the crop."""
    bn = net.group.conv[-2]
    c = bn.num_features
    scale = torch.full((c,), 0.01)
    shift = torch.full((c,), 0.5)
    if isinstance(net, DetectionNet):
        scale[0], shift[0], shift[1] = 0.1, 0.7, 0.3
    else:
        scale[:c // 3] = 0.1
    with torch.no_grad():
        bn.weight.copy_(scale)
        bn.bias.copy_(shift)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
    return net


# ---------------------------------------------------------------------------
# Decodes and input normalisation (numpy; copies of the JAX module's)
# ---------------------------------------------------------------------------

def decode_detections(maps: np.ndarray, maxpool: np.ndarray,
                      frame_hw: Tuple[int, int], max_faces: int = 1,
                      threshold: float = 0.6) -> np.ndarray:
    """[56, 56, 2] maps and max-pool (NHWC) -> (x, y, w, h) face boxes in
    frame pixels (spec: tracker.py:705-729)."""
    out = np.asarray(maps).transpose(2, 0, 1).copy()    # [2, 56, 56]
    mp = np.asarray(maxpool).transpose(2, 0, 1)
    out[0, out[0] != mp[0]] = 0                          # peak NMS
    order = np.flip(np.argsort(out[0].flatten()))
    results = []
    for det in order[:max_faces]:
        y, x = det // 56, det % 56
        c = out[0, y, x]
        if c < threshold:
            break
        r = out[1, y, x] * 112.0
        results.append((x * 4 - r, y * 4 - r, 2 * r, 2 * r))
    results = np.array(results, np.float32).reshape(-1, 4)
    if results.shape[0] > 0:
        results[:, [0, 2]] *= frame_hw[1] / 224.0
        results[:, [1, 3]] *= frame_hw[0] / 224.0
    return results


def logit_arr(p, factor: float = 16.0):
    p = np.clip(p, 1e-7, 1.0 - 1e-7)
    return np.log(p / (1.0 - p)) / factor


def decode_landmarks(hm_nhwc: np.ndarray,
                     crop_info=(0.0, 0.0, 1.0, 1.0),
                     res: float = 224.0, logit_factor: float = 16.0):
    """[28, 28, 198] heatmaps (NHWC) -> (avg_conf, [66, 3] landmarks in
    the tracker's (y, x, conf) layout); ``crop_info`` = (crop_x1, crop_y1,
    scale_x, scale_y) of the crop in the frame (spec: tracker.py:731-761)."""
    crop_x1, crop_y1, scale_x, scale_y = crop_info
    out_res_i = hm_nhwc.shape[0]
    out_res = float(out_res_i - 1)
    c0 = hm_nhwc.shape[-1] // 3
    tensor = np.asarray(hm_nhwc).transpose(2, 0, 1)  # [198, H, W]
    r = res - 1.0
    t_main = tensor[0:c0].reshape(c0, out_res_i * out_res_i)
    t_m = t_main.argmax(1)
    indices = np.expand_dims(t_m, 1)
    t_conf = np.take_along_axis(t_main, indices, 1).reshape(c0)
    t_off_x = np.take_along_axis(
        tensor[c0:2 * c0].reshape(c0, -1), indices, 1).reshape(c0)
    t_off_y = np.take_along_axis(
        tensor[2 * c0:3 * c0].reshape(c0, -1), indices, 1).reshape(c0)
    t_off_x = r * logit_arr(t_off_x, logit_factor)
    t_off_y = r * logit_arr(t_off_y, logit_factor)
    t_x = crop_y1 + scale_y * (r * np.floor(t_m / out_res_i) / out_res + t_off_x)
    t_y = crop_x1 + scale_x * (r * np.floor(np.mod(t_m, out_res_i)) / out_res + t_off_y)
    lms = np.stack([t_x, t_y, t_conf], 1)
    lms[np.isnan(lms).any(axis=1)] = np.array([0.0, 0.0, 0.0], np.float32)
    return float(np.mean(t_conf)), lms


def preprocess_crop(frame_rgb: np.ndarray, res: int = 224) -> np.ndarray:
    """uint8 RGB crop -> [1, res, res, 3] normalised float input, NHWC
    (spec: tracker.py:563-570,860-866: x / (std * 255) - mean / std)."""
    import cv2

    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    scale = 1.0 / (std * 255.0)
    shift = -mean / std
    im = cv2.resize(frame_rgb, (res, res),
                    interpolation=cv2.INTER_LINEAR).astype(np.float32)
    im = im * scale + shift
    return im[None]


def nchw(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """NHWC numpy (``preprocess_crop``'s layout) -> an NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW tensor -> NHWC numpy (the decodes' layout)."""
    return t.permute(0, 2, 3, 1).float().cpu().numpy()


def seeded_net(kind: str, seed: int, model_type: int = 3,
               confident: bool = False) -> nn.Module:
    """A seeded ``"landmark"`` (``model_type``), ``"detection"`` or
    ``"gaze"`` net on the CPU, in eval mode (JAX's counterpart for the
    landmark net: ``init_landmark_params``). ``confident`` applies
    ``confident_heads_`` (landmark and detection nets)."""
    net = {"landmark": lambda: LandmarkNet(model_type),
           "detection": DetectionNet, "gaze": GazeNet}[kind]()
    seed_(net, seed)
    return confident_heads_(net) if confident else net
