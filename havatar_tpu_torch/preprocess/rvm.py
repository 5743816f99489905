"""Robust Video Matting (MobileNetV3-Large variant), NCHW.

Port of ``havatar_tpu/preprocess/rvm.py``. The reference mats the video
with RVM as a downloaded TorchScript blob (``Bg_Matting``, reference
data_preprocessing/fit_video.py:640-659: ``model(src, *rec,
downsample_ratio)`` frame by frame, carrying the 4 recurrent states). This
module is the published architecture (Lin et al., "Robust High-Resolution
Video Matting with Temporal Guidance", WACV 2022) as torch modules in the
official ``rvm_mobilenetv3`` key layout, each BatchNorm in eval mode beside
its conv, so ``rvm_mobilenetv3.pth`` loads with ``load_state_dict`` and a
module's ``state_dict()`` feeds JAX's ``convert_torch_rvm``:

* the MobileNetV3-Large encoder (torchvision layout; the last stage
  dilated 2 for output stride 16) -> features at strides 2, 4, 8 and 16;
* the LR-ASPP head (960 -> 128);
* the recurrent decoder: a ConvGRU bottleneck, 3 upsampling blocks and an
  output block, each taking the average-pooled source at its scale;
* the projection (16 -> foreground residual 3 + alpha 1);
* the deep guided filter refiner for ``downsample_ratio`` < 1.

``MattingNetwork.forward`` mirrors JAX's ``rvm_forward``: the upsampling
blocks resize to the pooled source's size (align_corners off, no
antialias), and the average pools are ``AvgPool2d(2, 2, ceil_mode=True,
count_include_pad=False)``, so odd sizes pool as JAX's do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from havatar_tpu_torch.device import DeviceLike, resolve_device
from havatar_tpu_torch.preprocess.landmark_net import make_divisible
from havatar_tpu_torch.preprocess.nets import load_reference, read_state_dict, seed_

# (kernel, exp, out, use_se, activation, stride, dilation)
MBV3_LARGE = [
    (3, 16, 16, False, "RE", 1, 1),
    (3, 64, 24, False, "RE", 2, 1),
    (3, 72, 24, False, "RE", 1, 1),
    (5, 72, 40, True, "RE", 2, 1),
    (5, 120, 40, True, "RE", 1, 1),
    (5, 120, 40, True, "RE", 1, 1),
    (3, 240, 80, False, "HS", 2, 1),
    (3, 200, 80, False, "HS", 1, 1),
    (3, 184, 80, False, "HS", 1, 1),
    (3, 184, 80, False, "HS", 1, 1),
    (3, 480, 112, True, "HS", 1, 1),
    (3, 672, 112, True, "HS", 1, 1),
    # RVM: output stride 16 -> last stage stride 1 with dilation 2
    (5, 672, 160, True, "HS", 1, 2),
    (5, 960, 160, True, "HS", 1, 2),
    (5, 960, 160, True, "HS", 1, 2),
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def avg_pool2(x):
    """AvgPool2d(2, 2, ceil_mode=True, count_include_pad=False)."""
    return F.avg_pool2d(x, 2, 2, ceil_mode=True, count_include_pad=False)


def resize_bilinear(x, size: Tuple[int, int]):
    """F.interpolate bilinear, align_corners off, no antialias (JAX's
    ``resize_bilinear`` turns antialias off to match)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)


def cna(cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1,
        dilation: int = 1, act=None) -> nn.Sequential:
    """conv (padding ((k - 1) // 2) x dilation, no bias) -> BN [-> act]."""
    pad = ((k - 1) // 2) * dilation
    layers = [nn.Conv2d(cin, cout, k, stride, pad, dilation=dilation,
                        groups=groups, bias=False), nn.BatchNorm2d(cout)]
    return nn.Sequential(*layers, *([act()] if act is not None else []))


class SqueezeExcitation(nn.Module):
    def __init__(self, ch: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(ch, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, ch, 1)

    def forward(self, x):
        s = F.relu(self.fc1(x.mean((2, 3), keepdim=True)))
        return x * F.hardsigmoid(self.fc2(s))


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, spec):
        super().__init__()
        k, exp, out, use_se, act_name, stride, dil = spec
        act = nn.Hardswish if act_name == "HS" else nn.ReLU
        layers = []
        if exp != cin:
            layers.append(cna(cin, exp, 1, act=act))
        layers.append(cna(exp, exp, k, stride=stride, groups=exp,
                          dilation=dil, act=act))
        if use_se:
            layers.append(SqueezeExcitation(exp, make_divisible(exp // 4)))
        layers.append(cna(exp, out, 1))
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == out

    def forward(self, x):
        h = self.block(x)
        return x + h if self.residual else h


class MobileNetV3LargeEncoder(nn.Module):
    """normalised [B, 3, H, W] -> (f1 /2 16ch, f2 /4 24ch, f3 /8 40ch,
    f4 /16 960ch)."""

    def __init__(self):
        super().__init__()
        feats = [cna(3, 16, 3, stride=2, act=nn.Hardswish)]
        cin = 16
        for spec in MBV3_LARGE:
            feats.append(InvertedResidual(cin, spec))
            cin = spec[2]
        feats.append(cna(160, 960, 1, act=nn.Hardswish))
        self.features = nn.Sequential(*feats)

    def forward(self, x):
        mean = x.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
        std = x.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
        x = (x - mean) / std
        out = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in (1, 3, 6):
                out.append(x)
        return (*out, x)


class LRASPP(nn.Module):
    """aspp1: 1x1 conv -> BN -> relu; aspp2: mean -> 1x1 conv (no bias, as
    the official file) -> sigmoid; their product."""

    def __init__(self, cin: int = 960, cout: int = 128):
        super().__init__()
        self.aspp1 = cna(cin, cout, 1, act=nn.ReLU)
        self.aspp2 = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                   nn.Conv2d(cin, cout, 1, bias=False),
                                   nn.Sigmoid())

    def forward(self, x):
        return self.aspp1(x) * self.aspp2(x)


class ConvGRU(nn.Module):
    """r, z = sigmoid(conv(x ++ h)); c = tanh(conv(x ++ r h));
    h' = (1 - z) h + z c (h = 0 on the first frame)."""

    def __init__(self, ch: int):
        super().__init__()
        self.ih = nn.Sequential(nn.Conv2d(ch * 2, ch * 2, 3, padding=1),
                                nn.Sigmoid())
        self.hh = nn.Sequential(nn.Conv2d(ch * 2, ch, 3, padding=1),
                                nn.Tanh())

    def forward(self, x, h):
        if h is None:
            h = torch.zeros_like(x)
        r, z = self.ih(torch.cat([x, h], 1)).split(x.size(1), 1)
        c = self.hh(torch.cat([x, r * h], 1))
        h = (1 - z) * h + z * c
        return h


def _gru_half(gru: ConvGRU, x, r):
    """GRU on the second half of the channels (the bottleneck and
    upsampling blocks)."""
    a, b = x.split(x.size(1) // 2, 1)
    r = gru(b, r)
    return torch.cat([a, r], 1), r


class BottleneckBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.gru = ConvGRU(ch // 2)

    def forward(self, x, r):
        return _gru_half(self.gru, x, r)


class UpsamplingBlock(nn.Module):
    def __init__(self, cin: int, cskip: int, csrc: int, cout: int):
        super().__init__()
        self.conv = cna(cin + cskip + csrc, cout, 3, act=nn.ReLU)
        self.gru = ConvGRU(cout // 2)

    def forward(self, x, f, s, r):
        x = resize_bilinear(x, s.shape[2:])
        return _gru_half(self.gru, self.conv(torch.cat([x, f, s], 1)), r)


class OutputBlock(nn.Module):
    def __init__(self, cin: int, csrc: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(*cna(cin + csrc, cout, 3, act=nn.ReLU),
                                  *cna(cout, cout, 3, act=nn.ReLU))

    def forward(self, x, s):
        x = resize_bilinear(x, s.shape[2:])
        return self.conv(torch.cat([x, s], 1))


class RecurrentDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.decode4 = BottleneckBlock(128)
        self.decode3 = UpsamplingBlock(128, 40, 3, 80)
        self.decode2 = UpsamplingBlock(80, 24, 3, 40)
        self.decode1 = UpsamplingBlock(40, 16, 3, 32)
        self.decode0 = OutputBlock(32, 3, 16)

    def forward(self, s0, f1, f2, f3, f4, rec):
        r1, r2, r3, r4 = rec
        s1 = avg_pool2(s0)
        s2 = avg_pool2(s1)
        s3 = avg_pool2(s2)
        x4, r4 = self.decode4(f4, r4)
        x3, r3 = self.decode3(x4, f3, s3, r3)
        x2, r2 = self.decode2(x3, f2, s2, r2)
        x1, r1 = self.decode1(x2, f1, s1, r1)
        return self.decode0(x1, s0), (r1, r2, r3, r4)


class Projection(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class DeepGuidedFilterRefiner(nn.Module):
    """Solve the guided filter's A, b at low resolution, apply them at full
    resolution (RVM deep_guided_filter.py)."""

    def __init__(self, hid: int = 16):
        super().__init__()
        self.box_filter = nn.Conv2d(4, 4, 3, padding=1, bias=False, groups=4)
        nn.init.constant_(self.box_filter.weight, 1 / 9)
        self.conv = nn.Sequential(*cna(8 + hid, hid, 1, act=nn.ReLU),
                                  *cna(hid, hid, 1, act=nn.ReLU),
                                  nn.Conv2d(hid, 4, 1))

    def forward(self, fine_src, base_src, base_fgr, base_pha, base_hid):
        fx = torch.cat([fine_src, fine_src.mean(1, keepdim=True)], 1)
        bx = torch.cat([base_src, base_src.mean(1, keepdim=True)], 1)
        by = torch.cat([base_fgr, base_pha], 1)
        mean_x = self.box_filter(bx)
        mean_y = self.box_filter(by)
        cov_xy = self.box_filter(bx * by) - mean_x * mean_y
        var_x = self.box_filter(bx * bx) - mean_x * mean_x
        A = self.conv(torch.cat([cov_xy, var_x, base_hid], 1))
        b = mean_y - A * mean_x
        hw = fine_src.shape[2:]
        out = resize_bilinear(A, hw) * fx + resize_bilinear(b, hw)
        return out.split([3, 1], 1)


Rec = Tuple[Optional[torch.Tensor], ...]


class MattingNetwork(nn.Module):
    """src [B, 3, H, W] in [0, 1] -> (fgr [B, 3, H, W], pha [B, 1, H, W],
    the 4 recurrent states) (JAX ``rvm_forward``)."""

    def __init__(self):
        super().__init__()
        self.backbone = MobileNetV3LargeEncoder()
        self.aspp = LRASPP()
        self.decoder = RecurrentDecoder()
        self.project_mat = Projection(16, 4)
        self.refiner = DeepGuidedFilterRefiner()

    def forward(self, src, rec: Sequence = (None,) * 4,
                downsample_ratio: float = 1.0):
        if downsample_ratio != 1.0:
            h = int(round(src.shape[2] * downsample_ratio))
            w = int(round(src.shape[3] * downsample_ratio))
            src_sm = resize_bilinear(src, (h, w))
        else:
            src_sm = src
        f1, f2, f3, f4 = self.backbone(src_sm)
        f4 = self.aspp(f4)
        hid, rec = self.decoder(src_sm, f1, f2, f3, f4, tuple(rec))
        fgr_residual, pha = self.project_mat(hid).split([3, 1], 1)
        if downsample_ratio != 1.0:
            fgr_residual, pha = self.refiner(src, src_sm, fgr_residual, pha,
                                             hid)
        fgr = (fgr_residual + src).clamp(0.0, 1.0)
        return fgr, pha.clamp(0.0, 1.0), rec


def seeded_rvm(seed: int) -> MattingNetwork:
    """A seeded network on the CPU, in eval mode. The box filter keeps its
    1/9 weights; the projection and the refiner's last conv are scaled by a
    tenth and the alpha's projection bias is 0.5, so the matte is about one
    half plus the seeded variation: neither blank nor full."""
    net = seed_(MattingNetwork(), seed)
    with torch.no_grad():
        nn.init.constant_(net.refiner.box_filter.weight, 1 / 9)
        net.project_mat.conv.weight.mul_(0.1)
        net.project_mat.conv.bias[3] = 0.5
        net.refiner.conv[-1].weight.mul_(0.1)
    return net


def read_rvm_state_dict(path: str):
    """``rvm_mobilenetv3.pth``: a torch state dict, or a TorchScript
    archive of the network (which ``torch.load`` refuses)."""
    try:
        return read_state_dict(path)
    except RuntimeError:
        return torch.jit.load(path, map_location="cpu").state_dict()


def load_rvm_weights(path: str, device: DeviceLike = None) -> MattingNetwork:
    """The official weights file -> the network on ``device`` (JAX
    ``load_rvm_weights``)."""
    return load_reference(MattingNetwork(), read_rvm_state_dict(path)).to(
        resolve_device(device))
