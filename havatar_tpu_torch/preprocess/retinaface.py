"""RetinaFace face detector (MobileNet-0.25), its anchors, decode and NMS.

Port of ``havatar_tpu/preprocess/retinaface.py``. Behavioural spec: the
reference's ``RetinaFaceDetector`` (data_preprocessing/OpenSeeFace/
retinaface.py:61-124): 640^2 BGR-mean input, the net's (loc [N, 4], conf
[N, 2]), the prior-box decode with variances (0.1, 0.2), a score
threshold, NMS, top-k and the (0.15, 0.2) margin. ``make_priorbox``,
``decode_boxes`` and ``nms`` are numpy copies of the JAX module's.

``RetinaFace`` is the standard RetinaFace-MobileNet0.25 (Deng et al. 2019):
a MobileNetV1-0.25 backbone (stages at /8, /16, /32), a 3-level FPN, SSH
context modules and per-level class and box heads with 2 anchors a cell,
in the PyTorch_Retinaface key layout that JAX's
``convert_torch_retinaface`` reads (body.stageN, fpn, sshN, ClassHead,
BboxHead), each BatchNorm in eval mode beside its conv. The detector
(JAX: ``JaxRetinaFaceDetector``) is ``RetinaFaceDetector``.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from havatar_tpu_torch.device import DeviceLike, resolve_device

MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STEPS = (8, 16, 32)
VARIANCES = (0.1, 0.2)


def make_priorbox(res: Tuple[int, int] = (640, 640)) -> np.ndarray:
    """[N, 4] (cx, cy, w, h) anchors, normalised: the content of the
    reference's priorbox_640x640.json."""
    w, h = res
    out = []
    for sizes, step in zip(MIN_SIZES, STEPS):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        for i in range(fh):
            for j in range(fw):
                for m in sizes:
                    out.append([(j + 0.5) * step / w, (i + 0.5) * step / h,
                                m / w, m / h])
    return np.asarray(out, np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray,
                 variances=VARIANCES) -> np.ndarray:
    """Anchor-relative regression -> (x1, y1, x2, y2)
    (spec: retinaface.py:45-53)."""
    centers = priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:]
    sizes = priors[:, 2:] * np.exp(loc[:, 2:] * variances[1])
    boxes = np.concatenate([centers, sizes], 1)
    boxes[:, :2] -= boxes[:, 2:] / 2
    boxes[:, 2:] += boxes[:, :2]
    return boxes


def nms(dets: np.ndarray, thresh: float) -> List[int]:
    """Greedy IoU NMS with the reference's +1 box-area convention
    (spec: retinaface.py:11-43)."""
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep: List[int] = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return keep


# ---------------------------------------------------------------------------
# The net (NCHW)
# ---------------------------------------------------------------------------

def conv_bn(cin: int, cout: int, k: int = 3, stride: int = 1,
            groups: int = 1, leaky: bool = True) -> nn.Sequential:
    """conv (k // 2 padding, no bias) -> BN [-> leaky 0.1]."""
    layers = [nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups,
                        bias=False), nn.BatchNorm2d(cout)]
    return nn.Sequential(*layers, *([nn.LeakyReLU(0.1)] if leaky else []))


def conv_dw(cin: int, cout: int, stride: int) -> nn.Sequential:
    """MobileNetV1 depthwise-separable block: dw3x3 -> BN -> leaky, pw1x1
    -> BN -> leaky (keys .0/.1 and .3/.4)."""
    return nn.Sequential(*conv_bn(cin, cin, 3, stride, groups=cin),
                         *conv_bn(cin, cout, 1))


def upsample_nearest(x, size: Tuple[int, int]):
    """Nearest resize by the integer index floor(i * H / oh), as JAX's
    ``_upsample_nearest``; ``F.interpolate``'s nearest mode computes its
    scale in floating point and can pick another row at ratios that are not
    integers."""
    H, W = x.shape[2:]
    oh, ow = size
    iy = torch.arange(oh, device=x.device) * H // oh
    ix = torch.arange(ow, device=x.device) * W // ow
    return x.index_select(2, iy).index_select(3, ix)


class SSH(nn.Module):
    """SSH context module: 3x3 ++ (5x5 as two 3x3) ++ (7x7 as three 3x3),
    relu on the concat."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv3X3 = conv_bn(cin, cout // 2, leaky=False)
        self.conv5X5_1 = conv_bn(cin, cout // 4)
        self.conv5X5_2 = conv_bn(cout // 4, cout // 4, leaky=False)
        self.conv7X7_2 = conv_bn(cout // 4, cout // 4)
        self.conv7X7_3 = conv_bn(cout // 4, cout // 4, leaky=False)

    def forward(self, x):
        c5_1 = self.conv5X5_1(x)
        c7 = self.conv7X7_3(self.conv7X7_2(c5_1))
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1), c7], 1))


class _Head(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(cin, cout, 1)


class RetinaFace(nn.Module):
    """[B, 3, H, W] mean-subtracted BGR -> (loc [B, N, 4], conf [B, N, 2]
    softmaxed), N anchors level-major, cell-major, anchor-minor (the prior
    box order). Widths of mobilenet0.25: the backbone's first 8, the
    FPN's 64."""

    def __init__(self):
        super().__init__()
        c, fpn = 8, 64
        body = nn.Module()
        body.stage1 = nn.Sequential(
            conv_bn(3, c, 3, 2), conv_dw(c, c * 2, 1),
            conv_dw(c * 2, c * 4, 2), conv_dw(c * 4, c * 4, 1),
            conv_dw(c * 4, c * 8, 2), conv_dw(c * 8, c * 8, 1))
        body.stage2 = nn.Sequential(
            conv_dw(c * 8, c * 16, 2),
            *[conv_dw(c * 16, c * 16, 1) for _ in range(5)])
        body.stage3 = nn.Sequential(conv_dw(c * 16, c * 32, 2),
                                    conv_dw(c * 32, c * 32, 1))
        self.body = body
        f = nn.Module()
        f.output1 = conv_bn(c * 8, fpn, 1)
        f.output2 = conv_bn(c * 16, fpn, 1)
        f.output3 = conv_bn(c * 32, fpn, 1)
        f.merge1 = conv_bn(fpn, fpn)
        f.merge2 = conv_bn(fpn, fpn)
        self.fpn = f
        self.ssh1, self.ssh2, self.ssh3 = SSH(fpn, fpn), SSH(fpn, fpn), SSH(fpn, fpn)
        self.ClassHead = nn.ModuleList([_Head(fpn, 2 * 2) for _ in range(3)])
        self.BboxHead = nn.ModuleList([_Head(fpn, 2 * 4) for _ in range(3)])

    def forward(self, x):
        s1 = self.body.stage1(x)
        s2 = self.body.stage2(s1)
        s3 = self.body.stage3(s2)
        o1 = self.fpn.output1(s1)
        o2 = self.fpn.output2(s2)
        o3 = self.fpn.output3(s3)
        o2 = self.fpn.merge2(o2 + upsample_nearest(o3, o2.shape[2:]))
        o1 = self.fpn.merge1(o1 + upsample_nearest(o2, o1.shape[2:]))
        feats = (self.ssh1(o1), self.ssh2(o2), self.ssh3(o3))
        B = x.shape[0]
        loc = torch.cat([h.conv1x1(f).permute(0, 2, 3, 1).reshape(B, -1, 4)
                         for h, f in zip(self.BboxHead, feats)], 1)
        conf = torch.cat([h.conv1x1(f).permute(0, 2, 3, 1).reshape(B, -1, 2)
                          for h, f in zip(self.ClassHead, feats)], 1)
        return loc, F.softmax(conf, -1)


# ---------------------------------------------------------------------------
# Detector driver (spec: retinaface.py:81-119)
# ---------------------------------------------------------------------------

class RetinaFaceDetector:
    """The reference ``RetinaFaceDetector.detect_retina`` (JAX:
    ``JaxRetinaFaceDetector``): ``detect`` returns (x, y, w, h)
    margin-expanded face boxes in frame pixels. ``net`` maps a [1, 3, H, W]
    tensor on ``device`` to (loc, conf): a ``RetinaFace`` or an
    ``OnnxModel`` (``from_onnx``)."""

    def __init__(self, net, res: Tuple[int, int] = (640, 640),
                 min_conf: float = 0.4, nms_threshold: float = 0.4,
                 top_k: int = 1, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.net = net.to(self.device) if isinstance(net, nn.Module) else net
        self.res_w, self.res_h = res
        self.priorbox = make_priorbox(res)
        self.min_conf = min_conf
        self.nms_threshold = nms_threshold
        self.top_k = top_k

    @classmethod
    def from_onnx(cls, path: str, device: DeviceLike = None,
                  **kw) -> "RetinaFaceDetector":
        """The reference's retinaface_640x640_opt.onnx through onnx_rt.py
        (outputs loc, conf and landmarks; the first two are read)."""
        from havatar_tpu_torch.preprocess.onnx_rt import OnnxModel

        model = OnnxModel(path, device=device)
        return cls(lambda x: model(x)[:2], res=(640, 640),
                   device=model.device, **kw)

    def detect(self, frame_rgb: np.ndarray) -> List[Tuple[float, ...]]:
        import cv2

        h, w = frame_rgb.shape[:2]
        im = cv2.resize(frame_rgb, (self.res_w, self.res_h),
                        interpolation=cv2.INTER_LINEAR).astype(np.float32)
        # the reference feeds BGR minus the (104, 117, 123) BGR means
        im = im[:, :, ::-1] - np.array((104.0, 117.0, 123.0), np.float32)
        x = torch.from_numpy(np.ascontiguousarray(im)).to(self.device)
        with torch.inference_mode():
            loc, conf = self.net(x.permute(2, 0, 1)[None])
        loc = loc[0].float().cpu().numpy()
        scores = conf[0, :, 1].float().cpu().numpy()

        boxes = decode_boxes(loc, self.priorbox)
        boxes = boxes * np.array((w, h, w, h), np.float32)
        inds = np.where(scores > self.min_conf)[0]
        dets = np.hstack([boxes[inds], scores[inds, None]]).astype(np.float32)
        keep = nms(dets, self.nms_threshold)
        dets = dets[keep][: self.top_k, 0:4]
        dets[:, 2:4] = dets[:, 2:4] - dets[:, 0:2]
        upsize = dets[:, 2:4] * np.array([[0.15, 0.2]])
        dets[:, 0:2] -= upsize
        dets[:, 2:4] += upsize * 2
        return list(map(tuple, dets))


def load_retinaface_weights(path: str, device: DeviceLike = None) -> RetinaFace:
    """A PyTorch_Retinaface mobilenet0.25 state dict -> the net on
    ``device``."""
    from havatar_tpu_torch.preprocess.nets import load_reference, read_state_dict

    return load_reference(RetinaFace(), read_state_dict(path)).to(
        resolve_device(device))
