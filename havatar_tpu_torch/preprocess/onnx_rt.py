"""Minimal ONNX runtime on torch: a protobuf wire-format parser and an op
executor.

Port of ``havatar_tpu/preprocess/onnx_rt.py``. The reference drives its face
tracker through onnxruntime sessions over the shipped ``.onnx`` blobs
(OpenSeeFace/tracker.py:498-560, retinaface.py:61-80). ONNX is plain
protobuf and those blobs use a small mobile-net op set, so this module
parses ``ModelProto`` off the wire (field numbers from the stable
onnx.proto3 schema; the parser is a copy of the JAX module's) and runs the
graph with torch ops in NCHW on the port's device: the reference's own
weights run with no onnxruntime. Shape plumbing (Shape, Gather, Concat,
Slice, Unsqueeze, Cast on constants) stays in numpy, as in JAX's executor,
so the sizes Conv, Resize and Reshape read stay static.

Where the executors differ: ONNX ``pads`` (and ``auto_pad``) may be
asymmetric, and ``F.conv2d`` / ``F.max_pool2d`` pad symmetrically, so an
asymmetric pad is applied with ``F.pad`` first; pools honour ``ceil_mode``
(JAX's executor ignores it); a linear ``Resize`` takes
``coordinate_transformation_mode`` ``half_pixel`` / ``pytorch_half_pixel``
(``align_corners=False``) or ``align_corners``, never antialiased, and
other modes raise where JAX's executor falls back to half_pixel (and
antialiases a downscale); ``Gemm`` takes ``alpha`` and ``beta``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from havatar_tpu_torch.device import DeviceLike, resolve_device

# ---------------------------------------------------------------------------
# Protobuf wire parsing (only what ModelProto needs)
# ---------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) triples; value is int for
    varint/fixed, memoryview for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
           7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = 1
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int_data: List[int] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            dims.append(val)
        elif fnum == 2:
            dtype = val
        elif fnum == 4:      # packed float_data
            float_data.extend(np.frombuffer(bytes(val), "<f4"))
        elif fnum in (5, 7):  # packed int32/int64 varints
            p = 0
            mv = memoryview(val)
            while p < len(mv):
                v, p = _read_varint(mv, p)
                int_data.append(v)
        elif fnum == 8:
            name = bytes(val).decode()
        elif fnum == 9:
            raw = bytes(val)
    np_dt = _DTYPES[dtype]
    if raw is not None:
        arr = np.frombuffer(raw, np_dt)
    elif float_data:
        arr = np.asarray(float_data, np_dt)
    else:
        arr = np.asarray(int_data).astype(np_dt)
    return name, arr.reshape(dims) if dims else arr


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]          # graph inputs that are NOT initializers
    outputs: List[str]
    input_shapes: Dict[str, List[int]] = field(default_factory=dict)


def _parse_attr(buf: memoryview) -> Tuple[str, Any]:
    name = ""
    val: Any = None
    ints: List[int] = []
    floats: List[float] = []
    for fnum, wtype, v in _fields(buf):
        if fnum == 1:
            name = bytes(v).decode()
        elif fnum == 2:
            val = struct.unpack("<f", struct.pack("<I", v))[0]
        elif fnum == 3:
            # varint is two's-complement-encoded for negative ints
            val = v - (1 << 64) if v >= (1 << 63) else v
        elif fnum == 4:
            val = bytes(v).decode(errors="replace")
        elif fnum == 5:
            val = _parse_tensor(v)[1]
        elif fnum == 7:
            if wtype == 2:   # packed
                floats.extend(np.frombuffer(bytes(v), "<f4"))
            else:
                floats.append(struct.unpack("<f", struct.pack("<I", v))[0])
        elif fnum == 8:
            if wtype == 2:   # packed varints
                p = 0
                mv = memoryview(v)
                while p < len(mv):
                    x, p = _read_varint(mv, p)
                    ints.append(x - (1 << 64) if x >= (1 << 63) else x)
            else:
                ints.append(v - (1 << 64) if v >= (1 << 63) else v)
    if ints:
        val = ints
    elif floats:
        val = floats
    return name, val


def _parse_node(buf: memoryview) -> OnnxNode:
    node = OnnxNode("", [], [], {})
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            node.inputs.append(bytes(val).decode())
        elif fnum == 2:
            node.outputs.append(bytes(val).decode())
        elif fnum == 4:
            node.op_type = bytes(val).decode()
        elif fnum == 5:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


def _parse_value_info(buf: memoryview) -> Tuple[str, List[int]]:
    name = ""
    dims: List[int] = []
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            name = bytes(val).decode()
        elif fnum == 2:          # TypeProto
            for f2, _, v2 in _fields(val):
                if f2 == 1:      # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 2:   # shape (TensorShapeProto)
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:   # dim
                                    dv = 0
                                    for f5, _, v5 in _fields(v4):
                                        if f5 == 1:
                                            dv = v5
                                    dims.append(dv)
    return name, dims


def parse_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        data = memoryview(f.read())
    graph_buf = None
    for fnum, _, val in _fields(data):
        if fnum == 7:
            graph_buf = val
    if graph_buf is None:
        raise ValueError("no GraphProto in model")
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    g_inputs: List[Tuple[str, List[int]]] = []
    g_outputs: List[str] = []
    for fnum, _, val in _fields(graph_buf):
        if fnum == 1:
            nodes.append(_parse_node(val))
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif fnum == 11:
            g_inputs.append(_parse_value_info(val))
        elif fnum == 12:
            g_outputs.append(_parse_value_info(val)[0])
    inputs = [n for n, _ in g_inputs if n not in inits]
    shapes = {n: d for n, d in g_inputs if n not in inits}
    return OnnxGraph(nodes, inits, inputs, g_outputs, shapes)



# ---------------------------------------------------------------------------
# Executor (NCHW, torch ops on the model's device)
# ---------------------------------------------------------------------------

def _auto_pad(attrs, kh, kw):
    """((top, bottom), (left, right)) from ``pads`` or a SAME ``auto_pad``
    (stride-1 SAME, as the mobile nets use)."""
    pads = attrs.get("pads", [0, 0, 0, 0])
    ap = attrs.get("auto_pad", "NOTSET")
    if ap in ("SAME_UPPER", "SAME_LOWER"):
        ph, pw = (kh - 1), (kw - 1)
        lo_h, lo_w = ph // 2, pw // 2
        if ap == "SAME_LOWER":
            lo_h, lo_w = ph - ph // 2, pw - pw // 2
        return [(lo_h, ph - lo_h), (lo_w, pw - lo_w)]
    return [(pads[0], pads[2]), (pads[1], pads[3])]


def _np_like(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, list, tuple))


def _pad_first(x, pads, value: float = 0.0):
    """(x, symmetric padding for the op): an asymmetric pad goes through
    ``F.pad`` and the op then pads nothing."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


_FUSED_ACT = {
    "Relu": lambda y, ap: F.relu(y),
    "LeakyRelu": lambda y, ap: F.leaky_relu(y, ap[0] if ap else 0.01),
    "Clip": lambda y, ap: y.clamp(ap[0], ap[1]),
    "Sigmoid": lambda y, ap: torch.sigmoid(y),
    "Tanh": lambda y, ap: torch.tanh(y),
    "HardSigmoid": lambda y, ap: (y * (ap[0] if ap else 0.2)
                                  + (ap[1] if len(ap) > 1 else 0.5)).clamp(0, 1),
}


_CAST = {1: (np.float32, torch.float32), 6: (np.int32, torch.int32),
         7: (np.int64, torch.int64), 10: (np.float16, torch.float16),
         11: (np.float64, torch.float64)}


def _run_node(node: OnnxNode, vals: Dict[str, Any], device: torch.device):
    op = node.op_type
    a = node.attrs
    x = [vals[n] if n else None for n in node.inputs]
    # shape plumbing stays in numpy (see the module docstring)
    all_np = all(v is None or _np_like(v) for v in x)

    def t(v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.as_tensor(np.asarray(v), device=device)

    def out(v):
        vals[node.outputs[0]] = v

    if op in ("Conv", "FusedConv"):
        w = t(x[1])
        kh, kw = w.shape[2], w.shape[3]
        xin, pad = _pad_first(t(x[0]), _auto_pad(a, kh, kw))
        b = t(x[2]) if len(x) > 2 and x[2] is not None else None
        y = F.conv2d(xin, w, b, tuple(a.get("strides", [1, 1])), pad,
                     tuple(a.get("dilations", [1, 1])), a.get("group", 1))
        if op == "FusedConv":
            # onnxruntime's com.microsoft fusion: Conv + activation
            act = a.get("activation", "")
            if act and act not in _FUSED_ACT:
                raise NotImplementedError(f"FusedConv activation {act}")
            if act:
                y = _FUSED_ACT[act](y, a.get("activation_params", []))
        out(y)
    elif op == "Relu":
        out(F.relu(t(x[0])))
    elif op == "LeakyRelu":
        out(F.leaky_relu(t(x[0]), a.get("alpha", 0.01)))
    elif op == "Clip":
        lo = a.get("min", x[1] if len(x) > 1 and x[1] is not None else None)
        hi = a.get("max", x[2] if len(x) > 2 and x[2] is not None else None)
        out(t(x[0]).clamp(None if lo is None else float(np.asarray(lo)),
                          None if hi is None else float(np.asarray(hi))))
    elif op == "Sigmoid":
        out(torch.sigmoid(t(x[0])))
    elif op == "HardSigmoid":
        al, be = a.get("alpha", 0.2), a.get("beta", 0.5)
        out((al * t(x[0]) + be).clamp(0.0, 1.0))
    elif op == "HardSwish":
        y = t(x[0])
        out(y * (y / 6.0 + 0.5).clamp(0.0, 1.0))
    elif op in ("Add", "Sum", "Sub", "Mul", "Div"):
        fn = {"Add": np.add, "Sum": np.add, "Sub": np.subtract,
              "Mul": np.multiply, "Div": np.divide}[op]
        if all_np:
            out(fn(x[0], x[1]))
        else:
            fn = {"Add": torch.add, "Sum": torch.add, "Sub": torch.sub,
                  "Mul": torch.mul, "Div": torch.div}[op]
            out(fn(t(x[0]), t(x[1])))
    elif op == "Exp":
        out(torch.exp(t(x[0])))
    elif op == "Sqrt":
        out(torch.sqrt(t(x[0])))
    elif op == "GlobalAveragePool":
        out(t(x[0]).mean((2, 3), keepdim=True))
    elif op == "ReduceMean":
        axes = tuple(a.get("axes", [2, 3]))
        out(t(x[0]).mean(axes, keepdim=bool(a.get("keepdims", 1))))
    elif op in ("AveragePool", "MaxPool"):
        kh, kw = a["kernel_shape"]
        strides = tuple(a.get("strides", [1, 1]))
        ceil = bool(a.get("ceil_mode", 0))
        pads = _auto_pad(a, kh, kw)
        (pt, pb), (pl, pr) = pads
        xin = t(x[0])
        if op == "MaxPool":
            xin, pad = _pad_first(xin, pads, float("-inf"))
            out(F.max_pool2d(xin, (kh, kw), strides, pad, ceil_mode=ceil))
        else:
            # the mean over the window's elements inside the input (ONNX's
            # count_include_pad = 0), as JAX's executor: pooled sums of the
            # zero-padded input over pooled sums of the padded ones
            xin = F.pad(xin, (pl, pr, pt, pb))
            ones = F.pad(torch.ones_like(t(x[0])[:1, :1]), (pl, pr, pt, pb))
            pool = lambda v: F.avg_pool2d(v, (kh, kw), strides,  # noqa: E731
                                          ceil_mode=ceil)
            out(pool(xin) / pool(ones))
    elif op in ("Resize", "Upsample"):
        xin = t(x[0])
        mode = a.get("mode", "nearest")
        if op == "Resize":
            sizes = x[3] if len(x) > 3 and x[3] is not None else None
            scales = x[2] if len(x) > 2 and x[2] is not None else None
        else:
            sizes, scales = None, x[1]
        if sizes is not None and np.asarray(sizes).size:
            oh, ow = int(sizes[2]), int(sizes[3])
        else:
            sc = np.asarray(scales)
            oh = int(round(xin.shape[2] * float(sc[2])))
            ow = int(round(xin.shape[3] * float(sc[3])))
        if mode.startswith("nearest"):
            # the index floor(i * H / oh), as JAX's executor
            iy = torch.arange(oh, device=xin.device) * xin.shape[2] // oh
            ix = torch.arange(ow, device=xin.device) * xin.shape[3] // ow
            out(xin.index_select(2, iy).index_select(3, ix))
        elif mode in ("linear", "bilinear"):
            ct = a.get("coordinate_transformation_mode", "half_pixel")
            if ct not in ("half_pixel", "pytorch_half_pixel", "align_corners"):
                raise NotImplementedError(
                    f"ONNX {op} linear coordinate_transformation_mode {ct}")
            out(F.interpolate(xin, size=(oh, ow), mode="bilinear",
                              align_corners=ct == "align_corners",
                              antialias=False))
        else:
            raise NotImplementedError(f"ONNX {op} mode {mode}")
    elif op == "Concat":
        if all_np:
            out(np.concatenate([np.asarray(v) for v in x], axis=a["axis"]))
        else:
            out(torch.cat([t(v) for v in x], a["axis"]))
    elif op == "Reshape":
        shape = [int(s) for s in np.asarray(x[1])]
        cur = x[0]
        shape = [cur.shape[i] if s == 0 else s for i, s in enumerate(shape)]
        out(np.reshape(cur, shape) if all_np else t(cur).reshape(shape))
    elif op == "Flatten":
        ax = a.get("axis", 1)
        out(t(x[0]).reshape(int(np.prod(x[0].shape[:ax])), -1))
    elif op == "Transpose":
        out(t(x[0]).permute(*a["perm"]))
    elif op == "Softmax":
        out(torch.softmax(t(x[0]), a.get("axis", -1)))
    elif op == "Gemm":
        y, w = t(x[0]), t(x[1])
        if a.get("transB", 0):
            w = w.T
        if a.get("transA", 0):
            y = y.T
        y = a.get("alpha", 1.0) * (y @ w)
        if len(x) > 2 and x[2] is not None:
            y = y + a.get("beta", 1.0) * t(x[2])
        out(y)
    elif op == "MatMul":
        out(t(x[0]) @ t(x[1]))
    elif op == "Slice":
        if "starts" in a:
            starts, ends = a["starts"], a["ends"]
            axes = a.get("axes", list(range(len(starts))))
            steps = [1] * len(starts)
        else:
            starts = [int(v) for v in np.asarray(x[1])]
            ends = [int(v) for v in np.asarray(x[2])]
            axes = ([int(v) for v in np.asarray(x[3])]
                    if len(x) > 3 and x[3] is not None else list(range(len(starts))))
            steps = ([int(v) for v in np.asarray(x[4])]
                     if len(x) > 4 and x[4] is not None else [1] * len(starts))
        sl = [slice(None)] * x[0].ndim
        for s, e, ax, st in zip(starts, ends, axes, steps):
            sl[ax] = slice(s, None if e >= (1 << 62) else e, st)
        out(x[0][tuple(sl)])
    elif op == "Split":
        ax = a.get("axis", 0)
        if "split" in a:
            sizes = a["split"]
        elif len(x) > 1 and x[1] is not None:
            sizes = [int(v) for v in np.asarray(x[1])]
        else:
            n = len(node.outputs)
            sizes = [x[0].shape[ax] // n] * n
        off = 0
        for o, s in zip(node.outputs, sizes):
            sl = [slice(None)] * x[0].ndim
            sl[ax] = slice(off, off + s)
            vals[o] = x[0][tuple(sl)]
            off += s
    elif op == "Shape":
        out(np.asarray(x[0].shape, np.int64))
    elif op == "Gather":
        ax = a.get("axis", 0)
        if all_np:
            out(np.take(np.asarray(x[0]), np.asarray(x[1]), axis=ax))
        else:
            idx = torch.as_tensor(np.asarray(x[1]), device=device).long()
            src = t(x[0])
            y = src.index_select(ax, idx.reshape(-1))
            out(y.reshape(src.shape[:ax] + idx.shape + src.shape[ax + 1:]))
    elif op == "Unsqueeze":
        axes = a.get("axes") or [int(v) for v in np.asarray(x[1])]
        y = x[0]
        for ax in sorted(axes):
            y = np.expand_dims(y, ax) if all_np else t(y).unsqueeze(ax)
        out(y)
    elif op == "Squeeze":
        axes = a.get("axes") or ([int(v) for v in np.asarray(x[1])]
                                 if len(x) > 1 and x[1] is not None else None)
        if all_np:
            out(np.squeeze(x[0], axis=tuple(axes) if axes else None))
        else:
            y = t(x[0])
            out(y.squeeze(tuple(axes)) if axes else y.squeeze())
    elif op == "Cast":
        np_to, torch_to = _CAST[a["to"]]
        out(np.asarray(x[0]).astype(np_to) if all_np else t(x[0]).to(torch_to))
    elif op == "Constant":
        out(a["value"])
    elif op == "Identity":
        out(x[0])
    elif op == "BatchNormalization":
        scale, b, mean, var = (np.asarray(v) for v in x[1:5])
        inv = scale / np.sqrt(var + a.get("epsilon", 1e-5))
        out(t(x[0]) * t(inv.reshape(1, -1, 1, 1).astype(np.float32))
            + t((b - mean * inv).reshape(1, -1, 1, 1).astype(np.float32)))
    elif op == "Pad":
        mode = a.get("mode", "constant")
        pads = a.get("pads") or [int(v) for v in np.asarray(x[1])]
        nd = x[0].ndim
        # F.pad takes (last dim lo, hi, next-to-last lo, hi, ...)
        cfg = []
        for i in reversed(range(nd)):
            cfg += [pads[i], pads[i + nd]]
        y = t(x[0])
        if mode == "constant":
            out(F.pad(y, cfg))
        else:   # "edge", as JAX's executor takes every other mode
            out(F.pad(y, cfg[:4], mode="replicate"))
    elif op == "PRelu":
        slope = t(x[1])
        if slope.ndim == 3:      # [C, 1, 1] per-channel
            slope = slope.reshape(1, -1, 1, 1)
        y = t(x[0])
        out(torch.where(y >= 0, y, slope * y))
    else:
        raise NotImplementedError(f"ONNX op {op}")


# the inputs that are weights: float initializers in these slots move to the
# device once, when the model is built
_WEIGHT_SLOTS = {"Conv": (1, 2), "FusedConv": (1, 2), "Gemm": (1, 2),
                 "MatMul": (1,), "PRelu": (1,)}


class OnnxModel:
    """Parsed, executable model on ``device``: ``model(*inputs)`` takes NCHW
    tensors (or arrays) and returns the graph outputs (a tuple if several).
    ``path`` is an ``.onnx`` file or an ``OnnxGraph`` built in code."""

    def __init__(self, path: Union[str, OnnxGraph], device: DeviceLike = None):
        self.device = resolve_device(device)
        self.graph = path if isinstance(path, OnnxGraph) else parse_onnx(path)
        g = self.graph
        self._values: Dict[str, Any] = dict(g.initializers)
        for node in g.nodes:
            for i in _WEIGHT_SLOTS.get(node.op_type, ()):
                name = node.inputs[i] if i < len(node.inputs) else ""
                arr = g.initializers.get(name)
                if arr is not None and arr.dtype == np.float32:
                    self._values[name] = torch.tensor(arr, device=self.device)

    @property
    def input_names(self):
        return self.graph.inputs

    def __call__(self, *inputs):
        g = self.graph
        if len(inputs) != len(g.inputs):
            raise ValueError(f"expected {len(g.inputs)} inputs {g.inputs}")
        vals: Dict[str, Any] = dict(self._values)
        for name, v in zip(g.inputs, inputs):
            vals[name] = torch.as_tensor(v, device=self.device)
        with torch.inference_mode():
            for node in g.nodes:
                _run_node(node, vals, self.device)
        outs = tuple(vals[n] for n in g.outputs)
        return outs if len(outs) > 1 else outs[0]

    def ops_used(self):
        return sorted({n.op_type for n in self.graph.nodes})
