"""havatar_tpu_torch.preprocess.onnx_rt against havatar_tpu's on the CPU.

The parser reads a ModelProto encoded here by hand (wire format, field
numbers of onnx.proto3: nodes with int, negative int, float, string,
ints, floats and tensor attributes, initializers as raw and as packed
floats, graph inputs with shapes) into the same graph as JAX's parser, and
both executors run that graph to the same outputs. Every op the executor
takes runs on hand-built nodes against JAX's ``_run_node`` on the same
inputs (atol 1e-5, rtol 1e-5), asymmetric ``pads`` and both SAME
``auto_pad`` modes included, and each ``Resize`` / ``Upsample`` mode JAX's
executor implements; pools with ``ceil_mode`` (which JAX's executor
ignores) are held to a loop over the windows instead.
"""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from havatar_tpu.preprocess import onnx_rt as J
from havatar_tpu_torch.preprocess import onnx_rt as T

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")


# ---- a ModelProto written by hand ------------------------------------------

def varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def ld(num: int, payload: bytes) -> bytes:          # length-delimited
    return varint(num << 3 | 2) + varint(len(payload)) + payload


def vi(num: int, n: int) -> bytes:                  # varint field
    return varint(num << 3) + varint(n)


def tensor(name: str, arr: np.ndarray, packed_floats: bool = False) -> bytes:
    dtype = {np.float32: 1, np.int64: 7}[arr.dtype.type]
    out = b"".join(vi(1, d) for d in arr.shape) + vi(2, dtype)
    out += ld(8, name.encode())
    if packed_floats:
        return out + ld(4, arr.astype("<f4").tobytes())
    return out + ld(9, arr.tobytes())


def attr(name: str, v) -> bytes:
    out = ld(1, name.encode())
    if isinstance(v, float):
        return out + varint(2 << 3 | 5) + struct.pack("<f", v)
    if isinstance(v, int):
        return out + vi(3, v)
    if isinstance(v, str):
        return out + ld(4, v.encode())
    if isinstance(v, np.ndarray):
        return out + ld(5, tensor("", v))
    if isinstance(v[0], float):
        return out + ld(7, struct.pack(f"<{len(v)}f", *v))
    return out + b"".join(vi(8, i) for i in v)


def node(op: str, ins, outs, **attrs) -> bytes:
    return (b"".join(ld(1, i.encode()) for i in ins)
            + b"".join(ld(2, o.encode()) for o in outs) + ld(4, op.encode())
            + b"".join(ld(5, attr(k, v)) for k, v in attrs.items()))


def value_info(name: str, dims) -> bytes:
    shape = b"".join(ld(1, vi(1, d)) for d in dims)
    return ld(1, name.encode()) + ld(2, ld(1, vi(1, 1) + ld(2, shape)))


def model_bytes(nodes, inits: dict, inputs: dict, outputs) -> bytes:
    """A ModelProto: the graph's nodes, initializers, inputs with their
    dims and output names."""
    g = b"".join(ld(1, n) for n in nodes)
    g += b"".join(ld(5, tensor(k, v, packed_floats=k.startswith("p_")))
                  for k, v in inits.items())
    g += b"".join(ld(11, value_info(k, d)) for k, d in inputs.items())
    g += b"".join(ld(12, value_info(o, [])) for o in outputs)
    return vi(1, 7) + ld(7, g)


def write_model(path, *args) -> str:
    with open(path, "wb") as f:
        f.write(model_bytes(*args))
    return str(path)


def small_model(rng) -> bytes:
    nodes = (
        node("Conv", ["x", "w1", "p_b1"], ["c1"], pads=[0, 1, 1, 2],
             strides=[2, 2]),
        node("LeakyRelu", ["c1"], ["a1"], alpha=0.2),
        node("MaxPool", ["a1"], ["p1"], kernel_shape=[2, 2],
             strides=[2, 2]),
        node("Resize", ["p1", "", "sc"], ["r1"], mode="nearest"),
        node("Conv", ["r1", "w2"], ["c2"]),
        node("Softmax", ["c2"], ["s"], axis=-1),
        node("Shape", ["s"], ["sh"]),
        node("Constant", [], ["idx"], value=np.asarray([0, 1], np.int64)),
        node("Gather", ["sh", "idx"], ["hw"], axis=0),
        node("Concat", ["hw", "minus1"], ["tgt"], axis=0),
        node("Reshape", ["s", "tgt"], ["y"]),
        node("HardSigmoid", ["c2"], ["z"], alpha=0.25, beta=0.5))
    inits = {"w1": rng.randn(8, 3, 3, 3).astype(np.float32) * 0.3,
             "p_b1": rng.randn(8).astype(np.float32) * 0.1,
             "w2": rng.randn(4, 8, 1, 1).astype(np.float32) * 0.3,
             "sc": np.asarray([1, 1, 2, 2], np.float32),
             "minus1": np.asarray([-1], np.int64)}
    return model_bytes(nodes, inits, {"x": [1, 3, 16, 16],
                                      "w1": [8, 3, 3, 3]}, ["y", "z"])


def test_parser_and_model_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "m.onnx")
    with open(path, "wb") as f:
        f.write(small_model(rng))
    ours, theirs = T.parse_onnx(path), J.parse_onnx(path)
    assert ours.inputs == theirs.inputs == ["x"]
    assert ours.input_shapes == theirs.input_shapes == {"x": [1, 3, 16, 16]}
    assert ours.outputs == theirs.outputs == ["y", "z"]
    assert [n.op_type for n in ours.nodes] == [n.op_type for n in theirs.nodes]
    for a, b in zip(ours.nodes, theirs.nodes):
        assert (a.inputs, a.outputs) == (b.inputs, b.outputs)
        assert set(a.attrs) == set(b.attrs)
        for k in a.attrs:
            np.testing.assert_array_equal(a.attrs[k], b.attrs[k])
    assert ours.nodes[1].attrs["alpha"] == pytest.approx(0.2)
    assert ours.nodes[5].attrs["axis"] == -1
    assert set(ours.initializers) == set(theirs.initializers)
    for k, v in ours.initializers.items():
        np.testing.assert_array_equal(v, theirs.initializers[k])

    x = rng.randn(1, 3, 16, 16).astype(np.float32)
    model = T.OnnxModel(path, device="cpu")
    assert model.ops_used() == J.OnnxModel(path).ops_used()
    got = model(torch.from_numpy(x))
    want = J.OnnxModel(path)(jnp.asarray(x))
    assert got[0].shape == (1, 4, 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.OnnxModel(path)


# ---- every op, against JAX's executor ----------------------------------------

class C:
    """A constant input: numpy on both sides (shape plumbing)."""

    def __init__(self, v):
        self.v = np.asarray(v)


def run_both(op, inputs, attrs=None, n_out=1):
    names = [f"i{k}" if v is not None else "" for k, v in enumerate(inputs)]
    outs = [f"o{k}" for k in range(n_out)]
    ours, theirs = {}, {}
    for name, v in zip(names, inputs):
        if v is None:
            continue
        if isinstance(v, C):
            ours[name] = theirs[name] = v.v
        else:
            ours[name], theirs[name] = torch.from_numpy(v), jnp.asarray(v)
    T._run_node(T.OnnxNode(op, names, outs, dict(attrs or {})), ours, CPU)
    J._run_node(J.OnnxNode(op, names, outs, dict(attrs or {})), theirs)
    for o in outs:
        g, w = ours[o], theirs[o]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), err_msg=op, **TOL)
    return ours[outs[0]]


R = np.random.RandomState(1)
X = R.randn(2, 4, 9, 11).astype(np.float32)
W = R.randn(6, 2, 3, 3).astype(np.float32) * 0.3
W4 = R.randn(4, 4, 4, 4).astype(np.float32) * 0.2
B = R.randn(6).astype(np.float32)

CONV_CASES = [
    ({"strides": [2, 2], "pads": [1, 1, 1, 1], "group": 2}, W, B),
    ({"pads": [0, 1, 1, 2], "group": 2}, W, None),            # asymmetric
    ({"auto_pad": "SAME_UPPER"}, W4, None),                   # even kernel
    ({"auto_pad": "SAME_LOWER"}, W4, None),
    ({"pads": [2, 2, 2, 2], "dilations": [2, 2], "group": 2}, W, B),
]


@pytest.mark.parametrize("attrs,w,b", CONV_CASES)
def test_conv(attrs, w, b):
    run_both("Conv", [X, C(w)] + ([C(b)] if b is not None else []), attrs)


@pytest.mark.parametrize("act,params", [
    ("Relu", []), ("LeakyRelu", [0.2]), ("Clip", [0.0, 0.5]),
    ("Sigmoid", []), ("Tanh", []), ("HardSigmoid", [0.3, 0.4]), ("", [])])
def test_fused_conv(act, params):
    run_both("FusedConv", [X, C(W), C(B)],
             {"group": 2, "pads": [1, 1, 1, 1], "activation": act,
              "activation_params": params})


@pytest.mark.parametrize("op,attrs", [
    ("MaxPool", {"kernel_shape": [3, 3], "strides": [2, 2],
                 "pads": [1, 1, 1, 1]}),
    ("MaxPool", {"kernel_shape": [2, 3], "pads": [0, 1, 1, 0]}),
    ("AveragePool", {"kernel_shape": [2, 2], "strides": [2, 2]}),
    ("AveragePool", {"kernel_shape": [3, 3], "strides": [2, 1],
                     "pads": [1, 0, 2, 1]}),
    ("AveragePool", {"kernel_shape": [3, 3], "auto_pad": "SAME_UPPER"}),
    ("GlobalAveragePool", {}), ("ReduceMean", {"axes": [2, 3], "keepdims": 0}),
    ("ReduceMean", {"axes": [1], "keepdims": 1})])
def test_pools(op, attrs):
    run_both(op, [X], attrs)


def _pool_loop(x, k, s, pads, ceil, fn):
    """ONNX pooling over the windows, padding excluded from the window."""
    (pt, pb), (pl, pr) = pads
    H, W = x.shape[2:]
    size = lambda L, lo, hi, kk, ss: int(  # noqa: E731
        (np.ceil if ceil else np.floor)((L + lo + hi - kk) / ss)) + 1
    oh, ow = size(H, pt, pb, k[0], s[0]), size(W, pl, pr, k[1], s[1])
    out = np.zeros(x.shape[:2] + (oh, ow), np.float32)
    for i in range(oh):
        for j in range(ow):
            y0, x0 = i * s[0] - pt, j * s[1] - pl
            win = x[:, :, max(y0, 0):min(y0 + k[0], H),
                    max(x0, 0):min(x0 + k[1], W)]
            out[:, :, i, j] = fn(win, axis=(2, 3))
    return out


@pytest.mark.parametrize("op,fn", [("MaxPool", np.max),
                                   ("AveragePool", np.mean)])
def test_pools_ceil_mode(op, fn):
    attrs = {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 0, 0, 1],
             "ceil_mode": 1}
    vals = {"x": torch.from_numpy(X)}
    T._run_node(T.OnnxNode(op, ["x"], ["y"], attrs), vals, CPU)
    want = _pool_loop(X, (3, 3), (2, 2), [(1, 0), (0, 1)], True, fn)
    assert vals["y"].shape == want.shape == (2, 4, 5, 6)
    np.testing.assert_allclose(vals["y"].numpy(), want, **TOL)


@pytest.mark.parametrize("op,inputs,attrs", [
    ("Resize", [X, None, C([1, 1, 2, 2])], {"mode": "nearest"}),
    ("Resize", [X, None, None, C([2, 4, 13, 5])], {"mode": "nearest"}),
    ("Resize", [X, None, C([1, 1, 2, 3])], {"mode": "linear"}),
    ("Resize", [X, None, C([1, 1, 2, 2])],
     {"mode": "linear", "coordinate_transformation_mode": "pytorch_half_pixel"}),
    ("Resize", [X, None, None, C([2, 4, 17, 21])],
     {"mode": "linear", "coordinate_transformation_mode": "align_corners"}),
    ("Resize", [X, None, None, C([2, 4, 5, 4])],
     {"mode": "linear", "coordinate_transformation_mode": "align_corners"}),
    ("Upsample", [X, C([1, 1, 2, 2])], {"mode": "nearest"}),
    ("Upsample", [X, C([1, 1, 3, 2])], {"mode": "linear"})])
def test_resize_modes(op, inputs, attrs):
    """``Resize`` inputs: x, roi (unused), scales, sizes."""
    run_both(op, inputs, attrs)


def test_resize_modes_jax_does_not_take_raise():
    vals = {"x": torch.from_numpy(X), "s": np.asarray([1, 1, 2, 2], np.float32)}
    for attrs in ({"mode": "linear",
                   "coordinate_transformation_mode": "asymmetric"},
                  {"mode": "cubic"}):
        with pytest.raises(NotImplementedError):
            T._run_node(T.OnnxNode("Resize", ["x", "", "s"], ["y"], attrs),
                        vals, CPU)


P = R.randn(2, 4, 9, 11).astype(np.float32)


@pytest.mark.parametrize("op,inputs,attrs", [
    ("Relu", [X], {}), ("LeakyRelu", [X], {"alpha": 0.3}),
    ("Clip", [X], {"min": -0.5, "max": 0.7}),
    ("Clip", [X, C(np.float32(-0.2)), C(np.float32(0.4))], {}),
    ("Sigmoid", [X], {}), ("HardSigmoid", [X], {"alpha": 0.3, "beta": 0.6}),
    ("HardSwish", [X], {}), ("Exp", [X], {}), ("Sqrt", [np.abs(X)], {}),
    ("Add", [X, P], {}), ("Sum", [X, C(np.float32(2.0))], {}),
    ("Sub", [X, C(R.randn(1, 4, 1, 1).astype(np.float32))], {}),
    ("Mul", [X, P], {}), ("Div", [X, C(np.float32(4.0))], {}),
    ("Softmax", [X], {"axis": 1}), ("Transpose", [X], {"perm": [0, 2, 3, 1]}),
    ("Reshape", [X, C(np.asarray([0, 4, -1], np.int64))], {}),
    ("Flatten", [X], {"axis": 2}),
    ("Gemm", [X[0, 0], C(R.randn(7, 11).astype(np.float32)),
              C(R.randn(7).astype(np.float32))], {"transB": 1}),
    ("MatMul", [X, C(R.randn(11, 3).astype(np.float32))], {}),
    ("Concat", [X, P], {"axis": 1}),
    ("Slice", [X, C([1]), C([3]), C([1]), C([1])], {}),
    ("Slice", [X], {"starts": [0, 2], "ends": [1, 1 << 63], "axes": [0, 3]}),
    ("BatchNormalization", [X] + [C(np.abs(R.randn(4)).astype(np.float32) + 0.5)
                                  for _ in range(4)], {"epsilon": 1e-3}),
    ("Pad", [X], {"pads": [0, 0, 1, 2, 0, 0, 2, 1]}),
    ("Pad", [X, C(np.asarray([0, 0, 1, 0, 0, 0, 0, 3], np.int64))],
     {"mode": "edge"}),
    ("PRelu", [X, C(R.rand(4, 1, 1).astype(np.float32))], {}),
    ("Identity", [X], {}), ("Unsqueeze", [X], {"axes": [0]}),
    ("Squeeze", [X[:1]], {"axes": [0]}),
    ("Cast", [X], {"to": 11}),
    ("Gather", [X, C(np.asarray([2, 0], np.int64))], {"axis": 1})])
def test_ops(op, inputs, attrs):
    run_both(op, inputs, attrs)


def test_split_and_shape_plumbing():
    run_both("Split", [X], {"axis": 1, "split": [1, 3]}, n_out=2)
    run_both("Split", [X, C(np.asarray([2, 2], np.int64))], {"axis": 1},
             n_out=2)
    run_both("Split", [X], {"axis": 3}, n_out=1)
    shape = run_both("Shape", [X])
    assert isinstance(shape, np.ndarray)          # stays numpy
    run_both("Gather", [C(shape), C(np.asarray([2, 3]))], {"axis": 0})
    run_both("Unsqueeze", [C(np.asarray([5, 6]))], {"axes": [1]})
    run_both("Cast", [C(shape)], {"to": 6})
    run_both("Constant", [], {"value": np.asarray([1.5, 2.5], np.float32)})
    run_both("Concat", [C(shape[:2]), C(np.asarray([-1], np.int64))],
             {"axis": 0})


# ---- the drivers' from_onnx, on blobs written here ---------------------------

def _head(x, pool, cout, name, rng, bias=0.0, act="Sigmoid"):
    """AveragePool(pool) -> 1x1 Conv to ``cout`` -> act: nodes, inits."""
    w = (rng.randn(cout, 3, 1, 1) * 0.02).astype(np.float32)
    b = (rng.randn(cout) * 0.1 + bias).astype(np.float32)
    nodes = [node("AveragePool", [x], [f"{name}_p"], kernel_shape=[pool, pool],
                  strides=[pool, pool]),
             node("Conv", [f"{name}_p", f"{name}_w", f"{name}_b"],
                  [f"{name}_c"])]
    if act:
        nodes.append(node(act, [f"{name}_c"], [name]))
    return nodes, {f"{name}_w": w, f"{name}_b": b}


def test_tracker_from_onnx_matches_jax(tmp_path):
    """``Tracker.from_onnx`` and ``JaxTracker.from_onnx`` on landmark,
    detection and (two-output) gaze blobs named as OpenSeeFace's."""
    from havatar_tpu.preprocess.tracker import JaxTracker
    from havatar_tpu_torch.preprocess.tracker import Tracker

    rng = np.random.RandomState(5)
    nodes, inits = _head("input", 8, 198, "lm", rng)
    write_model(tmp_path / "lm_model0_opt.onnx", nodes, inits,
                {"input": [1, 3, 224, 224]}, ["lm"])
    nodes, inits = _head("input", 4, 2, "maps", rng, bias=0.8)
    nodes.append(node("MaxPool", ["maps"], ["mp"], kernel_shape=[3, 3],
                      pads=[1, 1, 1, 1]))
    write_model(tmp_path / "mnv3_detection_opt.onnx", nodes, inits,
                {"input": [1, 3, 224, 224]}, ["maps", "mp"])
    nodes, inits = _head("input", 4, 3, "gaze", rng)
    nodes.append(node("Identity", ["gaze"], ["extra"]))
    write_model(tmp_path / "mnv3_gaze32_split_opt.onnx", nodes, inits,
                {"input": [2, 3, 32, 32]}, ["gaze", "extra"])
    kw = dict(extract_features=True, detection_threshold=0.5)
    ours = Tracker.from_onnx(160, 120, str(tmp_path), device="cpu", **kw)
    theirs = JaxTracker.from_onnx(160, 120, str(tmp_path), **kw)
    frames = np.random.RandomState(6).rand(3, 120, 160, 3) * 255
    n = 0
    for f in frames.astype(np.uint8):
        got, want = ours.predict(f), theirs.predict(f)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.conf == pytest.approx(b.conf, abs=1e-5)
            np.testing.assert_allclose(a.lms, b.lms, atol=1e-2)
            np.testing.assert_allclose(a.eye_state, b.eye_state, atol=1e-2)
        n += len(got)
    assert n == 3


def test_retinaface_from_onnx_matches_jax(tmp_path):
    """``RetinaFaceDetector.from_onnx`` and JAX's on a 640^2 blob whose
    three levels (pools of 8, 16 and 32) give loc, conf and landmarks in
    the prior-box order."""
    from havatar_tpu.preprocess.retinaface import JaxRetinaFaceDetector
    from havatar_tpu_torch.preprocess.retinaface import RetinaFaceDetector

    rng = np.random.RandomState(7)
    nodes, inits, locs, confs = [], {}, [], []
    for pool in (8, 16, 32):
        for kind, c in (("loc", 8), ("conf", 4)):
            name = f"{kind}{pool}"
            n, i = _head("input0", pool, c, name, rng, act=None)
            nodes += n + [
                node("Transpose", [f"{name}_c"], [f"{name}_t"],
                     perm=[0, 2, 3, 1]),
                node("Reshape", [f"{name}_t", f"shape{c // 2}"], [name])]
            inits.update(i)
            (locs if kind == "loc" else confs).append(name)
    inits["shape4"] = np.asarray([1, -1, 4], np.int64)
    inits["shape2"] = np.asarray([1, -1, 2], np.int64)
    nodes += [node("Concat", locs, ["loc"], axis=1),
              node("Concat", confs, ["conf_raw"], axis=1),
              node("Softmax", ["conf_raw"], ["conf"], axis=-1),
              node("Identity", ["loc"], ["landms"])]
    path = write_model(tmp_path / "retinaface_640x640_opt.onnx", nodes, inits,
                       {"input0": [1, 3, 640, 640]}, ["loc", "conf", "landms"])
    frame = (np.random.RandomState(8).rand(120, 160, 3) * 255).astype(np.uint8)
    kw = dict(min_conf=0.5, top_k=3)
    got = RetinaFaceDetector.from_onnx(path, device="cpu", **kw).detect(frame)
    want = JaxRetinaFaceDetector.from_onnx(path, **kw).detect(frame)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-2)
