"""The field's dense chain as one fused op, forward and backward.

Port of ``havatar_tpu/ops/pallas_mlp.py:fused_mlp_chain`` (forward kernel
``_mlp_kernel``, backward kernel ``_mlp_bwd_kernel`` behind a
``jax.custom_vjp``). The function, with cdt = ``x.dtype`` (float32 or
bfloat16)::

    h0   = cdt(relu(x  @ cdt(w0).T + b0))
    h1   = cdt(relu(h0 @ cdt(w1).T + b1))
    feat = h1 @ cdt(w_feat).T + b_feat ; sigma = h1 @ cdt(w_alpha).T + b_alpha
    rgb  = cdt(feat) @ cdt(w_rgb).T + b_rgb
    out  = [rgb (3) | feat (cf) | sigma (1)]   float32

every product accumulated in float32, biases float32. The backward
recomputes the activations from x (nothing but x and the parameters is
saved), rounds each cotangent to cdt before its product, contracts the
cdt-rounded operands for the weight gradients and sums the cotangents before
rounding for the bias gradients.

Weights are ``torch.nn.Linear`` tensors, ``[out, in]``; the JAX kernels hold
``[in, out]``, and the one transpose is made here, at the boundary.

* ``fused_mlp_chain`` is the differentiable op (a ``torch.autograd.Function``
  whose backward is the backward kernel; it cannot be differentiated twice).
  ``mlp_forward`` and ``mlp_backward`` are its two halves. On CUDA tensors
  they launch the kernels of ``csrc/mlp.cu`` or raise; they run the plain
  twins only on CPU tensors. ``mlp_forward.launches`` and
  ``mlp_backward.launches`` count launches, ``fused_mlp_chain.launches``
  both.
* ``fused_mlp_chain_plain`` (differentiable by autograd) and
  ``fused_mlp_chain_bwd_plain`` (the backward kernel's arithmetic written
  out) are the plain PyTorch twins.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from havatar_tpu_torch.ops import cuda_build

# widths the CUDA kernels are built for: the production field
FIN, HID, CF = 176, 128, 64
_GRAD_SIZES = (FIN * HID, HID * HID, HID * CF, HID, CF * 3, HID, HID, CF, 1, 3)

Params = Tuple[torch.Tensor, ...]   # w0 b0 w1 b1 w_feat b_feat w_alpha b_alpha w_rgb b_rgb


def _check_shapes(x: torch.Tensor, params: Sequence[torch.Tensor]) -> None:
    """The ten parameters fit each other and x, on any device."""
    if len(params) != 10:
        raise ValueError(f"expected 10 parameter tensors, got {len(params)}")
    w0, b0, w1, b1, wf, bf, wa, ba, wr, br = params
    if x.dim() != 2:
        raise ValueError(f"x must be [N, Fin], got {tuple(x.shape)}")
    hid, cf = w0.shape[0], wf.shape[0]
    want = ((w0, (hid, x.shape[1])), (b0, (hid,)), (w1, (hid, hid)),
            (b1, (hid,)), (wf, (cf, hid)), (bf, (cf,)), (wa, (1, hid)),
            (ba, (1,)), (wr, (wr.shape[0], cf)), (br, (wr.shape[0],)))
    for i, (t, shape) in enumerate(want):
        if tuple(t.shape) != shape:
            raise ValueError(f"parameter {i} has shape {tuple(t.shape)}, "
                             f"expected {shape} for x {tuple(x.shape)}")


def _check_cuda_widths(x: torch.Tensor, params: Sequence[torch.Tensor]) -> None:
    """What the CUDA kernels take; anything else raises, nothing falls back."""
    w0, wf, wr = params[0], params[4], params[8]
    if (x.shape[1], w0.shape[0], wf.shape[0], wr.shape[0]) != (FIN, HID, CF, 3):
        raise ValueError(
            f"the CUDA dense-chain kernels are built for input {FIN}, hidden "
            f"{HID}, feat {CF}, rgb 3; got input {x.shape[1]}, hidden "
            f"{w0.shape[0]}, feat {wf.shape[0]}, rgb {wr.shape[0]}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x is {x.dtype}; the kernels take float32 or "
                        f"bfloat16")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    for i, t in enumerate(params):
        if t.device != x.device:
            raise ValueError(f"parameter {i} is on {t.device}, x on "
                             f"{x.device}")


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def fused_mlp_chain_plain(x: torch.Tensor, *params: torch.Tensor
                          ) -> torch.Tensor:
    """Plain twin of the forward kernel: [N, Fin] -> [N, 3 + cf + 1] f32,
    same rounding points, differentiable by autograd."""
    _check_shapes(x, params)
    w0, b0, w1, b1, wf, bf, wa, ba, wr, br = params
    f, cdt = torch.float32, x.dtype

    def w(t):
        return t.to(cdt).to(f)

    h = torch.relu(x.to(f) @ w(w0).T + b0.to(f)).to(cdt)
    h = torch.relu(h.to(f) @ w(w1).T + b1.to(f)).to(cdt)
    fa = (h.to(f) @ w(torch.cat([wf, wa], 0)).T
          + torch.cat([bf, ba], 0).to(f))
    feat, sigma = fa[:, :-1], fa[:, -1:]
    rgb = feat.to(cdt).to(f) @ w(wr).T + br.to(f)
    return torch.cat([rgb, feat, sigma], -1)


def fused_mlp_chain_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                              *params: torch.Tensor,
                              dx_dtype: Optional[torch.dtype] = None
                              ) -> Tuple[torch.Tensor, Params]:
    """Plain twin of the backward kernel, its arithmetic written out (no
    autograd): x [N, Fin], output cotangent g [N, 3 + cf + 1] -> (dx in
    ``dx_dtype``, x's dtype by default, the ten parameter gradients in each
    parameter's dtype and layout)."""
    _check_shapes(x, params)
    w0, b0, w1, b1, wf, bf, wa, ba, wr, br = params
    f, cdt = torch.float32, x.dtype
    cf = wf.shape[0]

    def r(t):                       # round to cdt, compute in f32
        return t.to(cdt).to(f)

    W0, W1, Wr = r(w0), r(w1), r(wr)
    Wh = r(torch.cat([wf, wa], 0))
    xf = x.to(f)
    a0 = xf @ W0.T + b0.to(f)
    h0 = r(torch.relu(a0))
    a1 = h0 @ W1.T + b1.to(f)
    h1 = r(torch.relu(a1))
    feat = r(h1 @ Wh[:cf].T + bf.to(f))

    g = g.to(f)
    g_rgb, g_feat, g_sig = g[:, :3], g[:, 3:3 + cf], g[:, 3 + cf:]
    dfa = torch.cat([g_feat + g_rgb @ Wr, g_sig], 1)
    dfac = r(dfa)
    da1 = torch.where(a1 > 0, dfac @ Wh, torch.zeros_like(a1))
    da1c = r(da1)
    da0 = torch.where(a0 > 0, da1c @ W1, torch.zeros_like(a0))
    da0c = r(da0)
    dx = (da0c @ W0).to(dx_dtype or x.dtype)
    dwh, dbh = dfac.T @ h1, dfa.sum(0)
    grads = (da0c.T @ xf, da0.sum(0), da1c.T @ h0, da1.sum(0),
             dwh[:cf], dbh[:cf], dwh[cf:], dbh[cf:],
             r(g_rgb).T @ feat, g_rgb.sum(0))
    return dx, tuple(d.to(p.dtype) for d, p in zip(grads, params))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/mlp.cu, built on first use, with its C signatures declared."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = cuda_build.load("mlp")
    lib.mlp_forward_f32.argtypes = [P] * 12 + [L] + [I] * 3 + [P]
    lib.mlp_forward_f32.restype = I
    lib.mlp_forward_bf16.argtypes = [P] * 10 + [L] + [I] * 3 + [P]
    lib.mlp_forward_bf16.restype = I
    lib.mlp_backward.argtypes = [P] * 24 + [L] + [I] * 4 + [P]
    lib.mlp_backward.restype = I
    lib.mlp_error_string.argtypes = [I]
    lib.mlp_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        msg = lib.mlp_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def _kn(t: torch.Tensor) -> torch.Tensor:
    """A Linear weight [out, in] as a float32 [in, out] copy."""
    return t.detach().float().t().contiguous()


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _fwd_args_f32(params: Sequence[torch.Tensor]) -> Params:
    """The float32 forward engine's weights: w0, w1, w_feat as [in, out]
    copies, then w_alpha, w_rgb and the five biases."""
    w0, b0, w1, b1, wf, bf, wa, ba, wr, br = params
    return (_kn(w0), _kn(w1), _kn(wf), _f32(wa), _f32(wr), _f32(b0),
            _f32(b1), _f32(bf), _f32(ba), _f32(br))


def _fwd_args_bf16(params: Sequence[torch.Tensor]) -> Params:
    """The tensor-core forward's weights: bf16 as [out, in] (fc_rgbFeat's
    rows stacked over fc_alpha's), float32 biases."""
    w0, b0, w1, b1, wf, bf, wa, ba, wr, br = params

    def bf16(t):
        return t.detach().to(torch.bfloat16).contiguous()

    return (bf16(w0), _f32(b0), bf16(w1), _f32(b1),
            bf16(torch.cat([wf, wa], 0)), _f32(torch.cat([bf, ba], 0)),
            bf16(wr), _f32(br))


def mlp_forward(x: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
    """The chain's forward, [N, Fin] -> [N, 3 + cf + 1] f32, with no graph:
    the forward kernel for a CUDA x, its plain twin for a CPU x."""
    if not x.is_cuda:
        with torch.no_grad():
            return fused_mlp_chain_plain(x, *params)
    _check_shapes(x, params)
    _check_cuda_widths(x, params)
    N = x.shape[0]
    out = torch.empty(N, 3 + CF + 1, dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.float32:
            args = _fwd_args_f32(params)
            err = lib.mlp_forward_f32(*_ptrs(x.detach(), *args, out), N, FIN,
                                      HID, CF, stream)
        else:
            args = _fwd_args_bf16(params)
            err = lib.mlp_forward_bf16(*_ptrs(x.detach(), *args, out), N,
                                       FIN, HID, CF, stream)
    _raise_on(lib, err, "mlp_forward")
    mlp_forward.launches += 1
    fused_mlp_chain.launches += 1
    return out


mlp_forward.launches = 0


def mlp_backward(x: torch.Tensor, g: torch.Tensor, *params: torch.Tensor
                 ) -> Tuple[torch.Tensor, Params]:
    """The chain's backward: x [N, Fin], cotangent g [N, 3 + cf + 1] -> (dx
    in x's dtype, the ten parameter gradients in each parameter's dtype and
    layout). One launch of the backward kernel for a CUDA x (weight
    gradients are summed over blocks with float32 atomics, so their last
    bits differ from run to run); the plain twin for a CPU x."""
    if not x.is_cuda:
        with torch.no_grad():
            return fused_mlp_chain_bwd_plain(x, g, *params)
    _check_shapes(x, params)
    _check_cuda_widths(x, params)
    w0, b0, w1, b1, wf, bf, wa, ba, wr, br = params
    N = x.shape[0]
    if tuple(g.shape) != (N, 3 + CF + 1) or g.device != x.device:
        raise ValueError(f"g has shape {tuple(g.shape)} on {g.device}, "
                         f"expected {(N, 3 + CF + 1)} on {x.device}")
    g = _f32(g)
    dx = torch.empty_like(x)
    flat = torch.zeros(sum(_GRAD_SIZES), dtype=torch.float32, device=x.device)
    dw0, dw1, dwf, dwa, dwr, db0, db1, dbf, dba, dbr = flat.split(_GRAD_SIZES)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (_kn(w0), _kn(w1), _kn(wf), _f32(w0), _f32(w1), _f32(wf),
                _f32(wa), _f32(wr), _f32(b0), _f32(b1), _f32(bf))
        err = lib.mlp_backward(
            *_ptrs(x.detach(), g, *args, dx, dw0, dw1, dwf, dwa, dwr, db0,
                   db1, dbf, dba, dbr), N, FIN, HID, CF,
            int(x.dtype == torch.bfloat16), stream)
    _raise_on(lib, err, "mlp_backward")
    mlp_backward.launches += 1
    fused_mlp_chain.launches += 1
    # the kernel holds weight gradients as [in, out]
    grads = (dw0.view(FIN, HID).t(), db0, dw1.view(HID, HID).t(), db1,
             dwf.view(HID, CF).t(), dbf, dwa.view(1, HID), dba,
             dwr.view(CF, 3).t(), dbr)
    return dx, tuple(d.to(p.dtype) for d, p in zip(grads, params))


mlp_backward.launches = 0


class _FusedMLPChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *params):
        ctx.save_for_backward(x, *params)
        return mlp_forward(x, *params)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        dx, dparams = mlp_backward(x, g, *params)
        return (dx, *dparams)


def fused_mlp_chain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w_feat: torch.Tensor,
                    b_feat: torch.Tensor, w_alpha: torch.Tensor,
                    b_alpha: torch.Tensor, w_rgb: torch.Tensor,
                    b_rgb: torch.Tensor) -> torch.Tensor:
    """Differentiable fused dense chain: x [N, Fin] (float32 or bfloat16)
    and the five Linear layers' tensors -> [N, 3 + cf + 1] float32
    ([rgb | feat | sigma]). Gradients reach x and every parameter through
    one backward kernel; differentiating the backward raises."""
    return _FusedMLPChain.apply(x, w0, b0, w1, b1, w_feat, b_feat, w_alpha,
                                b_alpha, w_rgb, b_rgb)


fused_mlp_chain.launches = 0
