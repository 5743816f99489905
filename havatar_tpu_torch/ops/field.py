"""The field's tail as one fused op for inference: positional encoding of
the points, its concatenation with their plane features, and the dense
chain.

Port of ``havatar_tpu/ops/pallas_field.py:fused_field_eval`` (Pallas kernel
``_field_kernel``). With cdt = ``pts_feat.dtype`` (float32 or bfloat16)::

    enc = posenc(pts, num_freqs)  [N, 6F] float32, [F, (sin, sin+pi/2), C]
    x   = [pts_feat | cdt(enc)]   plane channels as sample_plane_features
                                  gives them (interleaved c*P + p)
    out = the dense chain of ops/mlp.py on x     [N, 3 + cf + 1] float32

Weights are ``torch.nn.Linear`` tensors in ``DoublePlaneNeRFField.
dense_params()`` order; layer0's columns are not permuted. Inference only,
as in the JAX package: there is no backward and no autograd Function. No
serving or training path runs the op, in either package;
``havatar_tpu_torch/scripts/micro_field.py`` does.

* ``fused_field_eval``: on CUDA tensors it launches ``field_eval_f32`` or
  ``field_eval_bf16`` of ``csrc/mlp.cu`` (by the features' dtype) or raises;
  on CPU tensors it runs the plain twin. ``fused_field_eval.launches``
  counts launches.
* ``fused_field_eval_plain``: the plain PyTorch twin, at any width.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from havatar_tpu_torch.ops import mlp as M
from havatar_tpu_torch.ops.embedding import positional_encoding, posenc_dim

# widths the CUDA kernels are built for: the production field
NUM_FREQS = 8
FEAT_IN = M.FIN - posenc_dim(NUM_FREQS)


def _check_rows(pts: torch.Tensor, pts_feat: torch.Tensor) -> None:
    if pts.dim() != 2 or pts.shape[1] != 3 or pts_feat.dim() != 2 \
            or pts_feat.shape[0] != pts.shape[0]:
        raise ValueError(f"expected pts [N, 3] and pts_feat [N, F_in], got "
                         f"{tuple(pts.shape)} and {tuple(pts_feat.shape)}")


def fused_field_eval_plain(pts: torch.Tensor, pts_feat: torch.Tensor,
                           *params: torch.Tensor,
                           num_freqs: int = NUM_FREQS) -> torch.Tensor:
    """Plain twin of the kernel: pts [N, 3] float32, pts_feat [N, F_in]
    (float32 or bf16) -> [N, 3 + cf + 1] float32, same rounding points."""
    _check_rows(pts, pts_feat)
    enc = positional_encoding(pts.float(), num_freqs)
    return M.fused_mlp_chain_plain(
        torch.cat([pts_feat, enc.to(pts_feat.dtype)], -1), *params)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/mlp.cu (which also holds the field_eval entry points), their C
    signatures declared."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = M._lib()
    lib.field_eval_f32.argtypes = [P] * 13 + [L] + [I] * 4 + [P]
    lib.field_eval_f32.restype = I
    lib.field_eval_bf16.argtypes = [P] * 11 + [L] + [I] * 4 + [P]
    lib.field_eval_bf16.restype = I
    return lib


def _check_cuda(pts: torch.Tensor, pts_feat: torch.Tensor,
                params: Sequence[torch.Tensor], num_freqs: int) -> None:
    """What the CUDA kernels take; anything else raises, nothing falls
    back."""
    _check_rows(pts, pts_feat)
    if pts.dtype != torch.float32:
        raise TypeError(f"pts are {pts.dtype}; the kernels take float32")
    if pts_feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pts_feat is {pts_feat.dtype}; the kernels take "
                        f"float32 or bfloat16")
    if (pts_feat.shape[1], num_freqs) != (FEAT_IN, NUM_FREQS):
        raise ValueError(f"the CUDA field kernels are built for {FEAT_IN} "
                         f"plane features and {NUM_FREQS} frequencies; got "
                         f"{pts_feat.shape[1]}, {num_freqs}")
    if not pts.is_contiguous():
        raise ValueError("pts must be contiguous")
    if not pts_feat.is_contiguous() or pts_feat.data_ptr() % 16:
        raise ValueError("pts_feat must be contiguous and 16-byte aligned")
    if pts_feat.device != pts.device:
        raise ValueError(f"pts_feat is on {pts_feat.device}, pts on "
                         f"{pts.device}")
    x = pts_feat.new_empty(0, M.FIN)     # the chain's input, as a shape
    M._check_shapes(x, params)
    M._check_cuda_widths(x, params)


def fused_field_eval(pts: torch.Tensor, pts_feat: torch.Tensor,
                     w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w_feat: torch.Tensor,
                     b_feat: torch.Tensor, w_alpha: torch.Tensor,
                     b_alpha: torch.Tensor, w_rgb: torch.Tensor,
                     b_rgb: torch.Tensor,
                     num_freqs: int = NUM_FREQS) -> torch.Tensor:
    """pts [N, 3] float32 canonical points, pts_feat [N, F_in] their plane
    features (float32 or bfloat16) and the five Linear layers' tensors ->
    [N, 3 + cf + 1] float32 ([rgb | feat | sigma]), with no graph: one
    launch of the field kernel for CUDA tensors, the plain twin for CPU
    ones."""
    params = (w0, b0, w1, b1, w_feat, b_feat, w_alpha, b_alpha, w_rgb, b_rgb)
    if not pts.is_cuda:
        with torch.no_grad():
            return fused_field_eval_plain(pts, pts_feat, *params,
                                          num_freqs=num_freqs)
    _check_cuda(pts, pts_feat, params, num_freqs)
    N = pts.shape[0]
    out = torch.empty(N, 3 + M.CF + 1, dtype=torch.float32,
                      device=pts.device)
    lib = _lib()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        if pts_feat.dtype == torch.float32:
            args = M._fwd_args_f32(params)
            err = lib.field_eval_f32(*M._ptrs(pts, pts_feat, *args, out), N,
                                     FEAT_IN, num_freqs, M.HID, M.CF, stream)
        else:
            args = M._fwd_args_bf16(params)
            err = lib.field_eval_bf16(*M._ptrs(pts, pts_feat, *args, out), N,
                                      FEAT_IN, num_freqs, M.HID, M.CF, stream)
    M._raise_on(lib, err, "field_eval")
    fused_field_eval.launches += 1
    return out


fused_field_eval.launches = 0
