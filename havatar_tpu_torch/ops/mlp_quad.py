"""The field's radiance from raw bilinear corner rows, as one fused op for
training: gather, corner reduction and dense chain forward, and their
backward.

Port of ``havatar_tpu/ops/pallas_mlp_quad.py:field_radiance_quad`` (forward
kernel ``_fwd_kernel``, backward kernel ``_bwd_kernel``, behind the
``jax.custom_vjp`` ``_frq_vjp`` / ``_frq_fwd`` / ``_frq_bwd``). For one
batch item, planes [H, W, C] (XY and ZY), box-warped points [N, 3] and
posenc [N, n_pe] float32, with cdt = the planes' dtype::

    quads = the 4 bilinear corner rows of each plane, [N, 8C] in cdt
    w8    = their corner weights, [N, 8] float32 (differentiable in warped)
    x     = cdt([xy | zy | posenc]),  xy = sum_k quads_xy[k] * w_k  (float32)
    out   = the dense chain of ops/mlp.py on x with layer0's input columns
            in that block order                       [N, 3 + cf + 1] f32

The backward recomputes everything from (planes, warped, posenc) and the
parameters: it gathers the corner rows again, runs the chain's backward with
dx kept in float32, and turns dx into d(quads) [N, 8C] float32 (dx_xy * w_k
for each XY corner k, dx_zy * w_k for the ZY corners) and d(aux) [N, n_pe+8]
= d(posenc) ++ dw8, dw8[k] = sum_c quads[k*C + c] * dplane[c]. The gather,
the splat of d(quads) into the plane gradients (``index_add_`` into the quad
table, then four shifted adds) and dw8's way back to the points (autograd
through the corner weights, the border clip included) stay in PyTorch, as
they stay in XLA in the JAX package.

* ``field_radiance_quad`` is the differentiable op (a
  ``torch.autograd.Function``; it cannot be differentiated twice).
  ``quad_forward`` and ``quad_backward`` are the kernel halves on the
  gathered rows: on CUDA tensors they launch ``mlp_quad_forward_f32`` /
  ``mlp_quad_forward_bf16`` / ``mlp_quad_backward`` of ``csrc/mlp.cu`` or
  raise; on CPU tensors they run the plain twins.
  ``quad_forward.launches``, ``quad_backward.launches`` count launches,
  ``field_radiance_quad.launches`` both.
* ``field_radiance_quad_plain`` and ``field_radiance_quad_bwd_plain`` are
  the plain PyTorch twins of the two kernels.

Weights are ``torch.nn.Linear`` tensors ([out, in]; w0's columns in the
reference's interleaved plane order 2c + p, then posenc).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from havatar_tpu_torch.ops import mlp as M
from havatar_tpu_torch.ops.grid_sample import _axis_weights, _unnormalize

# widths the CUDA kernels are built for: the production field
C_PLANE, N_PE = 64, M.FIN - 2 * 64

Params = Tuple[torch.Tensor, ...]


@functools.lru_cache(maxsize=None)
def _perm(C: int, n_pe: int) -> Tuple[List[int], List[int]]:
    """layer0's input columns: block order [xy (C), zy (C), posenc] from the
    reference's interleaved order (as ``_perm_list``), and its inverse."""
    perm = ([2 * c for c in range(C)] + [2 * c + 1 for c in range(C)]
            + list(range(2 * C, 2 * C + n_pe)))
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return perm, inv


def _widths(quads: torch.Tensor, aux: torch.Tensor) -> Tuple[int, int]:
    if quads.dim() != 2 or quads.shape[1] % 8 or aux.dim() != 2 \
            or aux.shape[0] != quads.shape[0] or aux.shape[1] < 8:
        raise ValueError(f"expected quads [N, 8C] and aux [N, n_pe + 8], got "
                         f"{tuple(quads.shape)} and {tuple(aux.shape)}")
    return quads.shape[1] // 8, aux.shape[1] - 8


def _block_order(params: Sequence[torch.Tensor], C: int, n_pe: int) -> Params:
    perm, _ = _perm(C, n_pe)
    return (params[0][:, perm], *params[1:])


def _reduce(quads: torch.Tensor, aux: torch.Tensor, C: int,
            n_pe: int) -> torch.Tensor:
    """The MLP input [N, 2C + n_pe] in block order, in quads' dtype: each
    plane's four corner rows summed in float32 against their weights."""
    q, w = quads.float(), aux[:, n_pe:]
    xy = q[:, :C] * w[:, 0:1]
    zy = q[:, 4 * C:5 * C] * w[:, 4:5]
    for k in range(1, 4):
        xy = xy + q[:, k * C:(k + 1) * C] * w[:, k:k + 1]
        zy = zy + q[:, (4 + k) * C:(5 + k) * C] * w[:, 4 + k:5 + k]
    return torch.cat([xy, zy, aux[:, :n_pe]], 1).to(quads.dtype)


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def field_radiance_quad_plain(quads: torch.Tensor, aux: torch.Tensor,
                              *params: torch.Tensor) -> torch.Tensor:
    """Plain twin of the forward kernel: quads [N, 8C] (float32 or bf16),
    aux [N, n_pe + 8] float32 -> [N, 3 + cf + 1] float32, differentiable by
    autograd."""
    C, n_pe = _widths(quads, aux)
    return M.fused_mlp_chain_plain(_reduce(quads, aux, C, n_pe),
                                   *_block_order(params, C, n_pe))


def field_radiance_quad_bwd_plain(quads: torch.Tensor, aux: torch.Tensor,
                                  g: torch.Tensor, *params: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             Params]:
    """Plain twin of the backward kernel, its arithmetic written out: (dq
    [N, 8C] float32, daux [N, n_pe + 8] float32, the ten parameter
    gradients in each parameter's dtype and layout)."""
    C, n_pe = _widths(quads, aux)
    x = _reduce(quads, aux, C, n_pe)
    dx, grads = M.fused_mlp_chain_bwd_plain(
        x, g, *_block_order(params, C, n_pe), dx_dtype=torch.float32)
    N, w = quads.shape[0], aux[:, n_pe:]
    dxy, dzy = dx[:, :C], dx[:, C:2 * C]
    dq = torch.cat([dxy * w[:, k:k + 1] for k in range(4)]
                   + [dzy * w[:, 4 + k:5 + k] for k in range(4)], 1)
    dplane = torch.cat([dxy[:, None].expand(N, 4, C),
                        dzy[:, None].expand(N, 4, C)], 1)
    dw8 = (quads.float().view(N, 8, C) * dplane).sum(-1)
    _, inv = _perm(C, n_pe)
    return (dq, torch.cat([dx[:, 2 * C:], dw8], 1),
            (grads[0][:, inv], *grads[1:]))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/mlp.cu (which also holds the quad entry points), its quad C
    signatures declared."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = M._lib()
    lib.mlp_quad_forward_f32.argtypes = [P] * 13 + [L] + [I] * 4 + [P]
    lib.mlp_quad_forward_f32.restype = I
    lib.mlp_quad_forward_bf16.argtypes = [P] * 11 + [L] + [I] * 4 + [P]
    lib.mlp_quad_forward_bf16.restype = I
    lib.mlp_quad_backward.argtypes = [P] * 26 + [L] + [I] * 5 + [P]
    lib.mlp_quad_backward.restype = I
    return lib


def _check_cuda(quads: torch.Tensor, aux: torch.Tensor,
                params: Sequence[torch.Tensor]) -> None:
    """What the CUDA kernels take; anything else raises, nothing falls
    back."""
    C, n_pe = _widths(quads, aux)
    if (C, n_pe) != (C_PLANE, N_PE):
        raise ValueError(f"the CUDA quad kernels are built for {C_PLANE} "
                         f"plane channels and posenc {N_PE}; got {C}, {n_pe}")
    if quads.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quads are {quads.dtype}; the kernels take float32 "
                        f"or bfloat16")
    if aux.dtype != torch.float32:
        raise TypeError(f"aux is {aux.dtype}; the kernels take float32")
    for name, t in (("quads", quads), ("aux", aux)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.device != quads.device:
            raise ValueError(f"{name} is on {t.device}, quads on "
                             f"{quads.device}")
    x = quads.new_empty(0, 2 * C + n_pe)    # the chain's input, as a shape
    M._check_shapes(x, params)
    M._check_cuda_widths(x, params)


def quad_forward(quads: torch.Tensor, aux: torch.Tensor,
                 *params: torch.Tensor) -> torch.Tensor:
    """The op's forward on gathered rows, [N, 8C] x [N, n_pe + 8] ->
    [N, 3 + cf + 1] f32, with no graph: the forward kernel for CUDA
    tensors, its plain twin for CPU ones."""
    if not quads.is_cuda:
        with torch.no_grad():
            return field_radiance_quad_plain(quads, aux, *params)
    _check_cuda(quads, aux, params)
    block = _block_order(params, C_PLANE, N_PE)
    N = quads.shape[0]
    out = torch.empty(N, 3 + M.CF + 1, dtype=torch.float32,
                      device=quads.device)
    lib = _lib()
    with torch.cuda.device(quads.device):
        stream = torch.cuda.current_stream(quads.device).cuda_stream
        if quads.dtype == torch.float32:
            args = M._fwd_args_f32(block)
            err = lib.mlp_quad_forward_f32(
                *M._ptrs(quads, aux, *args, out), N, C_PLANE, N_PE, M.HID,
                M.CF, stream)
        else:
            args = M._fwd_args_bf16(block)
            err = lib.mlp_quad_forward_bf16(
                *M._ptrs(quads, aux, *args, out), N, C_PLANE, N_PE, M.HID,
                M.CF, stream)
    M._raise_on(lib, err, "mlp_quad_forward")
    quad_forward.launches += 1
    field_radiance_quad.launches += 1
    return out


quad_forward.launches = 0


def quad_backward(quads: torch.Tensor, aux: torch.Tensor, g: torch.Tensor,
                  *params: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """The op's backward on gathered rows: cotangent g [N, 3 + cf + 1] ->
    (dq [N, 8C] f32, daux [N, n_pe + 8] f32, the ten parameter gradients in
    each parameter's dtype and layout). One launch of the backward kernel
    for CUDA tensors (weight gradients summed over blocks with float32
    atomics); the plain twin for CPU ones."""
    if not quads.is_cuda:
        with torch.no_grad():
            return field_radiance_quad_bwd_plain(quads, aux, g, *params)
    _check_cuda(quads, aux, params)
    N = quads.shape[0]
    if tuple(g.shape) != (N, 3 + M.CF + 1) or g.device != quads.device:
        raise ValueError(f"g has shape {tuple(g.shape)} on {g.device}, "
                         f"expected {(N, 3 + M.CF + 1)} on {quads.device}")
    w0, b0, w1, b1, wf, bf, wa, ba, wr, br = _block_order(params, C_PLANE,
                                                          N_PE)
    g = M._f32(g)
    dq = torch.empty(N, 8 * C_PLANE, dtype=torch.float32, device=quads.device)
    daux = torch.empty(N, N_PE + 8, dtype=torch.float32, device=quads.device)
    flat = torch.zeros(sum(M._GRAD_SIZES), dtype=torch.float32,
                       device=quads.device)
    dw0, dw1, dwf, dwa, dwr, db0, db1, dbf, dba, dbr = flat.split(
        M._GRAD_SIZES)
    lib = _lib()
    with torch.cuda.device(quads.device):
        stream = torch.cuda.current_stream(quads.device).cuda_stream
        args = (M._kn(w0), M._kn(w1), M._kn(wf), M._f32(w0), M._f32(w1),
                M._f32(wf), M._f32(wa), M._f32(wr), M._f32(b0), M._f32(b1),
                M._f32(bf))
        err = lib.mlp_quad_backward(
            *M._ptrs(quads, aux, g, *args, dq, daux, dw0, dw1, dwf, dwa, dwr,
                     db0, db1, dbf, dba, dbr), N, C_PLANE, N_PE, M.HID, M.CF,
            int(quads.dtype == torch.bfloat16), stream)
    M._raise_on(lib, err, "mlp_quad_backward")
    quad_backward.launches += 1
    field_radiance_quad.launches += 1
    _, inv = _perm(C_PLANE, N_PE)
    # the kernel holds weight gradients as [in, out], dw0's rows in block
    # order
    grads = (dw0.view(M.FIN, M.HID).t()[:, inv], db0,
             dw1.view(M.HID, M.HID).t(), db1, dwf.view(M.HID, M.CF).t(), dbf,
             dwa.view(1, M.HID), dba, dwr.view(M.CF, 3).t(), dbr)
    return dq, daux, tuple(d.to(p.dtype) for d, p in zip(grads, params))


quad_backward.launches = 0


# ---------------------------------------------------------------------------
# gather and splat, and the differentiable op
# ---------------------------------------------------------------------------

def _corners(coords: torch.Tensor, H: int, W: int, padding_mode: str):
    """coords [N, 2] (x, y) -> (quad-table row [N] int64, corner weights
    [N, 4]: y0x0, y0x1, y1x0, y1x1)."""
    x = _unnormalize(coords[:, 0], W)
    y = _unnormalize(coords[:, 1], H)
    if padding_mode == "border":
        x, y = x.clamp(0.0, W - 1), y.clamp(0.0, H - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"padding_mode {padding_mode!r}: zeros or border")
    x0, wx0, wx1 = _axis_weights(x, W)
    y0, wy0, wy1 = _axis_weights(y, H)
    return y0 * (W - 1) + x0, torch.stack(
        [wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], -1)


def _quad_pack(p: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> [(H-1)(W-1), 4C]: row (y0, x0) holds the four corner
    texels (y0|y0+1) x (x0|x0+1)."""
    H, W, C = p.shape
    return torch.stack([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]],
                       2).reshape((H - 1) * (W - 1), 4 * C)


def gather_quads(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                 warped: torch.Tensor, padding_mode: str = "zeros"):
    """-> (quads [N, 8C] in the planes' dtype: the XY plane's corner row at
    (x, y) ++ the ZY plane's at (z, y); rows [N, 2] int64, their rows in the
    stacked quad table of both planes; w8 [N, 8] float32)."""
    H, W, _ = plane_xy.shape
    i_xy, w_xy = _corners(warped[:, [0, 1]], H, W, padding_mode)
    i_zy, w_zy = _corners(warped[:, [2, 1]], H, W, padding_mode)
    rows = torch.stack([i_xy, i_zy + (H - 1) * (W - 1)], 1)
    table = torch.cat([_quad_pack(plane_xy), _quad_pack(plane_zy)], 0)
    quads = table.index_select(0, rows.reshape(-1))
    return (quads.reshape(warped.shape[0], -1), rows,
            torch.cat([w_xy, w_zy], -1).float())


def splat_quads(dq: torch.Tensor, rows: torch.Tensor, H: int, W: int,
                sorted_scatter: bool = False):
    """The adjoint of ``gather_quads``'s rows: dq [N, 8C] f32 -> (dplane_xy,
    dplane_zy) [H, W, C] f32. The [N, 2] corner-row updates are added into
    the quad table with ``index_add_`` (sorted by destination first with
    ``sorted_scatter``), which four shifted adds unpack into each plane."""
    C = dq.shape[1] // 8
    M_ = (H - 1) * (W - 1)
    idx, upd = rows.reshape(-1), dq.view(-1, 4 * C)
    if sorted_scatter:
        order = torch.argsort(idx)
        idx, upd = idx[order], upd[order]
    table = torch.zeros(2 * M_, 4 * C, dtype=torch.float32, device=dq.device)
    table.index_add_(0, idx, upd)

    def unpack(t):
        q = t.view(H - 1, W - 1, 4, C)
        d = torch.zeros(H, W, C, dtype=torch.float32, device=dq.device)
        d[:-1, :-1] += q[:, :, 0]
        d[:-1, 1:] += q[:, :, 1]
        d[1:, :-1] += q[:, :, 2]
        d[1:, 1:] += q[:, :, 3]
        return d

    return unpack(table[:M_]), unpack(table[M_:])


class _FieldRadianceQuad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, padding_mode, sorted_scatter, plane_xy, plane_zy, warped,
                pe, *params):
        quads, _, w8 = gather_quads(plane_xy, plane_zy, warped, padding_mode)
        out = quad_forward(quads, torch.cat([pe.float(), w8], -1), *params)
        ctx.padding_mode, ctx.sorted_scatter = padding_mode, sorted_scatter
        # inputs only: the corner rows are gathered again in the backward
        ctx.save_for_backward(plane_xy, plane_zy, warped, pe, *params)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        plane_xy, plane_zy, warped, pe, *params = ctx.saved_tensors
        H, W, _ = plane_xy.shape
        n_pe = pe.shape[1]
        with torch.enable_grad():
            w_in = warped.detach().requires_grad_()
            quads, rows, w8 = gather_quads(plane_xy.detach(),
                                           plane_zy.detach(), w_in,
                                           ctx.padding_mode)
        aux = torch.cat([pe.detach().float(), w8.detach()], -1)
        dq, daux, dparams = quad_backward(quads, aux, g.contiguous(), *params)
        del quads
        dwarped, = torch.autograd.grad(w8, w_in, daux[:, n_pe:])
        d_xy, d_zy = splat_quads(dq, rows, H, W, ctx.sorted_scatter)
        return (None, None, d_xy.to(plane_xy.dtype), d_zy.to(plane_zy.dtype),
                dwarped.to(warped.dtype), daux[:, :n_pe].to(pe.dtype),
                *dparams)


def field_radiance_quad(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                        warped: torch.Tensor, pe: torch.Tensor,
                        *params: torch.Tensor, padding_mode: str = "zeros",
                        sorted_scatter: bool = False) -> torch.Tensor:
    """One batch item: planes [H, W, C] (float32 or bfloat16), box-warped
    points [N, 3], posenc [N, n_pe] float32 and the five Linear layers'
    tensors (w0, b0, w1, b1, w_feat, b_feat, w_alpha, b_alpha, w_rgb,
    b_rgb) -> radiance [N, 3 + cf + 1] float32 ([rgb | feat | sigma]).
    Gradients reach both planes, the points, the posenc and every
    parameter; differentiating the backward raises."""
    return _FieldRadianceQuad.apply(padding_mode, bool(sorted_scatter),
                                    plane_xy, plane_zy, warped, pe, *params)


field_radiance_quad.launches = 0
