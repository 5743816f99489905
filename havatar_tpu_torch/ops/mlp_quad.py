"""The field's radiance from the two feature planes, as one fused op for
training: gather, corner reduction and dense chain forward, and their
backward with the splat into the plane gradients.

Port of ``havatar_tpu/ops/pallas_mlp_quad.py:field_radiance_quad`` (forward
kernel ``_fwd_kernel``, backward kernel ``_bwd_kernel``, behind the
``jax.custom_vjp`` ``_frq_vjp`` / ``_frq_fwd`` / ``_frq_bwd``). For one
batch item, planes [H, W, C] (XY and ZY), box-warped points [N, 3] and
posenc [N, n_pe] float32, with cdt = the planes' dtype::

    rows  = each plane's bilinear cell y0 * (W - 1) + x0, [N, 2] int32
    w8    = the cells' corner weights, [N, 8] float32 (differentiable in
            warped; y0x0, y0x1, y1x0, y1x1 of XY, then of ZY)
    quads = the 4 corner texels of each cell, [N, 8C] in cdt
    x     = cdt([xy | zy | posenc]),  xy = sum_k quads_xy[k] * w_k  (float32)
    out   = the dense chain of ops/mlp.py on x with layer0's input columns
            in that block order                       [N, 3 + cf + 1] f32

The backward recomputes everything from (planes, rows, aux = posenc ++ w8)
and the parameters, runs the chain's backward with dx kept in float32 and
turns dx into the plane gradients (dx_xy * w_k added into each XY corner
texel k, dx_zy * w_k into the ZY ones) and d(aux) [N, n_pe + 8] = d(posenc)
++ dw8, dw8[k] = sum_c quads[k*C + c] * dplane[c]. The corner weights and
dw8's way back to the points (autograd through the corner weights, the
border clip included) stay in PyTorch: N x 8 floats.

* ``field_radiance_quad`` is the differentiable op (a
  ``torch.autograd.Function``; it cannot be differentiated twice).
  ``quad_forward`` and ``quad_backward`` are its kernel halves: on CUDA
  tensors they launch ``quad_forward_f32`` / ``quad_forward_bf16`` /
  ``quad_backward`` of ``csrc/quad.cu``, which gather the corner texels
  from the planes and splat the plane gradients themselves (no [N, 8C]
  tensor is made), or raise; on CPU tensors they run the plain twins.
  ``quad_forward.launches``, ``quad_backward.launches`` count launches,
  ``field_radiance_quad.launches`` both.
* ``field_radiance_quad_plain`` and ``field_radiance_quad_bwd_plain`` are
  the plain PyTorch twins of the two kernels, at the same contract: the
  gather of the corner rows (``gather_rows``), the chain on them
  (``quad_chain_plain`` / ``quad_chain_bwd_plain``) and, in the backward,
  the splat (``splat_quads``: ``index_add_`` into the quad table, sorted by
  destination first with ``sorted_scatter``, then four shifted adds).

Weights are ``torch.nn.Linear`` tensors ([out, in]; w0's columns in the
reference's interleaved plane order 2c + p, then posenc).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from havatar_tpu_torch.ops import cuda_build
from havatar_tpu_torch.ops import mlp as M
from havatar_tpu_torch.ops.grid_sample import _axis_weights, _unnormalize
from havatar_tpu_torch.utils.profiling import device_numbers

# widths the CUDA kernels are built for: the production field
C_PLANE, N_PE = 64, M.FIN - 2 * 64

Params = Tuple[torch.Tensor, ...]


@functools.lru_cache(maxsize=None)
def _perm(C: int, n_pe: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """layer0's input columns: block order [xy (C), zy (C), posenc] from the
    reference's interleaved order (as ``_perm_list``), and its inverse."""
    perm = ([2 * c for c in range(C)] + [2 * c + 1 for c in range(C)]
            + list(range(2 * C, 2 * C + n_pe)))
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(perm), tuple(inv)


def _cols(t: torch.Tensor, cols: Tuple[int, ...]) -> torch.Tensor:
    """t[:, cols], with the index on t's device (made there once)."""
    return t[:, device_numbers(cols, t.device, torch.int64)]


def _widths(quads: torch.Tensor, aux: torch.Tensor) -> Tuple[int, int]:
    if quads.dim() != 2 or quads.shape[1] % 8 or aux.dim() != 2 \
            or aux.shape[0] != quads.shape[0] or aux.shape[1] < 8:
        raise ValueError(f"expected quads [N, 8C] and aux [N, n_pe + 8], got "
                         f"{tuple(quads.shape)} and {tuple(aux.shape)}")
    return quads.shape[1] // 8, aux.shape[1] - 8


def _plane_widths(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                  rows: torch.Tensor, aux: torch.Tensor) -> Tuple[int, int]:
    """(C, n_pe) of the op's kernel contract, or ValueError."""
    if plane_xy.dim() != 3 or plane_zy.shape != plane_xy.shape \
            or min(plane_xy.shape[:2]) < 2:
        raise ValueError(f"expected two planes [H, W, C] of one shape, H and "
                         f"W at least 2, got {tuple(plane_xy.shape)} and "
                         f"{tuple(plane_zy.shape)}")
    if rows.dim() != 2 or rows.shape[1] != 2 or aux.dim() != 2 \
            or aux.shape[0] != rows.shape[0] or aux.shape[1] < 8:
        raise ValueError(f"expected rows [N, 2] and aux [N, n_pe + 8], got "
                         f"{tuple(rows.shape)} and {tuple(aux.shape)}")
    return plane_xy.shape[2], aux.shape[1] - 8


def _block_order(params: Sequence[torch.Tensor], C: int, n_pe: int) -> Params:
    perm, _ = _perm(C, n_pe)
    return (_cols(params[0], perm), *params[1:])


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
# corner rows: the cells, their gather and the splat of their gradients
# ---------------------------------------------------------------------------

def _corners(coords: torch.Tensor, H: int, W: int, padding_mode: str):
    """coords [N, 2] (x, y) -> (cell y0 * (W - 1) + x0 [N] int64, corner
    weights [N, 4]: y0x0, y0x1, y1x0, y1x1)."""
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


def quad_rows(warped: torch.Tensor, H: int, W: int,
              padding_mode: str = "zeros"):
    """warped [N, 3] -> (rows [N, 2] int32: the XY plane's cell at (x, y),
    the ZY plane's at (z, y); w8 [N, 8] float32, differentiable in
    warped). Both planes' cells in one pass over [2N] (x, y) pairs."""
    N = warped.shape[0]
    cells, w = _corners(_cols(warped, (0, 1, 2, 1)).reshape(2 * N, 2), H, W,
                        padding_mode)
    return cells.reshape(N, 2).int(), w.reshape(N, 8).float()


def _quad_pack(p: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> [(H-1)(W-1), 4C]: row (y0, x0) holds the four corner
    texels (y0|y0+1) x (x0|x0+1)."""
    H, W, C = p.shape
    return torch.stack([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]],
                       2).reshape((H - 1) * (W - 1), 4 * C)


def _table_rows(rows: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """rows [N, 2] -> [2N] int64 rows of the two planes' stacked quad
    table, each point's XY row then its ZY row."""
    out = rows.to(torch.int64, copy=True)
    out[:, 1] += (H - 1) * (W - 1)
    return out.reshape(-1)


def gather_rows(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """-> quads [N, 8C] in the planes' dtype: the XY plane's four corner
    texels of each point's cell ++ the ZY plane's. ``gather_rows.calls``
    counts its calls (the kernels gather for themselves)."""
    gather_rows.calls += 1
    H, W, _ = plane_xy.shape
    table = torch.cat([_quad_pack(plane_xy), _quad_pack(plane_zy)], 0)
    return table.index_select(0, _table_rows(rows, H, W)).reshape(
        rows.shape[0], -1)


gather_rows.calls = 0


def splat_quads(dq: torch.Tensor, rows: torch.Tensor, H: int, W: int,
                sorted_scatter: bool = False):
    """The adjoint of ``gather_rows``: dq [N, 8C] f32 -> (dplane_xy,
    dplane_zy) [H, W, C] f32. The [2N] corner-row updates are added into
    the quad table with ``index_add_`` (sorted by destination first with
    ``sorted_scatter``), which four shifted adds unpack into each plane."""
    C = dq.shape[1] // 8
    M_ = (H - 1) * (W - 1)
    idx, upd = _table_rows(rows, H, W), dq.reshape(-1, 4 * C)
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


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def quad_chain_plain(quads: torch.Tensor, aux: torch.Tensor,
                     *params: torch.Tensor) -> torch.Tensor:
    """The chain on gathered corner rows: quads [N, 8C] (float32 or bf16),
    aux [N, n_pe + 8] float32 -> [N, 3 + cf + 1] float32, differentiable by
    autograd."""
    C, n_pe = _widths(quads, aux)
    return M.fused_mlp_chain_plain(_reduce(quads, aux, C, n_pe),
                                   *_block_order(params, C, n_pe))


def quad_chain_bwd_plain(quads: torch.Tensor, aux: torch.Tensor,
                         g: torch.Tensor, *params: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """The chain's backward on gathered corner rows, its arithmetic written
    out: (dq [N, 8C] float32, daux [N, n_pe + 8] float32, the ten parameter
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
            (_cols(grads[0], inv), *grads[1:]))


def field_radiance_quad_plain(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                              rows: torch.Tensor, aux: torch.Tensor,
                              *params: torch.Tensor) -> torch.Tensor:
    """Plain twin of the forward kernel: planes [H, W, C] (float32 or
    bf16), rows [N, 2], aux [N, n_pe + 8] float32 -> [N, 3 + cf + 1]
    float32, differentiable by autograd in the planes, aux and
    parameters."""
    _plane_widths(plane_xy, plane_zy, rows, aux)
    return quad_chain_plain(gather_rows(plane_xy, plane_zy, rows), aux,
                            *params)


def field_radiance_quad_bwd_plain(plane_xy: torch.Tensor,
                                  plane_zy: torch.Tensor, rows: torch.Tensor,
                                  aux: torch.Tensor, g: torch.Tensor,
                                  *params: torch.Tensor,
                                  sorted_scatter: bool = False):
    """Plain twin of the backward kernel: (dplane_xy, dplane_zy [H, W, C]
    float32, daux [N, n_pe + 8] float32, the ten parameter gradients in
    each parameter's dtype and layout)."""
    _plane_widths(plane_xy, plane_zy, rows, aux)
    H, W, _ = plane_xy.shape
    dq, daux, grads = quad_chain_bwd_plain(
        gather_rows(plane_xy, plane_zy, rows), aux, g, *params)
    return (*splat_quads(dq, rows, H, W, sorted_scatter), daux, grads)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/quad.cu, built on first use, with its C signatures declared."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = cuda_build.load("quad")
    head = [P, P, I, I, P, P]        # planes, H, W, rows, aux
    lib.quad_forward_f32.argtypes = head + [P] * 11 + [L, P]
    lib.quad_forward_f32.restype = I
    lib.quad_forward_bf16.argtypes = head + [P] * 9 + [L, P]
    lib.quad_forward_bf16.restype = I
    lib.quad_backward_blocks.argtypes = [L, I, ctypes.POINTER(I)]
    lib.quad_backward_blocks.restype = I
    lib.quad_backward.argtypes = head + [P] * 16 + [I, P, L, I, P]
    lib.quad_backward.restype = I
    lib.quad_error_string.argtypes = [I]
    lib.quad_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        msg = lib.quad_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _check_cuda(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                rows: torch.Tensor, aux: torch.Tensor,
                params: Sequence[torch.Tensor]) -> None:
    """What the CUDA kernels take; anything else raises, nothing falls
    back."""
    C, n_pe = _plane_widths(plane_xy, plane_zy, rows, aux)
    if (C, n_pe) != (C_PLANE, N_PE):
        raise ValueError(f"the CUDA quad kernels are built for {C_PLANE} "
                         f"plane channels and posenc {N_PE}; got {C}, {n_pe}")
    if plane_xy.dtype not in (torch.float32, torch.bfloat16) \
            or plane_zy.dtype != plane_xy.dtype:
        raise TypeError(f"planes are {plane_xy.dtype} and {plane_zy.dtype}; "
                        f"the kernels take two float32 or two bfloat16")
    if aux.dtype != torch.float32:
        raise TypeError(f"aux is {aux.dtype}; the kernels take float32")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows are {rows.dtype}; the kernels take int32")
    for name, t in (("plane_xy", plane_xy), ("plane_zy", plane_zy),
                    ("rows", rows), ("aux", aux)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.device != plane_xy.device:
            raise ValueError(f"{name} is on {t.device}, plane_xy on "
                             f"{plane_xy.device}")
    x = plane_xy.new_empty(0, 2 * C + n_pe)    # the chain's input, as a shape
    M._check_shapes(x, params)
    M._check_cuda_widths(x, params)


def quad_forward(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                 rows: torch.Tensor, aux: torch.Tensor,
                 *params: torch.Tensor) -> torch.Tensor:
    """The op's forward: planes [H, W, C], rows [N, 2] int32, aux [N, n_pe +
    8] -> [N, 3 + cf + 1] f32, with no graph: the forward kernel for CUDA
    tensors, its plain twin for CPU ones."""
    if not plane_xy.is_cuda:
        with torch.no_grad():
            return field_radiance_quad_plain(plane_xy, plane_zy, rows, aux,
                                             *params)
    _check_cuda(plane_xy, plane_zy, rows, aux, params)
    block = _block_order(params, C_PLANE, N_PE)
    H, W, _ = plane_xy.shape
    N = rows.shape[0]
    out = torch.empty(N, 3 + M.CF + 1, dtype=torch.float32,
                      device=plane_xy.device)
    lib = _lib()
    head = (*M._ptrs(plane_xy.detach(), plane_zy.detach()), H, W,
            *M._ptrs(rows, aux.detach()))
    with torch.cuda.device(plane_xy.device):
        stream = torch.cuda.current_stream(plane_xy.device).cuda_stream
        if plane_xy.dtype == torch.float32:
            args = M._fwd_args_f32(block)
            err = lib.quad_forward_f32(*head, *M._ptrs(*args, out), N, stream)
        else:
            args = M._fwd_args_bf16(block)
            err = lib.quad_forward_bf16(*head, *M._ptrs(*args, out), N,
                                        stream)
    _raise_on(lib, err, "quad_forward")
    quad_forward.launches += 1
    field_radiance_quad.launches += 1
    return out


quad_forward.launches = 0


def quad_backward(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                  rows: torch.Tensor, aux: torch.Tensor, g: torch.Tensor,
                  *params: torch.Tensor, sorted_scatter: bool = False):
    """The op's backward: cotangent g [N, 3 + cf + 1] -> (dplane_xy,
    dplane_zy [H, W, C] f32, daux [N, n_pe + 8] f32, the ten parameter
    gradients in each parameter's dtype and layout). For CUDA tensors one
    launch of the backward kernel, which splats the plane gradients itself
    (``sorted_scatter`` has no order to choose there) and sums the weight
    gradients over its blocks in a fixed order, so that two launches agree
    bit for bit; the plain twin for CPU ones."""
    if not plane_xy.is_cuda:
        with torch.no_grad():
            return field_radiance_quad_bwd_plain(
                plane_xy, plane_zy, rows, aux, g, *params,
                sorted_scatter=sorted_scatter)
    _check_cuda(plane_xy, plane_zy, rows, aux, params)
    H, W, _ = plane_xy.shape
    N, dev = rows.shape[0], plane_xy.device
    if tuple(g.shape) != (N, 3 + M.CF + 1) or g.device != dev:
        raise ValueError(f"g has shape {tuple(g.shape)} on {g.device}, "
                         f"expected {(N, 3 + M.CF + 1)} on {dev}")
    block = _block_order(params, C_PLANE, N_PE)
    g = M._f32(g)
    bf16 = int(plane_xy.dtype == torch.bfloat16)
    lib = _lib()
    nblk = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _raise_on(lib, lib.quad_backward_blocks(N, bf16, ctypes.byref(nblk)),
                  "quad_backward")
        f32 = dict(dtype=torch.float32, device=dev)
        dxy = torch.zeros(H, W, C_PLANE, **f32)
        dzy = torch.zeros(H, W, C_PLANE, **f32)
        daux = torch.empty(N, N_PE + 8, **f32)
        part = torch.zeros(nblk.value, M.N_GRAD, **f32)
        flat = torch.zeros(M.N_GRAD, **f32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.quad_backward(
            *M._ptrs(plane_xy.detach(), plane_zy.detach()), H, W,
            *M._ptrs(rows, aux.detach(), g, *M._bwd_args(block, bool(bf16)),
                     dxy, dzy, daux, part),
            nblk.value, flat.data_ptr(), N, bf16, stream)
    _raise_on(lib, err, "quad_backward")
    quad_backward.launches += 1
    field_radiance_quad.launches += 1
    _, inv = _perm(C_PLANE, N_PE)
    grads = M.unflatten_grads(flat)
    # dw0's columns come in block order
    grads = (_cols(grads[0], inv), *grads[1:])
    return (dxy, dzy, daux,
            tuple(d.to(p.dtype) for d, p in zip(grads, params)))


quad_backward.launches = 0


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

class _FieldRadianceQuad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, padding_mode, sorted_scatter, plane_xy, plane_zy, warped,
                pe, *params):
        H, W, _ = plane_xy.shape
        rows, w8 = quad_rows(warped, H, W, padding_mode)
        out = quad_forward(plane_xy.contiguous(), plane_zy.contiguous(), rows,
                           torch.cat([pe.float(), w8], -1), *params)
        ctx.padding_mode, ctx.sorted_scatter = padding_mode, sorted_scatter
        # inputs only: the cells and weights are computed again
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
            rows, w8 = quad_rows(w_in, H, W, ctx.padding_mode)
        aux = torch.cat([pe.detach().float(), w8.detach()], -1)
        d_xy, d_zy, daux, dparams = quad_backward(
            plane_xy.detach().contiguous(), plane_zy.detach().contiguous(),
            rows, aux, g.contiguous(), *params,
            sorted_scatter=ctx.sorted_scatter)
        dwarped, = torch.autograd.grad(w8, w_in, daux[:, n_pe:])
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
    parameter; differentiating the backward raises. ``sorted_scatter``
    sorts the plain path's plane-gradient rows by destination before its
    ``index_add_``; the CUDA kernel splats in the kernel and has no scatter
    order to choose, so there it changes nothing."""
    return _FieldRadianceQuad.apply(padding_mode, bool(sorted_scatter),
                                    plane_xy, plane_zy, warped, pe, *params)


field_radiance_quad.launches = 0
