"""The fused ray-march kernels: field MLP + alpha compositing per ray.

Port of the four kernels of ``havatar_tpu/ops/pallas_march.py``:

=================  ===========================  ==========================
wrapper            TPU kernel                   input stage
=================  ===========================  ==========================
``march_coarse``   ``fused_march_coarse_quad``  the planes and the cells:
``march_fine``     ``fused_march_fine_quad``    gather and corner
                                                reduction in the kernel
``march_coarse_x`` ``fused_march_coarse``       the MLP input, already
``march_fine_x``   ``fused_march_fine``         reduced
=================  ===========================  ==========================

Each has

* a wrapper that launches its own CUDA kernel of ``csrc/march.cu`` for CUDA
  tensors, counts its launches in ``<wrapper>.launches``, and raises on any
  input the kernel does not take;
* a plain PyTorch twin of the same function, on the wrapper's own contract
  (``march_coarse_gather_plain``, ``march_fine_gather_plain``,
  ``march_coarse_x_plain``, ``march_fine_x_plain``). The wrapper runs the
  twin only when it is given CPU tensors; on a CUDA tensor it launches the
  kernel or raises.

Inputs of the quad pair, per sample: its bilinear cell in each of the two
feature planes, ``rows [R, S, 2]`` int32 (y0 * (W - 1) + x0, from
``ops/mlp_quad.py:quad_rows``), and ``aux [R, S, n_pe + 8]`` f32 (posenc ++
the 8 corner weights), beside the planes ``[B, H, W, C]`` (XY and ZY, one
pair a batch item; ray r belongs to item r // (R // B)). The kernels gather
each cell's four corner texels from the planes, corner-reduce them in f32
and round the MLP input [xy | zy | posenc] ("block" order, layer0's columns
permuted to match) to the compute dtype (the planes' dtype). Their twins
gather the corner rows ``quads [R, S, 8C]`` (XY quad row ++ ZY quad row,
corner-major) with ``gather_rows`` and run ``march_coarse_plain`` /
``march_fine_plain``, the twins on the TPU kernels' own contract (corner
rows in), which the CPU tests hold against them. The ``_x`` pair takes the
rounded MLP input itself, ``x [R, S, 2C + n_pe]``, in the reference's
"interleaved" order (plane feature 2c + p, then posenc) with layer0 as the
checkpoint holds it. ``MarchParams.order`` says which of the two a
parameter set is for, and each wrapper and twin raises on the other. All
four run the 5-layer field MLP with compute-dtype inputs and f32
accumulation, and composite with alpha = 1 - exp(-relu(sigma) * delta).

The coarse pass also writes the "keeps": every 2nd sample's radiance packed
[feat (cf) | rgb (3) | sigma_hi | sigma_lo] in bf16, which the fine pass
reuses instead of re-evaluating those samples. The fine pass composites
keeps ++ new samples in CONCAT order with per-ray merge ranks (a
permutation of 0 .. Sa - 1 a ray):
T_i = prod over j with rank_j < rank_i of (1 - alpha_j + 1e-10).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from havatar_tpu_torch.ops import cuda_build
from havatar_tpu_torch.ops.mlp_quad import gather_rows
from havatar_tpu_torch.ops.volume_render import cumprod_exclusive


class MarchParams(NamedTuple):
    """The field MLP as the kernels take it (torch Linear layout [out, in]).

    ``order`` names the channel order of w0's input columns: "block" is
    [xy (C) | zy (C) | posenc], permuted from the reference for the kernels
    that reduce corner rows; "interleaved" is the reference's own (plane
    feature index 2c + p, then posenc) for the kernels that take the reduced
    input. wh stacks fc_rgbFeat's rows (cf) and fc_alpha's row (1).
    """
    w0: torch.Tensor   # [H, 2C + n_pe]
    b0: torch.Tensor   # [H] f32
    w1: torch.Tensor   # [H, H]
    b1: torch.Tensor   # [H] f32
    wh: torch.Tensor   # [cf + 1, H]
    bh: torch.Tensor   # [cf + 1] f32
    wr: torch.Tensor   # [3, cf]
    br: torch.Tensor   # [3] f32
    order: str = "block"

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self[:8])

    def to(self, device) -> "MarchParams":
        return MarchParams(*(t.to(device) for t in self.tensors()),
                           order=self.order)


def march_params(layers_xyz, fc_rgbFeat, fc_alpha, fc_rgb, C: int,
                 n_pe: int, dtype: torch.dtype,
                 permute: bool = True) -> MarchParams:
    """Field Linear modules -> MarchParams with weights in ``dtype``:
    layer0's columns in block order (``permute=True``, for ``march_coarse``
    and ``march_fine``) or left interleaved (``permute=False``, for
    ``march_coarse_x`` and ``march_fine_x``)."""
    if permute:
        perm = ([2 * c for c in range(C)] + [2 * c + 1 for c in range(C)]
                + list(range(2 * C, 2 * C + n_pe)))
    else:
        perm = list(range(2 * C + n_pe))
    l0, l1 = layers_xyz

    def w(t):
        return t.detach().to(dtype).contiguous()

    def b(t):
        return t.detach().float().contiguous()

    return MarchParams(
        w(l0.weight[:, perm]), b(l0.bias), w(l1.weight), b(l1.bias),
        w(torch.cat([fc_rgbFeat.weight, fc_alpha.weight], 0)),
        b(torch.cat([fc_rgbFeat.bias, fc_alpha.bias], 0)),
        w(fc_rgb.weight), b(fc_rgb.bias),
        order="block" if permute else "interleaved")


def _check_order(mp: MarchParams, order: str, who: str) -> None:
    if mp.order != order:
        raise ValueError(
            f"{who} takes layer0 in {order} channel order, got MarchParams "
            f"in {mp.order} order (march_params(..., permute="
            f"{order == 'block'}))")


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def _build_x(q2: torch.Tensor, aux2: torch.Tensor, C: int,
             n_pe: int) -> torch.Tensor:
    """[T, 8C] quad rows + [T, n_pe+8] aux -> MLP input [T, 2C + n_pe] in
    block order, in the quads' dtype (corner reduction in f32)."""
    def reduce(first):
        acc = q2[:, first * C:(first + 1) * C].float() * aux2[:, n_pe + first, None]
        for k in range(first + 1, first + 4):
            acc = acc + q2[:, k * C:(k + 1) * C].float() * aux2[:, n_pe + k, None]
        return acc

    return torch.cat([reduce(0), reduce(4), aux2[:, :n_pe]], 1).to(q2.dtype)


def _mlp(x: torch.Tensor, mp: MarchParams):
    """[T, Fin] -> (rgb [T, 3], feat [T, cf], sigma [T]), f32. Weights are
    rounded to x's dtype; products and sums in f32; hidden activations
    rounded to x's dtype, as in the kernel."""
    f, cdt = torch.float32, x.dtype

    def w(t):
        return t.to(cdt).to(f)

    h = torch.relu(x.to(f) @ w(mp.w0).T + mp.b0).to(cdt)
    h = torch.relu(h.to(f) @ w(mp.w1).T + mp.b1).to(cdt)
    out = h.to(f) @ w(mp.wh).T + mp.bh
    cf = mp.wr.shape[1]
    feat, sigma = out[:, :cf], out[:, cf]
    rgb = feat.to(cdt).to(f) @ w(mp.wr).T + mp.br
    return rgb, feat, sigma


def _alpha(sigma: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.exp(-torch.relu(sigma) * dists)


def march_coarse_plain(quads: torch.Tensor, aux: torch.Tensor,
                       dists: torch.Tensor, mp: MarchParams
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the coarse kernel. Returns (rgbmap [R, 3+cf] f32 with
    no background, weights [R, S] f32, keeps [R*S/2, cf+5] bf16)."""
    _check_order(mp, "block", "march_coarse")
    R, S, qc = quads.shape
    C, n_pe = qc // 8, aux.shape[-1] - 8
    x = _build_x(quads.reshape(R * S, qc), aux.reshape(R * S, -1), C, n_pe)
    return _coarse_composite(x, R, S, dists, mp)


def march_coarse_x_plain(x: torch.Tensor, dists: torch.Tensor,
                         mp: MarchParams
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the reduced-input coarse kernel: x [R, S, fin] is the
    MLP input in interleaved order. Returns as ``march_coarse_plain``."""
    _check_order(mp, "interleaved", "march_coarse_x")
    R, S, fin = x.shape
    return _coarse_composite(x.reshape(R * S, fin), R, S, dists, mp)


def _coarse_composite(x2: torch.Tensor, R: int, S: int, dists: torch.Tensor,
                      mp: MarchParams):
    rgb, feat, sigma = _mlp(x2, mp)
    cf = feat.shape[-1]
    rgb3, feat3, sig2 = rgb.view(R, S, 3), feat.view(R, S, cf), sigma.view(R, S)
    alpha = _alpha(sig2, dists)
    w = alpha * cumprod_exclusive(1.0 - alpha + 1e-10)
    rgbmap = torch.cat([(w[..., None] * torch.sigmoid(rgb3)).sum(1),
                        (w[..., None] * feat3).sum(1)], -1)
    sig_k = sig2[:, ::2, None]
    hi = sig_k.to(torch.bfloat16)
    lo = (sig_k - hi.float()).to(torch.bfloat16)
    keeps = torch.cat([feat3[:, ::2].to(torch.bfloat16),
                       rgb3[:, ::2].to(torch.bfloat16), hi, lo], -1)
    return rgbmap, w, keeps.reshape(R * (S // 2), cf + 5)


def march_fine_plain(q_new: torch.Tensor, aux_new: torch.Tensor,
                     keeps: torch.Tensor, d_concat: torch.Tensor,
                     ranks: torch.Tensor, mp: MarchParams, num_keep: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the fine kernel. Returns (rgbmap [R, 3+cf] f32 with no
    background, weights [R, Sk+Sn] f32 in concat order)."""
    _check_order(mp, "block", "march_fine")
    R, Sn, qc = q_new.shape
    C, n_pe = qc // 8, aux_new.shape[-1] - 8
    x = _build_x(q_new.reshape(R * Sn, qc), aux_new.reshape(R * Sn, -1),
                 C, n_pe)
    return _fine_composite(x, R, Sn, keeps, d_concat, ranks, mp, num_keep)


def _items(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
           rows: torch.Tensor, aux: torch.Tensor) -> Tuple[int, int]:
    """(B, rays an item) of the quad pair's contract, or ValueError."""
    if plane_xy.dim() != 4 or plane_zy.shape != plane_xy.shape \
            or min(plane_xy.shape[1:3]) < 2:
        raise ValueError(f"expected two planes [B, H, W, C] of one shape, H "
                         f"and W at least 2, got {tuple(plane_xy.shape)} and "
                         f"{tuple(plane_zy.shape)}")
    if rows.dim() != 3 or rows.shape[2] != 2 or aux.dim() != 3 \
            or aux.shape[:2] != rows.shape[:2] or aux.shape[2] < 8:
        raise ValueError(f"expected rows [R, S, 2] and aux [R, S, n_pe + 8], "
                         f"got {tuple(rows.shape)} and {tuple(aux.shape)}")
    B, R = plane_xy.shape[0], rows.shape[0]
    if R % B:
        raise ValueError(f"{R} rays do not split into {B} batch items")
    return B, R // B


def gather_quads(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """The corner rows the quad kernels gather for themselves: planes
    [B, H, W, C], rows [R, S, 2] -> quads [R, S, 8C] in the planes' dtype
    (``gather_rows`` on each batch item's planes and rays)."""
    B = plane_xy.shape[0]
    R, S, _ = rows.shape
    Ri = R // B
    return torch.cat([
        gather_rows(plane_xy[b], plane_zy[b],
                    rows[b * Ri:(b + 1) * Ri].reshape(-1, 2))
        for b in range(B)]).reshape(R, S, -1)


def march_coarse_gather_plain(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                              rows: torch.Tensor, aux: torch.Tensor,
                              dists: torch.Tensor, mp: MarchParams
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain twin of the coarse kernel: the corner rows' gather, then
    ``march_coarse_plain``. Returns as ``march_coarse_plain``."""
    _items(plane_xy, plane_zy, rows, aux)
    return march_coarse_plain(gather_quads(plane_xy, plane_zy, rows), aux,
                              dists, mp)


def march_fine_gather_plain(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                            rows_new: torch.Tensor, aux_new: torch.Tensor,
                            keeps: torch.Tensor, d_concat: torch.Tensor,
                            ranks: torch.Tensor, mp: MarchParams,
                            num_keep: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the fine kernel: the new samples' corner rows, then
    ``march_fine_plain``. Returns as ``march_fine_plain``."""
    _items(plane_xy, plane_zy, rows_new, aux_new)
    return march_fine_plain(gather_quads(plane_xy, plane_zy, rows_new),
                            aux_new, keeps, d_concat, ranks, mp, num_keep)


def march_fine_x_plain(x_new: torch.Tensor, keeps: torch.Tensor,
                       d_concat: torch.Tensor, ranks: torch.Tensor,
                       mp: MarchParams, num_keep: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the reduced-input fine kernel: x_new [R, Sn, fin] is the
    new samples' MLP input in interleaved order. Returns as
    ``march_fine_plain``."""
    _check_order(mp, "interleaved", "march_fine_x")
    R, Sn, fin = x_new.shape
    return _fine_composite(x_new.reshape(R * Sn, fin), R, Sn, keeps,
                           d_concat, ranks, mp, num_keep)


def _fine_composite(x2: torch.Tensor, R: int, Sn: int, keeps: torch.Tensor,
                    d_concat: torch.Tensor, ranks: torch.Tensor,
                    mp: MarchParams, Sk: int):
    rgb_n, feat_n, sig_n = _mlp(x2, mp)
    cf = feat_n.shape[-1]
    k = keeps.view(R, Sk, cf + 5).float()
    kfeat, krgb = k[..., :cf], k[..., cf:cf + 3]
    sig = torch.cat([k[..., cf + 3] + k[..., cf + 4], sig_n.view(R, Sn)], 1)
    alpha = _alpha(sig, d_concat)
    om = 1.0 - alpha + 1e-10
    before = ranks[:, :, None] < ranks[:, None, :]       # [R, j, i]
    T = torch.where(before, om[:, :, None], torch.ones_like(om[:, :, None]))
    w = alpha * T.prod(dim=1)
    wk, wn = w[:, :Sk, None], w[:, Sk:, None]
    rgb_map = ((wk * torch.sigmoid(krgb)).sum(1)
               + (wn * torch.sigmoid(rgb_n.view(R, Sn, 3))).sum(1))
    feat_map = (wk * kfeat).sum(1) + (wn * feat_n.view(R, Sn, cf)).sum(1)
    return torch.cat([rgb_map, feat_map], -1), w


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """csrc/march.cu, built on first use, with its C signatures declared."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = cuda_build.load("march")
    lib.march_coarse.argtypes = [P] * 16 + [I] * 9 + [P]
    lib.march_coarse.restype = I
    lib.march_fine.argtypes = [P] * 17 + [I] * 10 + [P]
    lib.march_fine.restype = I
    lib.march_coarse_x.argtypes = [P] * 13 + [I] * 5 + [P]
    lib.march_coarse_x.restype = I
    lib.march_fine_x.argtypes = [P] * 14 + [I] * 6 + [P]
    lib.march_fine_x.restype = I
    lib.march_fine_fits.argtypes = [I] * 3
    lib.march_fine_fits.restype = I
    lib.march_error_string.argtypes = [I]
    lib.march_error_string.restype = ctypes.c_char_p
    return lib


def _expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
            device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_x_widths(S: int, fin: int, mp: MarchParams) -> None:
    H, cf = mp.w0.shape[0], mp.wr.shape[1]
    if H != 128 or cf != 64:
        raise ValueError(f"the CUDA march kernels are built for hidden=128, "
                         f"feat=64; got hidden={H}, feat={cf}")
    if S <= 0 or 128 % S or fin % 16:
        raise ValueError(f"unsupported march widths: samples per ray {S} "
                         f"must divide 128 and the MLP input width {fin} "
                         f"be a multiple of 16")


def _check_widths(S: int, C: int, n_pe: int, mp: MarchParams) -> None:
    """Widths of the quad pair: the gather reads 64 channels a plane (four
    a lane) and the aux rows in 16-byte chunks, at most 64 floats a row."""
    if C != 64 or n_pe % 4 or n_pe + 8 > 64:
        raise ValueError(f"unsupported march widths: the gathering kernels "
                         f"take C=64 plane channels and n_pe a multiple of 4 "
                         f"up to 56; got C={C}, n_pe={n_pe}")
    _check_x_widths(S, 2 * C + n_pe, mp)


def _check_fine_scratch(lib: ctypes.CDLL, Sn: int, Sk: int,
                        fin: int) -> None:
    """The fine compositing keeps its elements (keeps ++ new samples of a
    warp's rays, or of one ray's warps past 16 samples) in one warp's
    shared-memory scratch; ``csrc/march.cu:march_fine_fits`` says whether
    they fit."""
    if not lib.march_fine_fits(Sn, Sk, fin):
        raise ValueError(f"the fine kernels' scratch does not hold "
                         f"num_keep={Sk} + Sn={Sn} elements a ray at MLP "
                         f"input width {fin}")


def _check_params(mp: MarchParams, fin: int, device: torch.device) -> None:
    H, cf = mp.w0.shape[0], mp.wr.shape[1]
    bf, f32 = torch.bfloat16, torch.float32
    for name, t, dt, shape in (
            ("w0", mp.w0, bf, (H, fin)), ("b0", mp.b0, f32, (H,)),
            ("w1", mp.w1, bf, (H, H)), ("b1", mp.b1, f32, (H,)),
            ("wh", mp.wh, bf, (cf + 1, H)), ("bh", mp.bh, f32, (cf + 1,)),
            ("wr", mp.wr, bf, (3, cf)), ("br", mp.br, f32, (3,))):
        _expect(t, name, dt, shape, device)


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        msg = lib.march_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _planes_rows(plane_xy, plane_zy, rows, aux, dev):
    """Check the quad pair's input stage; (B, H, W, R, S, C, n_pe)."""
    B, _ = _items(plane_xy, plane_zy, rows, aux)
    _, H, W, C = plane_xy.shape
    R, S, _ = rows.shape
    n_pe = aux.shape[-1] - 8
    _expect(plane_xy, "plane_xy", torch.bfloat16, (B, H, W, C), dev)
    _expect(plane_zy, "plane_zy", torch.bfloat16, (B, H, W, C), dev)
    _expect(rows, "rows", torch.int32, (R, S, 2), dev)
    _expect(aux, "aux", torch.float32, (R, S, n_pe + 8), dev)
    return B, H, W, R, S, C, n_pe


def march_coarse(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
                 rows: torch.Tensor, aux: torch.Tensor, dists: torch.Tensor,
                 mp: MarchParams
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coarse pass. plane_xy, plane_zy [B, H, W, C] (bf16 on CUDA, C = 64),
    rows [R, S, 2] int32 (each sample's cell in both planes), aux
    [R, S, n_pe+8] f32, dists [R, S] f32 (already scaled by |rd|). Returns
    (rgbmap [R, 3+cf] f32 with no background, weights [R, S] f32, keeps
    [R*S/2, cf+5] bf16)."""
    if not plane_xy.is_cuda:
        return march_coarse_gather_plain(plane_xy, plane_zy, rows, aux,
                                         dists, mp)
    dev = plane_xy.device
    B, H, W, R, S, C, n_pe = _planes_rows(plane_xy, plane_zy, rows, aux, dev)
    hid, cf = mp.w0.shape[0], mp.wr.shape[1]
    _check_order(mp, "block", "march_coarse")
    _check_widths(S, C, n_pe, mp)
    if S % 2:
        raise ValueError(f"the coarse pass keeps every 2nd sample: S={S}")
    _expect(dists, "dists", torch.float32, (R, S), dev)
    _check_params(mp, 2 * C + n_pe, dev)
    rgbmap = torch.empty(R, 3 + cf, dtype=torch.float32, device=dev)
    weights = torch.empty(R, S, dtype=torch.float32, device=dev)
    keeps = torch.empty(R * (S // 2), cf + 5, dtype=torch.bfloat16,
                        device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.march_coarse(
            *_ptrs(plane_xy, plane_zy, rows, aux, dists, *mp.tensors(),
                   rgbmap, weights, keeps),
            B, H, W, R, S, C, n_pe, hid, cf, stream)
    _raise_on(lib, err, "march_coarse")
    march_coarse.launches += 1
    return rgbmap, weights, keeps


march_coarse.launches = 0


def march_fine(plane_xy: torch.Tensor, plane_zy: torch.Tensor,
               rows_new: torch.Tensor, aux_new: torch.Tensor,
               keeps: torch.Tensor, d_concat: torch.Tensor,
               ranks: torch.Tensor, mp: MarchParams, num_keep: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine pass over keeps ++ new samples in concat order. The planes as
    ``march_coarse``; rows_new [R, Sn, 2] int32 and aux_new [R, Sn, n_pe+8]
    f32 of the new samples; keeps [R*Sk, cf+5] bf16 from ``march_coarse``,
    d_concat [R, Sa] f32 (each element's sorted-neighbour delta times |rd|),
    ranks [R, Sa] int32 (each element's sorted position). Returns (rgbmap
    [R, 3+cf] f32 with no background, weights [R, Sa] f32 in concat
    order)."""
    if not plane_xy.is_cuda:
        return march_fine_gather_plain(plane_xy, plane_zy, rows_new,
                                       aux_new, keeps, d_concat, ranks, mp,
                                       num_keep)
    dev = plane_xy.device
    B, H, W, R, Sn, C, n_pe = _planes_rows(plane_xy, plane_zy, rows_new,
                                           aux_new, dev)
    Sk = int(num_keep)
    Sa = Sk + Sn
    hid, cf = mp.w0.shape[0], mp.wr.shape[1]
    _check_order(mp, "block", "march_fine")
    _check_widths(Sn, C, n_pe, mp)
    lib = _lib()
    _check_fine_scratch(lib, Sn, Sk, 2 * C + n_pe)
    _expect(keeps, "keeps", torch.bfloat16, (R * Sk, cf + 5), dev)
    _expect(d_concat, "d_concat", torch.float32, (R, Sa), dev)
    _expect(ranks, "ranks", torch.int32, (R, Sa), dev)
    _check_params(mp, 2 * C + n_pe, dev)
    rgbmap = torch.empty(R, 3 + cf, dtype=torch.float32, device=dev)
    weights = torch.empty(R, Sa, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.march_fine(
            *_ptrs(plane_xy, plane_zy, rows_new, aux_new, keeps, d_concat,
                   ranks, *mp.tensors(), rgbmap, weights),
            B, H, W, R, Sn, Sk, C, n_pe, hid, cf, stream)
    _raise_on(lib, err, "march_fine")
    march_fine.launches += 1
    return rgbmap, weights


march_fine.launches = 0


def march_coarse_x(x: torch.Tensor, dists: torch.Tensor, mp: MarchParams
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coarse pass on the reduced MLP input. x [R, S, fin] (bf16 on CUDA,
    interleaved channel order), dists [R, S] f32 (already scaled by |rd|),
    ``mp`` from ``march_params(..., permute=False)``. Returns as
    ``march_coarse``."""
    if not x.is_cuda:
        return march_coarse_x_plain(x, dists, mp)
    R, S, fin = x.shape
    H, cf = mp.w0.shape[0], mp.wr.shape[1]
    dev = x.device
    _check_order(mp, "interleaved", "march_coarse_x")
    _check_x_widths(S, fin, mp)
    if S % 2:
        raise ValueError(f"the coarse pass keeps every 2nd sample: S={S}")
    _expect(x, "x", torch.bfloat16, (R, S, fin), dev)
    _expect(dists, "dists", torch.float32, (R, S), dev)
    _check_params(mp, fin, dev)
    rgbmap = torch.empty(R, 3 + cf, dtype=torch.float32, device=dev)
    weights = torch.empty(R, S, dtype=torch.float32, device=dev)
    keeps = torch.empty(R * (S // 2), cf + 5, dtype=torch.bfloat16,
                        device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.march_coarse_x(
            *_ptrs(x, dists, *mp.tensors(), rgbmap, weights, keeps),
            R, S, fin, H, cf, stream)
    _raise_on(lib, err, "march_coarse_x")
    march_coarse_x.launches += 1
    return rgbmap, weights, keeps


march_coarse_x.launches = 0


def march_fine_x(x_new: torch.Tensor, keeps: torch.Tensor,
                 d_concat: torch.Tensor, ranks: torch.Tensor,
                 mp: MarchParams, num_keep: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fine pass on the new samples' reduced MLP input. x_new [R, Sn, fin]
    (bf16 on CUDA, interleaved channel order); keeps, d_concat, ranks and
    the result as ``march_fine``; ``mp`` from
    ``march_params(..., permute=False)``."""
    if not x_new.is_cuda:
        return march_fine_x_plain(x_new, keeps, d_concat, ranks, mp,
                                  num_keep)
    R, Sn, fin = x_new.shape
    Sk = int(num_keep)
    Sa = Sk + Sn
    H, cf = mp.w0.shape[0], mp.wr.shape[1]
    dev = x_new.device
    _check_order(mp, "interleaved", "march_fine_x")
    _check_x_widths(Sn, fin, mp)
    lib = _lib()
    _check_fine_scratch(lib, Sn, Sk, fin)
    _expect(x_new, "x_new", torch.bfloat16, (R, Sn, fin), dev)
    _expect(keeps, "keeps", torch.bfloat16, (R * Sk, cf + 5), dev)
    _expect(d_concat, "d_concat", torch.float32, (R, Sa), dev)
    _expect(ranks, "ranks", torch.int32, (R, Sa), dev)
    _check_params(mp, fin, dev)
    rgbmap = torch.empty(R, 3 + cf, dtype=torch.float32, device=dev)
    weights = torch.empty(R, Sa, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.march_fine_x(
            *_ptrs(x_new, keeps, d_concat, ranks, *mp.tensors(), rgbmap,
                   weights), R, Sn, Sk, fin, H, cf, stream)
    _raise_on(lib, err, "march_fine_x")
    march_fine_x.launches += 1
    return rgbmap, weights


march_fine_x.launches = 0
