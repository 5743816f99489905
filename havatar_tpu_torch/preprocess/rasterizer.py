"""Orthographic z-buffered mesh rasterizer in plain PyTorch.

Port of ``havatar_tpu/preprocess/rasterizer.py``, which stands in for the
reference's PyTorch3D renderer (data_preprocessing/core/
FaceVerseModel_v3.py:27-98; the ortho condition renders, fit_video.py:
316-339; depth to normals, core/utils.py:397-422).

``rasterize_ortho`` loops over chunks of faces. For each chunk, the edge
functions of the pixels in the chunk's bounding box (two pixels wider) against
every face of the chunk are one dense [P', chunk] tensor (JAX evaluates
every pixel; the others get no hit either way); each pixel keeps the
nearest covering face: inclusive edges
(``>= 0``), either winding, ``|area| > 1e-12``, PyTorch3D's pixel grid.
Within a chunk ``argmin`` takes the lowest face index on a tie, and across
chunks a later chunk wins only if strictly nearer, so the result does not
depend on the chunk size, which only sets the peak memory: about seven
[P', chunk] float32 tensors live at once (at most 1.8 GB at 256^2 and
chunk 1024, when a chunk's box covers the image).

The reference's shader is ambient-only white light, so shading is the
interpolated vertex colour.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

DEFAULT_CHUNK = 1024


def chunk_peak_bytes(res: int, chunk: int) -> int:
    """The [P, chunk] float32 working set of one chunk (seven tensors)."""
    return 7 * res * res * chunk * 4


def _chunk_windows(x_ndc, y_ndc, faces, chunk: int, res: int):
    """Each chunk's pixel window (row0, row1, col0, col1), inclusive: the
    pixels whose centres lie within two pixels of the chunk's NDC bounding
    box, clipped to the image (row0 > row1 when it lies off the image). A
    pixel that far outside a face lies outside it by much more than
    rounding can move an edge function, so the windows drop no hit. One
    host read for all chunks."""
    F = faces.shape[0]
    n = -(-F // chunk)
    fx, fy = x_ndc[faces], y_ndc[faces]                   # [F, 3]
    pad = n * chunk - F

    def per_chunk(v, fn):
        v = fn(v, dim=1).values
        if pad:
            v = torch.cat([v, v[-1:].expand(pad)])
        return fn(v.reshape(n, chunk), dim=1).values

    box = torch.stack([per_chunk(fx, torch.min), per_chunk(fx, torch.max),
                       per_chunk(fy, torch.min), per_chunk(fy, torch.max)],
                      1).double().cpu().numpy()
    half = res / 2.0
    out = []
    for xmin, xmax, ymin, ymax in box:
        # x = -(j + 0.5 - half) / half  <=>  j = half (1 - x) - 0.5
        c0 = max(int(math.floor(half * (1 - xmax) - 0.5)) - 2, 0)
        c1 = min(int(math.ceil(half * (1 - xmin) - 0.5)) + 2, res - 1)
        r0 = max(int(math.floor(half * (1 - ymax) - 0.5)) - 2, 0)
        r1 = min(int(math.ceil(half * (1 - ymin) - 0.5)) + 2, res - 1)
        out.append((r0, r1, c0, c1))
    return out


def _pixel_grid(res: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC pixel centres, PyTorch3D's convention: +x left, +y up, +-1 at
    the image's edges (row 0 / column 0 is +1)."""
    half = res / 2.0
    idx = (torch.arange(res, dtype=torch.float32, device=device)
           + 0.5 - half) / half
    return -idx, -idx


def rasterize_ortho(verts: torch.Tensor, faces: torch.Tensor,
                    attrs: torch.Tensor, K4, res: int = 256,
                    chunk: int = DEFAULT_CHUNK
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """verts [V, 3] in camera space, faces [F, 3], attrs [V, C]; K4 =
    (fx, fy, cx, cy) NDC ortho intrinsics (x_ndc = fx x + cx) ->
    (image [res, res, C], depth [res, res] (-z of the nearest face, 0
    where none covers the pixel), hit mask [res, res])."""
    fx, fy, cx, cy = (float(k) for k in K4)
    dev = verts.device
    x_ndc = fx * verts[:, 0] + cx
    y_ndc = fy * verts[:, 1] + cy
    z = -verts[:, 2]                      # smaller is nearer

    xs, ys = _pixel_grid(res, dev)
    P, C = res * res, attrs.shape[-1]
    best_z = torch.full((P,), float("inf"), device=dev)
    best_a = torch.zeros(P, C, dtype=attrs.dtype, device=dev)
    hit = torch.zeros(P, dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), device=dev)

    for f0, (r0, r1, c0, c1) in zip(range(0, faces.shape[0], chunk),
                                     _chunk_windows(x_ndc, y_ndc, faces,
                                                    chunk, res)):
        if r0 > r1 or c0 > c1:
            continue                      # the chunk lies off the image
        fc = faces[f0:f0 + chunk]
        rr = torch.arange(r0, r1 + 1, device=dev)
        cc = torch.arange(c0, c1 + 1, device=dev)
        pix = (rr[:, None] * res + cc[None, :]).reshape(-1)       # [P']
        px = xs[cc][None, :].expand(len(rr), -1).reshape(-1, 1)
        py = ys[rr][:, None].expand(-1, len(cc)).reshape(-1, 1)
        rows = torch.arange(pix.shape[0], device=dev)
        i0, i1, i2 = fc[:, 0], fc[:, 1], fc[:, 2]
        x0, y0, z0 = x_ndc[i0], y_ndc[i0], z[i0]
        x1, y1, z1 = x_ndc[i1], y_ndc[i1], z[i1]
        x2, y2, z2 = x_ndc[i2], y_ndc[i2], z[i2]

        def edge(ax, ay, bx, by):
            # (bx - ax) (py - ay) - (by - ay) (px - ax), two temporaries
            w = (py - ay).mul_(bx - ax)
            return w.sub_((px - ax).mul_(by - ay))

        w0 = edge(x1, y1, x2, y2)
        w1 = edge(x2, y2, x0, y0)
        w2 = edge(x0, y0, x1, y1)
        area = w0 + w1
        area += w2
        s = torch.sign(area)
        valid = area.abs() > 1e-12
        inside = (w0 * s >= 0)
        inside &= (w1 * s >= 0)
        inside &= (w2 * s >= 0)
        inside &= valid
        denom = torch.where(valid, area, torch.ones_like(area))
        del area, s, valid
        w0.div_(denom)                    # the barycentric weights
        w1.div_(denom)
        w2.div_(denom)
        del denom
        zpix = w0 * z0
        zpix += w1 * z1
        zpix += w2 * z2
        zpix = torch.where(inside, zpix, inf)
        del inside

        amin = zpix.argmin(dim=1)                            # [P']
        zmin = zpix[rows, amin]
        del zpix
        fsel = fc[amin]                                      # [P', 3]
        attr = (attrs[fsel[:, 0]] * w0[rows, amin][:, None]
                + attrs[fsel[:, 1]] * w1[rows, amin][:, None]
                + attrs[fsel[:, 2]] * w2[rows, amin][:, None])
        del w0, w1, w2

        better = zmin < best_z[pix]
        best_z[pix] = torch.where(better, zmin, best_z[pix])
        best_a[pix] = torch.where(better[:, None], attr, best_a[pix])
        hit[pix] |= better & torch.isfinite(zmin)

    img = torch.where(hit[:, None], best_a, 0.0).reshape(res, res, C)
    depth = torch.where(hit, best_z, 0.0).reshape(res, res)
    return img, depth, hit.reshape(res, res)


def depth2normal_ortho(depth: torch.Tensor, dx: float,
                       dy: float) -> torch.Tensor:
    """[H, W] ortho depth -> [H, W, 3] normals from the crosses of the
    4-neighbourhood (core/utils.py:397-422); a 1-pixel zero border."""
    H, W = depth.shape
    Y, X = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=depth.device),
        torch.arange(W, dtype=torch.float32, device=depth.device),
        indexing="ij")
    p = torch.stack([X * dx, Y * dy, depth], dim=-1)

    def norm(v):
        return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-8)

    ctr = p[1:-1, 1:-1]
    vw = ctr - p[1:-1, 2:]
    vs = p[2:, 1:-1] - ctr
    ve = ctr - p[1:-1, :-2]
    vn = p[:-2, 1:-1] - ctr
    n1 = norm(torch.linalg.cross(vs, vw, dim=-1))
    n2 = norm(torch.linalg.cross(vn, ve, dim=-1))
    n = norm(n1 + n2)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def render_ortho_condition(verts: torch.Tensor, faces: torch.Tensor,
                           colors: torch.Tensor, rot: torch.Tensor, K4,
                           res: int = 256
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One orthographic condition view of box-warped canonical vertices
    [V, 3] with vertex colours [V, 3] (0-255), turned by ``rot`` (right-
    multiplied) -> (render [res, res, 3] clipped to 0-255, normal image
    [res, res, 3] in 0-255, zero off the mesh and where a colour channel
    is not positive): the per-view body of render_canonical_ortho
    (fit_video.py:316-339)."""
    img, depth, mask = rasterize_ortho(verts @ rot, faces, colors, K4, res)
    normal = depth2normal_ortho(depth, dx=float(K4[0]) / (res // 2),
                                dy=float(K4[1]) / (res // 2))
    normal_img = (normal + 1.0) * 127.5
    normal_img = torch.where(mask[..., None], normal_img, 0.0)
    img = img.clamp(0, 255)
    color_mask = (img > 0).all(dim=-1, keepdim=True)
    return img, normal_img * color_mask
