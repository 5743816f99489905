// The field MLP on tensor cores, shared by the CUDA sources that run it
// (mlp.cu: the bf16 forwards of the fused dense chain and of the field
// kernel; quad.cu: the bf16 forward of the quad field op; march.cu: the four
// march kernels), with two input stages (a copy of reduced rows, or the
// gather and corner reduction of the corner texels straight from the
// planes). A persistent block stages the five weight matrices in shared
// memory once (bf16, rows padded so fragment loads hit distinct banks);
// each warp then owns 16 rows of the input tile and runs the chain on them
// with mma.sync m16n8k16 (bf16 in, f32 accumulate). Only the input rows
// and the f32 features touch shared memory: an m16n8 accumulator, rounded
// to bf16, is the next product's A fragment, so the hidden activations
// stay in registers, and ldmatrix loads the fragments.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {


typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kWarps = 16;  // a block: one an SM, beside the weights
constexpr int kThreads = kWarps * 32;
constexpr int kPoints = kWarps * 16;  // one 16-row MMA tile per warp
constexpr int kPad = 8;               // bf16 row padding: spreads banks

// Shared memory: the weights and biases, then the input tile (a warp's 16
// rows [16][ldx] bf16 after the other's; once layer0 has read them, the
// warp's f32 feature rows [16][ldf] lie over them), sigma [rows] and raw
// rgb [rows][3] f32 at tile rows, and the input stage's own (extra).
struct Layout {
  int fin, ldw0, ldw1, ldwh, ldwr, ldx, ldf;
  size_t w0, w1, wh, wr, b0, b1, bh, br, x, sig, rgb, extra, total;
};

inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

// fin % 16 == 0; a tile of `rows` rows (16 a warp); input rows at least
// min_width wide (the march keeps its compositing's scratch past a warp's
// feature rows).
template <int H, int CF>
Layout make_layout(int fin, int rows, size_t extra_bytes, int min_width = 0) {
  constexpr int NH = CF + 8;  // feature head ++ alpha head, padded to 8
  constexpr int LDF = CF + 4;
  // room for the feature rows, in whole 16-column steps: an odd count of
  // 16-byte chunks a padded row, so ldmatrix's 8 rows hit distinct banks
  int width = fin > min_width ? fin : min_width;
  if (width < (2 * LDF + 15) / 16 * 16) width = (2 * LDF + 15) / 16 * 16;
  Layout L;
  L.fin = fin;
  L.ldw0 = fin + kPad;
  L.ldw1 = H + kPad;
  L.ldwh = H + kPad;
  L.ldwr = CF + kPad;
  L.ldx = width + kPad;
  L.ldf = LDF;
  size_t o = 0;
  L.w0 = o; o = align16(o + size_t(H) * L.ldw0 * 2);
  L.w1 = o; o = align16(o + size_t(H) * L.ldw1 * 2);
  L.wh = o; o = align16(o + size_t(NH) * L.ldwh * 2);
  L.wr = o; o = align16(o + size_t(8) * L.ldwr * 2);
  L.b0 = o; o = align16(o + size_t(H) * 4);
  L.b1 = o; o = align16(o + size_t(H) * 4);
  L.bh = o; o = align16(o + size_t(NH) * 4);
  L.br = o; o = align16(o + 8 * 4);
  L.x = o; o = align16(o + size_t(rows) * L.ldx * 2);
  L.sig = o; o = align16(o + size_t(rows) * 4);
  L.rgb = o; o = align16(o + size_t(rows) * 3 * 4);
  L.extra = o; o = align16(o + extra_bytes);
  L.total = o;
  return L;
}

struct Weights {
  const bf16 *w0, *w1, *wh, *wr;     // [H, fin], [H, H], [CF+1, H], [3, CF]
  const float *b0, *b1, *bh, *br;    // [H], [H], [CF+1], [3]
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage the five weight matrices (rows padded to their ld) and the biases,
// a row's 16-byte chunks at a time (every width is a multiple of 8 and the
// weights are 16-byte aligned); the rows past a head's own (the zero
// padding of wh and wr) are zero.
template <int H, int CF>
__device__ void stage_weights(unsigned char* smem, const Layout& L,
                              const Weights& w) {
  constexpr int NH = CF + 8;
  const int tid = threadIdx.x, nt = blockDim.x;
  auto rows = [&](size_t off, int ld, const bf16* src, int nrows, int valid,
                  int K) {
    bf16* dst = reinterpret_cast<bf16*>(smem + off);
    const int per = K / 8;
#pragma unroll 4
    for (int i = tid; i < nrows * per; i += nt) {
      const int r = i / per, c = i - r * per;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) v = __ldg(reinterpret_cast<const uint4*>(src + r * K) + c);
      *reinterpret_cast<uint4*>(dst + r * ld + 8 * c) = v;
    }
  };
  rows(L.w0, L.ldw0, w.w0, H, H, L.fin);
  rows(L.w1, L.ldw1, w.w1, H, H, H);
  rows(L.wh, L.ldwh, w.wh, NH, CF + 1, H);
  rows(L.wr, L.ldwr, w.wr, 8, 3, CF);
  float* sB0 = reinterpret_cast<float*>(smem + L.b0);
  float* sB1 = reinterpret_cast<float*>(smem + L.b1);
  float* sBh = reinterpret_cast<float*>(smem + L.bh);
  float* sBr = reinterpret_cast<float*>(smem + L.br);
  for (int i = tid; i < H; i += nt) {
    sB0[i] = w.b0[i];
    sB1[i] = w.b1[i];
  }
  for (int i = tid; i < NH; i += nt) sBh[i] = i < CF + 1 ? w.bh[i] : 0.f;
  for (int i = tid; i < 8; i += nt) sBr[i] = i < 3 ? w.br[i] : 0.f;
}


// One warp: copy its 16 samples' already-reduced MLP input rows [fin] bf16
// into the input tile, 16 bytes a lane (fin % 8 == 0, so rows and the padded
// tile rows are both 16-byte aligned). Rows at or past `valid` are zero.
__device__ void copy_inputs(unsigned char* smem, const Layout& L,
                            const bf16* __restrict__ x, long pt0, int valid,
                            int warp, int lane) {
  bf16* sX = reinterpret_cast<bf16*>(smem + L.x);
  const int nch = L.fin / 8;  // 16-byte chunks a row
  const uint4* src =
      reinterpret_cast<const uint4*>(x + (pt0 + warp * 16) * long(L.fin));
  for (int i = lane; i < 16 * nch; i += 32) {
    const int row = i / nch, ch = i % nch;
    const int p = warp * 16 + row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p < valid) v = src[i];
    *reinterpret_cast<uint4*>(sX + p * L.ldx + ch * 8) = v;
  }
}

// The two bf16 feature planes a gather reads: [B][H][W][kPlaneC] each,
// sample row p of batch item p / rows_per_item.
constexpr int kPlaneC = 64;
constexpr int kGatherBatch = 4;  // samples whose corner loads are in flight

struct PlanePair {
  const bf16* xy;
  const bf16* zy;
  long item_stride;    // H * W * kPlaneC
  long rows_per_item;  // sample rows of one batch item
  int W, cells_max;    // (H - 1) * (W - 1) - 1: the last cell
};

// One warp: its 16 samples' MLP input rows [xy (64) | zy (64) | posenc
// (n_pe)] in bf16, from global row pt0 (valid of them; the rest are zero).
// First every load of the samples from device memory: the cells (rows
// [N][2]: y0 * (W - 1) + x0 of each plane's cell, lane l: sample l / 2,
// plane l % 2) and the aux rows [N][n_pe + 8] (posenc ++ the 8 corner
// weights; n_pe % 4 == 0, n_pe + 8 <= 64) as one span of 16-byte loads,
// posenc rounded into the input rows, the weights staged at L.extra
// ([warp][16][8] f32). Then the corner texels of kGatherBatch samples at a
// time (lanes 0-15 on the XY plane, 16-31 on ZY, four channels a lane, 8
// bytes a corner), corner-reduced in f32 with each product and sum rounded
// on its own in corner order (the plain twin's arithmetic). A sample past
// `valid` reads texel 0 of item 0 with weight 0.
__device__ void gather_inputs(unsigned char* smem, const Layout& L,
                              const PlanePair& pl,
                              const int* __restrict__ rows,
                              const float* __restrict__ aux, long pt0,
                              int valid, int n_pe, int warp, int lane) {
  bf16* sX = reinterpret_cast<bf16*>(smem + L.x) + warp * 16 * L.ldx;
  float* sW8 = reinterpret_cast<float*>(smem + L.extra) + warp * 16 * 8;
  const int n4 = (n_pe + 8) / 4;  // 16-byte chunks of an aux row

  int cell = 0;
  if ((lane >> 1) < valid) cell = __ldg(rows + pt0 * 2 + lane);
  const float4* a4 = reinterpret_cast<const float4*>(aux + pt0 * (n_pe + 8));
  float4 av[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = lane + 32 * j;
    av[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < 16 * n4 && e / n4 < valid) av[j] = __ldg(a4 + e);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = lane + 32 * j;
    if (e >= 16 * n4) break;
    const int r = e / n4, c = (e - r * n4) * 4;
    if (c < n_pe) {
      const bf162 lo = __floats2bfloat162_rn(av[j].x, av[j].y);
      const bf162 hi = __floats2bfloat162_rn(av[j].z, av[j].w);
      uint2 o;
      o.x = *reinterpret_cast<const uint32_t*>(&lo);
      o.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(sX + r * L.ldx + 2 * kPlaneC + c) = o;
    } else {
      *reinterpret_cast<float4*>(sW8 + r * 8 + c - n_pe) = av[j];
    }
  }
  __syncwarp();

  const int p = lane >> 4, c = 4 * (lane & 15);
  const bf16* plane = p ? pl.zy : pl.xy;
#pragma unroll 1
  for (int r0 = 0; r0 < 16; r0 += kGatherBatch) {
    uint2 u[kGatherBatch][4];
#pragma unroll
    for (int i = 0; i < kGatherBatch; ++i) {
      const int r = r0 + i;
      int q = __shfl_sync(0xffffffffu, cell, 2 * r + p);
      q = min(max(q, 0), pl.cells_max);
      const long item = r < valid ? (pt0 + r) / pl.rows_per_item : 0;
      const bf16* t = plane + item * pl.item_stride +
                      long(q + q / (pl.W - 1)) * kPlaneC + c;  // y0 W + x0
#pragma unroll
      for (int k = 0; k < 4; ++k)
        u[i][k] = __ldg(reinterpret_cast<const uint2*>(
            t + long((k >> 1) * pl.W + (k & 1)) * kPlaneC));
    }
#pragma unroll
    for (int i = 0; i < kGatherBatch; ++i) {
      const int r = r0 + i;
      const float* w = sW8 + r * 8 + 4 * p;
      float s[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(&u[i][k].x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(&u[i][k].y));
        const float v[4] = {lo.x, lo.y, hi.x, hi.y};
        const float wk = w[k];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float m = __fmul_rn(v[e], wk);
          s[e] = k ? __fadd_rn(s[e], m) : m;
        }
      }
      const bf162 lo = __floats2bfloat162_rn(s[0], s[1]);
      const bf162 hi = __floats2bfloat162_rn(s[2], s[3]);
      uint2 o;
      o.x = *reinterpret_cast<const uint32_t*>(&lo);
      o.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(sX + r * L.ldx + p * kPlaneC + c) = o;
    }
  }
}

// A warp's 16 input rows; after its chain, its f32 feature rows.
__device__ __forceinline__ unsigned char* warp_rows(unsigned char* smem,
                                                    const Layout& L,
                                                    int warp) {
  return smem + L.x + size_t(warp) * 16 * L.ldx * 2;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[2j], acc[2j + 1] += A (16 x 16 at k) * W[16j .. 16j + 15][k ..]^T for
// j < NP; W is [N][ldw] bf16 in shared memory (torch Linear layout)
template <int NP, int N>
__device__ __forceinline__ void mma_pairs(float (&acc)[N][4],
                                          const uint32_t (&a)[4],
                                          const bf16* W, int ldw, int k,
                                          int lane) {
  static_assert(2 * NP <= N, "n-tiles past the accumulator");
  const int brow = (lane & 7) + 8 * (lane >> 4), bcol = 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    uint32_t b[4];
    ldsm_x4(b, W + (16 * j + brow) * ldw + k + bcol);
    mma_bf16(acc[2 * j], a[0], a[1], a[2], a[3], b[0], b[1]);
    mma_bf16(acc[2 * j + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
  }
}

// relu(acc + bias) of NT n-tiles as the next layer's NT / 2 A fragments
// (bf16): the m16n8 accumulator layout is the m16n8k16 A layout, two
// n-tiles a k step
template <int NT>
__device__ __forceinline__ void relu_frags(uint32_t (&h)[NT / 2][4],
                                           const float (&acc)[NT][4],
                                           const float* bias, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half, col = 8 * j + 2 * t;
      const float c0 = bias[col], c1 = bias[col + 1];
      h[kk][2 * half] = pack_bf16(fmaxf(acc[j][0] + c0, 0.f),
                                  fmaxf(acc[j][1] + c1, 0.f));
      h[kk][2 * half + 1] = pack_bf16(fmaxf(acc[j][2] + c0, 0.f),
                                      fmaxf(acc[j][3] + c1, 0.f));
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// One warp: the field MLP on its 16 input rows (bf16 inputs and hidden
// activations, f32 accumulation in k order). Leaves feat (f32) in its
// feature rows (over the input rows), sigma in sSig and raw rgb in sRgb at
// tile rows.
template <int H, int CF>
__device__ void mlp_warp(unsigned char* smem, const Layout& L, int warp,
                         int lane) {
  static_assert(H % 16 == 0 && CF % 16 == 0, "widths in 16-column steps");
  constexpr int NH = CF + 8;  // [feat (CF) | sigma | 7 zero rows]
  const bf16* sW0 = reinterpret_cast<const bf16*>(smem + L.w0);
  const bf16* sW1 = reinterpret_cast<const bf16*>(smem + L.w1);
  const bf16* sWh = reinterpret_cast<const bf16*>(smem + L.wh);
  const bf16* sWr = reinterpret_cast<const bf16*>(smem + L.wr);
  const float* sB0 = reinterpret_cast<const float*>(smem + L.b0);
  const float* sB1 = reinterpret_cast<const float*>(smem + L.b1);
  const float* sBh = reinterpret_cast<const float*>(smem + L.bh);
  const float* sBr = reinterpret_cast<const float*>(smem + L.br);
  const bf16* X = reinterpret_cast<const bf16*>(warp_rows(smem, L, warp));
  float* F = reinterpret_cast<float*>(warp_rows(smem, L, warp));
  float* sSig = reinterpret_cast<float*>(smem + L.sig) + warp * 16;
  float* sRgb = reinterpret_cast<float*>(smem + L.rgb) + warp * 16 * 3;
  const int g = lane >> 2, t = lane & 3;
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
  // the x2 loads of the heads' last n-tile and of fc_rgb
  const int brow = lane & 7, bcol = 8 * ((lane >> 3) & 1);

  uint32_t h[H / 16][4];
  {
    float acc[H / 8][4];
    zero(acc);
#pragma unroll 1
    for (int k = 0; k < L.fin; k += 16) {
      uint32_t a[4];
      ldsm_x4(a, X + arow * L.ldx + k + acol);
      mma_pairs<H / 16>(acc, a, sW0, L.ldw0, k, lane);
    }
    relu_frags<H / 8>(h, acc, sB0, lane);
  }
  {
    float acc[H / 8][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk)
      mma_pairs<H / 16>(acc, h[kk], sW1, L.ldw1, 16 * kk, lane);
    relu_frags<H / 8>(h, acc, sB1, lane);
  }
  // the heads, then fc_rgb on bf16(feat)
  uint32_t fa[CF / 16][4];
  {
    float acc[NH / 8][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      mma_pairs<CF / 16>(acc, h[kk], sWh, L.ldwh, 16 * kk, lane);
      uint32_t b[2];
      ldsm_x2(b, sWh + (CF + brow) * L.ldwh + 16 * kk + bcol);
      mma_bf16(acc[NH / 8 - 1], h[kk][0], h[kk][1], h[kk][2], h[kk][3], b[0],
               b[1]);
    }
    __syncwarp();  // every lane is done reading the input rows
#pragma unroll
    for (int j = 0; j < CF / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float c0 = sBh[col], c1 = sBh[col + 1];
      const float v0 = acc[j][0] + c0, v1 = acc[j][1] + c1;
      const float v2 = acc[j][2] + c0, v3 = acc[j][3] + c1;
      *reinterpret_cast<float2*>(F + g * L.ldf + col) = make_float2(v0, v1);
      *reinterpret_cast<float2*>(F + (g + 8) * L.ldf + col) =
          make_float2(v2, v3);
      fa[j / 2][2 * (j & 1)] = pack_bf16(v0, v1);
      fa[j / 2][2 * (j & 1) + 1] = pack_bf16(v2, v3);
    }
    if (t == 0) {
      sSig[g] = acc[NH / 8 - 1][0] + sBh[CF];
      sSig[g + 8] = acc[NH / 8 - 1][2] + sBh[CF];
    }
  }
  {
    float acc[1][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < CF / 16; ++kk) {
      uint32_t b[2];
      ldsm_x2(b, sWr + brow * L.ldwr + 16 * kk + bcol);
      mma_bf16(acc[0], fa[kk][0], fa[kk][1], fa[kk][2], fa[kk][3], b[0],
               b[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + (e >> 1) * 8, col = 2 * t + (e & 1);
      if (col < 3) sRgb[row * 3 + col] = acc[0][e] + sBr[col];
    }
  }
}

// Opt the kernel in to ``bytes`` of dynamic shared memory and size a
// persistent grid: as many blocks as fit on the card at once, at most one a
// tile.
template <typename K>
cudaError_t launch_config(K kern, int threads, size_t bytes, long long ntiles,
                          int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, bytes)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = int(ntiles < (long long)sms * per_sm ? ntiles : sms * per_sm);
  return cudaSuccess;
}

}  // namespace
