// The dense chain's backward body, shared by the two backward kernels that
// run it: csrc/mlp.cu's (x rows in, dx rows out) and csrc/quad.cu's (corner
// texels gathered from the planes in, dx splatted into the plane gradients
// out). Device code for Hopper (sm_90a); also the tensor-core product
// engines (namespace tc) that the body and mlp.cu's float32 forward use.
//
// The body, for one tile whose input rows X (the MLP input, rounded to cdt)
// and cotangent rows G the caller's prologue has filled: the forward again
// (h0, h1, feat), the head gradients, the transposed chain (dfa . Wf, da1 .
// W1, da0 . W0) with the cotangents rounded to cdt before each product, and
// every weight gradient's share of the tile. It leaves the tile's float32
// dx in Dx for the caller's epilogue. A persistent block of 8 warps walks
// over the tiles; the activations stay in shared memory.
//
// Products, by cdt:
//  * bf16: mma.sync m16n8k16 bf16 on the tensor cores for every product, on
//    128-row tiles held as bf16 (Tile<bf16>): fragments load as 32-bit
//    words with no conversion, and each update of the block's partial takes
//    128 rows. A warp owns 16 output columns of the tile; a weight comes
//    from L2 in fragment order (ops/mlp.py:_frags), the next k step's
//    fragments loading while this one multiplies.
//  * float32 (64-row float tiles): the recompute of h0, h1 and feat on FFMA
//    (csrc/ffma.cuh), each output one thread's k sum in order, so that it
//    rounds as the plain twin's dense layers do: a hidden unit's ReLU mask
//    must not flip, since a weight gradient has no allowance for a kink
//    (PERF.md, section 6). Nothing depends on a mask after that, so the
//    transposed chain and the weight-gradient contractions run on split
//    TF32 (mma.sync m16n8k8 tf32): a float32 v = hi + lo with hi = tf32(v)
//    (cvt.rna) and lo = v - hi (exact; the tensor cores read its top 19
//    bits), and a . b = hi.hi + (lo.hi + hi.lo), the small products in
//    their own accumulator, added at the end. A weight comes split once a
//    call (ops/mlp.py:_tf32_frags, one float4 {hi, hi, lo, lo} a lane and
//    8 x 8 block); activations and cotangents split as their fragments
//    load. The small products dwr and dwa (0.4% of the multiply-adds) stay
//    on FFMA.
//
// Weight gradients without atomics: each persistent block adds its tiles'
// contractions into its own float32 partial P of all 47,748 gradient values
// (weights [in][out] and biases, in ops/mlp.py's _GRAD_SIZES order) with
// plain loads and stores; bias sums are carried in shared memory over the
// block's tiles (summing the cotangents before rounding) and stored once;
// sum_partials_kernel then adds the partials in block order. Blocks take
// tiles blockIdx.x, + gridDim.x, ..., and every in-block sum runs in a fixed
// order, so two launches give the same gradients bit for bit. The rows
// streamed in and out (x, g, dx) carry an evict-first hint, so that the
// partials stay in L2 (measured: PERF.md, section 6).

#pragma once

#include "ffma.cuh"
#include "field_mlp.cuh"

namespace {

constexpr int FIN = 176, HID = 128, CF = 64, NOUT = 68;  // production widths
using ffma_engine::KC;   // weight rows a staged chunk (FFMA engine)
using ffma_engine::LDW;  // a weight stage's row
using ffma_engine::NT;   // threads a block: 8 warps
using ffma_engine::TM;   // rows a tile: 64
using ffma_engine::kStageFloats;  // the FFMA engine's two weight stages
constexpr int LDX = FIN + 4, LDH = HID + 4, LDD = CF + 4;  // f32 row strides

// the flat gradient vector (ops/mlp.py's _GRAD_SIZES order; weights [in][out])
constexpr int DW0 = 0, DW1 = DW0 + FIN * HID, DWF = DW1 + HID * HID,
              DWA = DWF + HID * CF, DWR = DWA + HID, DB0 = DWR + CF * 3,
              DB1 = DB0 + HID, DBF = DB1 + HID, DBA = DBF + CF, DBR = DBA + 1,
              NGRAD = DBR + 3;
static_assert(NGRAD % 4 == 0, "a block's partial stays 16-byte aligned");

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The backward's activation tiles by cdt: float32 keeps 64-row float tiles;
// bf16 keeps 128-row bf16 tiles (half the bytes a row, so twice the rows
// contract into each update of the block's partial). Row strides in
// elements; as 32-bit words each is 4 mod 32, so a fragment's 8 rows fall
// on distinct banks.
template <typename T> struct Tile {
  using E = float;
  static constexpr int M = TM, LDX = FIN + 4, LDH = HID + 4, LDD = CF + 4;
};
template <> struct Tile<bf16> {
  using E = bf16;
  static constexpr int M = 2 * TM, LDX = FIN + 24, LDH = HID + 8,
                       LDD = CF + 8;
};
constexpr int LDG = NOUT;     // the cotangent tile g [M][68], f32
constexpr int LDXF = FIN + 4; // the f32 dx tile [M][180]

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
// two adjacent elements (p 4-byte aligned)
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(a, b);
}
// four adjacent elements (p 16-byte aligned for float, 8-byte for bf16)
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  const bf162 lo = __floats2bfloat162_rn(v.x, v.y),
              hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&lo),
      *reinterpret_cast<const uint32_t*>(&hi));
}

// The backward's weights. float32: W^T [in][out] (w*_kn) for the FFMA
// recompute, W [out][in] split into TF32 fragments for the transposed chain
// (ops/mlp.py:_tf32_frags; w0 padded to 192 columns). bf16: all six in bf16
// fragment order (ops/mlp.py:_frags; w0 padded to 192 columns).
template <typename T> struct WeightsOf {
  using K = float;
  using B = float4;
};
template <> struct WeightsOf<bf16> {
  using K = uint32_t;
  using B = uint32_t;
};

template <typename T>
struct Params {
  const typename WeightsOf<T>::K *w0_kn, *w1_kn, *wf_kn;
  const typename WeightsOf<T>::B *w0, *w1, *wf;
  const float *wa, *wr;                 // fc_alpha [128], fc_rgb [3][64]
  const float *b0, *b1, *bf, *ba, *br;  // [128], [128], [64], [1], [3]
};

// ---------------------------------------------------------------------------
// tensor-core engines: mma.sync m16n8k16 bf16, or m16n8k8 split TF32
// ---------------------------------------------------------------------------

namespace tc {

__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16, packed (the first in the low half)
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  const bf162 h = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// v = hi + lo: hi = tf32(v), round to nearest with ties away from zero;
// lo = v - hi, exact
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// One warp's operands from the tiles, lane = 4 g + t as in the PTX
// fragment layouts. bf16 tiles, m16n8k16: A (g, 2t..2t+1), (g+8, 2t..),
// (g, 2t+8..2t+9), (g+8, 2t+8..); B (2t..2t+1, g), (2t+8..2t+9, g). float
// tiles, split TF32 m16n8k8: A (g, t), (g+8, t), (g, t+4), (g+8, t+4); B
// (t, g), (t+4, g). A weight's B comes in fragment order instead.
struct AFrag { uint32_t r[4]; };
// A row-major: element (m, k) at p[m * lda + k]
__device__ __forceinline__ AFrag load_a(const bf16* p, int lda) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* q0 = reinterpret_cast<const uint32_t*>(p + g * lda + 2 * t);
  const uint32_t* q8 =
      reinterpret_cast<const uint32_t*>(p + (g + 8) * lda + 2 * t);
  return AFrag{{q0[0], q8[0], q0[4], q8[4]}};
}
// A transposed: element (m, k) at p[k * lda + m]
__device__ __forceinline__ AFrag load_a_t(const bf16* p, int lda) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* q = p + 2 * t * lda + g;
  const bf16* r = q + 8 * lda;
  return AFrag{{pack2(q[0], q[lda]), pack2(q[8], q[lda + 8]),
                pack2(r[0], r[lda]), pack2(r[8], r[lda + 8])}};
}
// B row-major: element (k, n) at p[k * ldb + n]; (b0, b1)
__device__ __forceinline__ uint2 load_b(const bf16* p, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* q = p + 2 * t * ldb + g;
  return make_uint2(pack2(q[0], q[ldb]), pack2(q[8 * ldb], q[9 * ldb]));
}

struct SplitA { uint32_t hi[4], lo[4]; };
__device__ __forceinline__ SplitA load_a_split(const float* p, int sm,
                                               int sk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  SplitA a;
  split(p[g * sm + t * sk], a.hi[0], a.lo[0]);
  split(p[(g + 8) * sm + t * sk], a.hi[1], a.lo[1]);
  split(p[g * sm + (t + 4) * sk], a.hi[2], a.lo[2]);
  split(p[(g + 8) * sm + (t + 4) * sk], a.hi[3], a.lo[3]);
  return a;
}
// B (hi, hi, lo, lo) as a weight's fragment holds it
__device__ __forceinline__ float4 load_b_split(const float* p, int sk,
                                               int sn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t h0, l0, h1, l1;
  split(p[t * sk + g * sn], h0, l0);
  split(p[(t + 4) * sk + g * sn], h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(l0), __uint_as_float(l1));
}

// c += a.hi b.hi; d += a.lo b.hi + a.hi b.lo
__device__ __forceinline__ void mma3(float (&c)[4], float (&d)[4],
                                     const SplitA& a, const float4& b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  mma(d, a.lo, bh0, bh1);
  mma(d, a.hi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma(c, a.hi, bh0, bh1);
}

// Fragment element e of acc[m][j]: row 16 m + g + 8 (e >> 1), column
// 8 (nb0 + j) + 2 t + (e & 1), for both types.

// acc[m][j] = A[16 m .. 16 m + 16][:8 KB] . B[:8 KB][8 (nb0 + j) ..] for
// the tile's MB 16-row blocks and the warp's NJ column blocks; A a tile
// (row stride lda): bf16 (k steps of 16, KB even), or float split into
// TF32 as it loads (k steps of 8); B a weight in fragment order, k blocks
// of 8, NB column blocks wide: bf16 (one uint32 a lane and block) or split
// TF32 (one float4). The next k step's B fragments load while this one's
// multiply.
template <int MB, int NJ, typename E, typename F>
__device__ __forceinline__ void gemm_nn(float (&acc)[MB][NJ][4], const E* A,
                                        int lda, int KB,
                                        const F* __restrict__ frags, int NB,
                                        int nb0) {
  constexpr bool kSplit = sizeof(F) == 16;
  static_assert(kSplit == (sizeof(E) == 4), "split TF32 on float tiles");
  constexpr int KS = kSplit ? 1 : 2;  // 8-row k blocks a step
  const int lane = threadIdx.x & 31;
  float d[MB][NJ][4];  // split TF32: the small products
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = d[m][j][e] = 0.f;
  F b[NJ][KS];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < KS; ++h)
      b[j][h] = __ldg(frags + (size_t(h) * NB + nb0 + j) * 32 + lane);
  for (int kb = 0; kb < KB; kb += KS) {
    F nb[NJ][KS];
    const int kn = kb + KS < KB ? kb + KS : kb;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < KS; ++h)
        nb[j][h] = __ldg(frags + (size_t(kn + h) * NB + nb0 + j) * 32 + lane);
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      if constexpr (kSplit) {
        const SplitA a = load_a_split(A + 16 * m * lda + 8 * kb, lda, 1);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma3(acc[m][j], d[m][j], a, b[j][0]);
      } else {
        const AFrag a = load_a(A + 16 * m * lda + 8 * kb, lda);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma16(acc[m][j], a.r, b[j][0], b[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < KS; ++h) b[j][h] = nb[j][h];
  }
  if constexpr (kSplit) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += d[m][j][e];
  }
}

// P[i][o] += sum over the tile's rows r of A[r][i] * B[r][o], for all MI*16
// inputs i and the warp's NJ output column blocks (o from 8 nb0): a weight
// gradient's share of one tile (Tile<T>::M rows), contracted on the tensor
// cores (bf16 tiles, or float tiles on split TF32) and added into the
// block's own partial P (row stride ldp) with plain float2 loads and stores
// (each element is owned by one thread). Split TF32 holds two accumulators,
// so it takes the inputs in passes of MC 16-row blocks.
template <typename T, int MI, int NJ, typename E>
__device__ __forceinline__ void gemm_tn(const E* A, int lda, const E* B,
                                        int ldb, float* P, int ldp, int nb0) {
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int MC = kSplit ? 4 : MI;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i0 = 0; i0 < MI; i0 += MC) {
    float c[MC][NJ][4], d[MC][NJ][4];
#pragma unroll
    for (int i = 0; i < MC; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = d[i][j][e] = 0.f;
    constexpr int KS = kSplit ? 1 : 2;  // 8-row k blocks a step
#pragma unroll 1
    for (int kb = 0; kb < Tile<T>::M / 8; kb += KS) {
      const E* Bk = B + 8 * kb * ldb;
      const E* Ak = A + 8 * kb * lda;
      if constexpr (kSplit) {
        float4 b[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          b[j] = load_b_split(Bk + 8 * (nb0 + j), ldb, 1);
#pragma unroll
        for (int i = 0; i < MC; ++i) {
          if (i0 + i < MI) {
            const SplitA a = load_a_split(Ak + 16 * (i0 + i), 1, lda);
#pragma unroll
            for (int j = 0; j < NJ; ++j) mma3(c[i][j], d[i][j], a, b[j]);
          }
        }
      } else {
        uint2 b[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) b[j] = load_b(Bk + 8 * (nb0 + j), ldb);
#pragma unroll
        for (int i = 0; i < MC; ++i) {
          const AFrag a = load_a_t(Ak + 16 * (i0 + i), lda);
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma16(c[i][j], a.r, b[j].x, b[j].y);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MC; ++i) {
      if (i0 + i < MI) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            float2* o = reinterpret_cast<float2*>(
                P + (16 * (i0 + i) + g + 8 * v) * ldp + 8 * (nb0 + j) + 2 * t);
            float2 s = *o;
            s.x += kSplit ? c[i][j][2 * v] + d[i][j][2 * v] : c[i][j][2 * v];
            s.y += kSplit ? c[i][j][2 * v + 1] + d[i][j][2 * v + 1]
                          : c[i][j][2 * v + 1];
            *o = s;
          }
      }
    }
  }
}

// Out[row][col] = rnd<T>(relu(acc + bias)) for the warp's fragments.
template <typename T, int MB, int NJ, typename E>
__device__ __forceinline__ void store_relu(const float (&acc)[MB][NJ][4],
                                           const float* __restrict__ bias,
                                           E* Out, int ldo, int nb0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = 8 * (nb0 + j) + 2 * t;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        st2(Out + (16 * m + g + 8 * v) * ldo + col,
            rnd<T>(fmaxf(acc[m][j][2 * v] + b0, 0.f)),
            rnd<T>(fmaxf(acc[m][j][2 * v + 1] + b1, 0.f)));
  }
}

// The cotangent of a hidden layer, for the warp's fragments: da = acc (+
// the density head's share dsig[row] * rnd<T>(wa[col])) where the
// activation Hd was positive, else 0; rnd<T>(da) replaces Hd in place (each
// element is read and written by one thread). The column sums of da before
// rounding (over the thread's rows, then a fixed shuffle tree over g) go
// to sB: the warp owns its columns.
template <typename T, int MB, int NJ, typename E>
__device__ __forceinline__ void mask_store(const float (&acc)[MB][NJ][4],
                                           const E* dsig, int ldsig,
                                           const float* __restrict__ wa,
                                           E* Hd, int ldh, float* sB,
                                           int nb0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 8 * (nb0 + j) + 2 * t + h;
      const float w = dsig ? rnd<T>(__ldg(wa + col)) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int r = 16 * m + g + 8 * v;
          float x = acc[m][j][2 * v + h];
          if (dsig) x = fmaf(ldf(dsig + r * ldsig), w, x);
          x = ldf(Hd + r * ldh + col) > 0.f ? x : 0.f;
          sum += x;
          stf(Hd + r * ldh + col, rnd<T>(x));
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      if (g == 0) sB[col] += sum;
    }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// the backward's shared-memory tiles and its steps outside the products
// ---------------------------------------------------------------------------

constexpr int kScratch = (NT / 64) * CF;  // head_grads' column sums
constexpr int kBiasFloats = HID + HID + CF + 4;

// The backward's shared-memory tiles, in this order: x | h0, then da0 | h1,
// then da1 | rnd(feat), then rnd(dfa) [M][65] (Tile<T>'s type and strides)
// | g [M][68] f32 | the bias sums | the quad rows' corner weights [M][8]
// and texel bases [M][2] (ints) | column-sum scratch | (float32 only) the
// FFMA engine's two weight stages. The f32 dx tile Dx [M][LDXF] aliases
// the first tiles (for float32, X itself).
template <typename T>
struct BwdSmem {
  using E = typename Tile<T>::E;
  static constexpr int M = Tile<T>::M;
  static constexpr size_t kX = size_t(M) * Tile<T>::LDX * sizeof(E),
                          kH = size_t(M) * Tile<T>::LDH * sizeof(E),
                          kD = size_t(M) * Tile<T>::LDD * sizeof(E),
                          kTiles = kX + 2 * kH + kD;
  static constexpr size_t bytes =
      kTiles + (size_t(M) * LDG + kBiasFloats + M * 10 + kScratch +
                (sizeof(T) == 4 ? kStageFloats : 0)) * 4;
  static_assert(size_t(M) * LDXF * 4 <= kTiles, "dx fits over the tiles");
  static_assert(kX % 16 == 0 && kH % 16 == 0 && kD % 16 == 0, "alignment");

  E *X, *H0, *H1, *D;
  float *G, *sB0, *sB1, *sBh, *sBr, *W8, *S, *Ws, *Dx;
  int* Base;
  __device__ explicit BwdSmem(unsigned char* sm) {
    X = reinterpret_cast<E*>(sm);
    H0 = reinterpret_cast<E*>(sm + kX);
    H1 = reinterpret_cast<E*>(sm + kX + kH);
    D = reinterpret_cast<E*>(sm + kX + 2 * kH);
    G = reinterpret_cast<float*>(sm + kTiles);
    sB0 = G + M * LDG;
    sB1 = sB0 + HID;
    sBh = sB1 + HID;  // [65]
    sBr = sBh + CF + 1;  // [3]
    W8 = sBr + 3;
    Base = reinterpret_cast<int*>(W8 + M * 8);
    S = W8 + M * 10;
    Ws = S + kScratch;
    Dx = reinterpret_cast<float*>(sm);
  }
};

// The backward's dynamic shared memory.
template <typename T>
constexpr size_t bwd_bytes() {
  return BwdSmem<T>::bytes;
}

// The tile's cotangent rows g [M][68] into G; rows past `valid` are zero.
// Streamed (read once: evict first), so that the block partials stay in
// L2.
template <typename T>
__device__ __forceinline__ void load_g(float* G, const float* __restrict__ g,
                                       int valid) {
  for (int i = threadIdx.x; i < Tile<T>::M * (NOUT / 4); i += NT) {
    const int r = i / (NOUT / 4), c = (i % (NOUT / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      v = __ldcs(reinterpret_cast<const float4*>(g + r * NOUT + c));
    *reinterpret_cast<float4*>(G + r * LDG + c) = v;
  }
}

// With rnd(feat) in D and g in G: fc_rgb's weight gradient dwr[k][c] +=
// sum_r feat[r][k] * rnd(g_rgb[r][c]) into the partial (four threads a k,
// each on every fourth row, then a fixed shuffle tree), and the rgb and
// alpha bias sums (a warp a column); then, after a barrier, D = rnd(dfa),
// dfa = [g_feat + g_rgb . wr^T | g_sigma], and the feature bias sums
// (summed before rounding). Ends with a barrier.
template <typename T, typename E>
__device__ __forceinline__ void head_grads(E* D, const float* G,
                                           const float* __restrict__ wr,
                                           float* P, float* sBh, float* sBr,
                                           float* S) {
  constexpr int M = Tile<T>::M, LDD_ = Tile<T>::LDD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  static_assert(NT == 4 * CF, "four threads a feature column");
  {
    const int k = tid >> 2, q = tid & 3;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int r = q; r < M; r += 4) {
      const float f = ldf(D + r * LDD_ + k);
      const float* grow = G + r * LDG;
      s0 = fmaf(f, rnd<T>(grow[0]), s0);
      s1 = fmaf(f, rnd<T>(grow[1]), s1);
      s2 = fmaf(f, rnd<T>(grow[2]), s2);
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (q == 0) {
      P[DWR + 3 * k] += s0;
      P[DWR + 3 * k + 1] += s1;
      P[DWR + 3 * k + 2] += s2;
    }
  }
  if (warp < 4) {  // d(b_rgb) (warps 0-2) and d(b_alpha) (warp 3)
    const int c = warp < 3 ? warp : 3 + CF;
    float s = 0.f;
    for (int r = lane; r < M; r += 32) s += G[r * LDG + c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) *(warp < 3 ? sBr + warp : sBh + CF) += s;
  }
  __syncthreads();
  {
    const int c = tid & 63;  // one column a thread: NT % 64 == 0
    const float w0 = rnd<T>(__ldg(wr + c)), w1 = rnd<T>(__ldg(wr + CF + c)),
                w2 = rnd<T>(__ldg(wr + 2 * CF + c));
    float sum = 0.f;
    for (int r = tid >> 6; r < M; r += NT / 64) {
      const float* grow = G + r * LDG;
      const float v = grow[3 + c] + grow[0] * w0 + grow[1] * w1 + grow[2] * w2;
      sum += v;
      stf(D + r * LDD_ + c, rnd<T>(v));
    }
    S[(tid >> 6) * CF + c] = sum;
    for (int r = tid; r < M; r += NT)
      stf(D + r * LDD_ + CF, rnd<T>(G[r * LDG + 3 + CF]));
  }
  __syncthreads();
  if (tid < CF)
    sBh[tid] += ((S[tid] + S[CF + tid]) + S[2 * CF + tid]) + S[3 * CF + tid];
}

// dwa[k] += sum_r h1[r][k] * rnd(dsigma[r]) (D's column CF) into the
// partial: two threads a k, each on every other row, then one shuffle.
template <typename T, typename E>
__device__ __forceinline__ void alpha_grad(const E* H1, const E* D, float* P) {
  static_assert(NT == 2 * HID, "two threads a hidden unit");
  const int k = threadIdx.x >> 1, h = threadIdx.x & 1;
  float s = 0.f;
  for (int r = h; r < Tile<T>::M; r += 2)
    s = fmaf(ldf(H1 + r * Tile<T>::LDH + k), ldf(D + r * Tile<T>::LDD + CF),
             s);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (h == 0) P[DWA + k] += s;
}

// The block's bias sums into its partial, once, after its last tile.
__device__ __forceinline__ void store_bias_partials(float* P, const float* sB0,
                                                    const float* sB1,
                                                    const float* sBh,
                                                    const float* sBr) {
  const int tid = threadIdx.x;
  for (int i = tid; i < HID; i += NT) {
    P[DB0 + i] = sB0[i];
    P[DB1 + i] = sB1[i];
  }
  for (int i = tid; i < CF + 1; i += NT) P[DBF + i] = sBh[i];  // dbf, dba
  if (tid < 3) P[DBR + tid] = sBr[tid];
}

// ---------------------------------------------------------------------------
// the body
// ---------------------------------------------------------------------------

// One tile, X and G filled and published (a barrier after the prologue):
// the recompute, the head gradients, the transposed chain and the weight
// gradients into P, then dx [M][FIN] f32 into Dx. Ends with a barrier.
template <typename T>
__device__ void bwd_tile(const BwdSmem<T>& s, const Params<T>& p, float* P) {
  constexpr int MB = Tile<T>::M / 16;  // 16-row blocks
  constexpr int LDX_ = Tile<T>::LDX, LDH_ = Tile<T>::LDH,
                LDD_ = Tile<T>::LDD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  float acc[MB][2][4];

  // --- the forward again: h0, h1, rnd(feat)
  if constexpr (sizeof(T) == 4) {  // FFMA, one thread's k sum in order
    const int ty = tid >> 4, tx = tid & 15;
    float accr[4][8];
    ffma_engine::gemm_nn<2>(accr, s.X, LDX_, FIN, p.w0_kn, HID, s.Ws);
    ffma_engine::store_relu(accr, p.b0, s.H0, LDH_);
    ffma_engine::gemm_nn<2>(accr, s.H0, LDH_, HID, p.w1_kn, HID, s.Ws);
    ffma_engine::store_relu(accr, p.b1, s.H1, LDH_);
    float accf[4][4];
    ffma_engine::gemm_nn<1>(accf, s.H1, LDH_, HID, p.wf_kn, CF, s.Ws);
    const int col = tx * 4;
    const float4 b = __ldg(reinterpret_cast<const float4*>(p.bf + col));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(s.D + (ty * 4 + i) * LDD_ + col) =
          make_float4(accf[i][0] + b.x, accf[i][1] + b.y, accf[i][2] + b.z,
                      accf[i][3] + b.w);
  } else {  // a warp owns 16 columns
    tc::gemm_nn<MB, 2>(acc, s.X, LDX_, FIN / 8, p.w0_kn, HID / 8, 2 * warp);
    tc::store_relu<T>(acc, p.b0, s.H0, LDH_, 2 * warp);
    __syncthreads();
    tc::gemm_nn<MB, 2>(acc, s.H0, LDH_, HID / 8, p.w1_kn, HID / 8, 2 * warp);
    tc::store_relu<T>(acc, p.b1, s.H1, LDH_, 2 * warp);
    __syncthreads();
    float accf[MB][1][4];
    tc::gemm_nn<MB, 1>(accf, s.H1, LDH_, HID / 8, p.wf_kn, CF / 8, warp);
    const int col = 8 * warp + 2 * t;
    const float b0 = __ldg(p.bf + col), b1 = __ldg(p.bf + col + 1);
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        st2(s.D + (16 * m + gq + 8 * v) * LDD_ + col,
            rnd<T>(accf[m][0][2 * v] + b0), rnd<T>(accf[m][0][2 * v + 1] + b1));
  }
  __syncthreads();
  head_grads<T>(s.D, s.G, p.wr, P, s.sBh, s.sBr, s.S);

  // --- heads: dwf += h1^T dfeat, dwa += h1^T dsigma; dh1 -> da1 in place
  tc::gemm_tn<T, HID / 16, 1>(s.H1, LDH_, s.D, LDD_, P + DWF, CF, warp);
  alpha_grad<T>(s.H1, s.D, P);
  tc::gemm_nn<MB, 2>(acc, s.D, LDD_, CF / 8, p.wf, HID / 8, 2 * warp);
  __syncthreads();  // every warp is done reading H1
  tc::mask_store<T>(acc, s.D + CF, LDD_, p.wa, s.H1, LDH_, s.sB1, 2 * warp);
  __syncthreads();

  // --- layer1: dw1 += h0^T da1; dh0 -> da0 in place
  tc::gemm_tn<T, HID / 16, 2>(s.H0, LDH_, s.H1, LDH_, P + DW1, HID, 2 * warp);
  tc::gemm_nn<MB, 2>(acc, s.H1, LDH_, HID / 8, p.w1, HID / 8, 2 * warp);
  __syncthreads();  // every warp is done reading H0
  tc::mask_store<T>(acc, static_cast<const typename Tile<T>::E*>(nullptr), 0,
                    nullptr, s.H0, LDH_, s.sB0, 2 * warp);
  __syncthreads();

  // --- layer0: dw0 += x^T da0; dx = da0 . w0^T (24 column blocks, the
  // last two zero)
  tc::gemm_tn<T, FIN / 16, 2>(s.X, LDX_, s.H0, LDH_, P + DW0, HID, 2 * warp);
  float acc3[MB][3][4];
  tc::gemm_nn<MB, 3>(acc3, s.H0, LDH_, HID / 8, p.w0, 24, 3 * warp);
  __syncthreads();  // every warp is done reading the tiles Dx overwrites
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int col = 8 * (3 * warp + j) + 2 * t;
    if (col < FIN) {
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int v = 0; v < 2; ++v)
          st2(s.Dx + (16 * m + gq + 8 * v) * LDXF + col, acc3[m][j][2 * v],
              acc3[m][j][2 * v + 1]);
    }
  }
  __syncthreads();
}

// The whole backward for a persistent block: its tiles blockIdx.x, +
// gridDim.x, ... of Tile<T>::M rows, each through pro(s, row0, valid) (fill
// X with the tile's MLP input rows, zero past `valid`), the cotangent rows,
// bwd_tile and epi(s, row0, valid) (take the f32 dx tile from s.Dx); then
// the bias sums into the block's partial part[blockIdx.x] [NGRAD], which
// the caller has zeroed.
template <typename T, class Pro, class Epi>
__device__ __forceinline__ void chain_bwd(unsigned char* sm,
                                          const Params<T>& p,
                                          const float* __restrict__ g,
                                          float* __restrict__ part,
                                          long long N, Pro pro, Epi epi) {
  constexpr int M = Tile<T>::M;
  const BwdSmem<T> s(sm);
  float* P = part + size_t(blockIdx.x) * NGRAD;
  for (int i = threadIdx.x; i < kBiasFloats; i += NT) s.sB0[i] = 0.f;
  const long long ntiles = (N + M - 1) / M;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * M;
    const int valid = int(N - row0 < M ? N - row0 : M);
    __syncthreads();  // the tile before is done with every buffer
    pro(s, row0, valid);
    load_g<T>(s.G, g + row0 * NOUT, valid);
    __syncthreads();
    bwd_tile<T>(s, p, P);
    epi(s, row0, valid);
  }
  __syncthreads();
  store_bias_partials(P, s.sB0, s.sB1, s.sBh, s.sBr);
}

// grads[j] = the sum over blocks b = 0, 1, ... of part[b][j], in that order.
__global__ void sum_partials_kernel(const float* __restrict__ part, int nblk,
                                    float* __restrict__ grads) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= NGRAD) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[size_t(b) * NGRAD + j];
  grads[j] = s;
}

// Params from the C entry points' untyped pointers.
template <typename T>
Params<T> make_params(const void* w0_kn, const void* w1_kn, const void* wf_kn,
                      const void* w0, const void* w1, const void* wf,
                      const void* wa, const void* wr, const void* b0,
                      const void* b1, const void* bf, const void* ba,
                      const void* br) {
  using K = typename WeightsOf<T>::K;
  using B = typename WeightsOf<T>::B;
  return Params<T>{(const K*)w0_kn,  (const K*)w1_kn,  (const K*)wf_kn,
                   (const B*)w0,     (const B*)w1,     (const B*)wf,
                   (const float*)wa, (const float*)wr, (const float*)b0,
                   (const float*)b1, (const float*)bf, (const float*)ba,
                   (const float*)br};
}

// The grid of a backward kernel kern for N rows (one persistent block an SM
// at most) into *grid.
template <typename T, typename K>
int bwd_grid(K kern, long long N, int* grid) {
  return int(launch_config(kern, NT, bwd_bytes<T>(),
                           (N + Tile<T>::M - 1) / Tile<T>::M, grid));
}

// Launch the backward kernel on nblk blocks (nblk from bwd_grid: a partial
// a block), then sum the partials into grads.
template <typename T, typename K, typename... Args>
int launch_bwd(K kern, int nblk, long long N, float* part, float* grads,
               cudaStream_t stream, Args... args) {
  int grid = 0;
  int e = bwd_grid<T>(kern, N, &grid);
  if (e) return e;
  if (grid != nblk) return int(cudaErrorInvalidValue);
  kern<<<grid, NT, bwd_bytes<T>(), stream>>>(args..., part, N);
  if ((e = int(cudaGetLastError()))) return e;
  sum_partials_kernel<<<(NGRAD + 255) / 256, 256, 0, stream>>>(part, nblk,
                                                               grads);
  return int(cudaGetLastError());
}

}  // namespace
