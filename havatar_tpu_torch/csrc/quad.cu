// The field's radiance from the two feature planes, forward and backward:
// the gather of each point's bilinear corner texels, their corner reduction,
// the dense chain and, in the backward, the splat into the plane gradients.
// Written for Hopper (sm_90a). Plain C entry points, bound from Python with
// ctypes (havatar_tpu_torch/ops/mlp_quad.py).
//
// What they replace:
//   quad_forward_f32, quad_forward_bf16
//       -> havatar_tpu/ops/pallas_mlp_quad.py:field_radiance_quad, forward
//          (Pallas kernel _fwd_kernel)
//   quad_backward (float32 or bf16 planes)
//       -> havatar_tpu/ops/pallas_mlp_quad.py:field_radiance_quad, backward
//          (Pallas kernel _bwd_kernel)
//
// The function, for one batch item: planes [H][W][C] (XY and ZY, C = 64,
// float32 or bf16 = cdt), rows [N][2] int32 (each plane's quad row y0 *
// (W - 1) + x0 of the point's bilinear cell), aux [N][56] f32 = posenc (48)
// ++ the 8 corner weights (y0x0, y0x1, y1x0, y1x1 of XY, then of ZY). The
// MLP input row is [xy (64) | zy (64) | posenc (48)], xy = sum over the four
// corners of texel * weight in f32, rounded to cdt; layer0 takes its input
// rows in that block order. Then the dense chain of csrc/mlp.cu: two
// 128-wide relu layers, the feature head (64) and the density head (1),
// the colour head (3) off the features; out [N][68] f32 = [rgb | feat |
// sigma]. The backward recomputes the activations, runs the transposed
// chain with the cotangents rounded to cdt before each product, keeps dx in
// f32 and adds dx_plane * w_k into each corner texel of the f32 plane
// gradients; daux [N][56] = d(posenc) ++ dw[8], dw[k] = sum over c of
// texel_k[c] * dx_plane[c]; the weight and bias gradients are summed over
// the rows.
//
// What bounds them on an H100: a row costs 47,424 multiply-adds forward and
// three times that backward, against 8 + 224 + 272 B of rows, aux and out
// (the backward adds 272 B of cotangent and 224 B of daux); the planes
// (2 x 4 MB at 128^2 x 64 in float32) and their gradients stay in L2, read
// 4 + 4 texel rows a row. At 1,048,576 rows float32 is bound by its FFMA
// products (1.50 ms forward, 4.49 ms backward at 67 TFLOP/s), bf16 by its
// bytes forward (0.16 ms) and its tensor-core products backward (0.35 ms).
//
// What the design does about it:
//  * gather and splat in the kernel: one warp a row, lanes 0-15 on the XY
//    plane, 16-31 on the ZY plane, four channels a lane. The prologue reads
//    the four corner texels with 16-byte (f32) or 8-byte (bf16) loads and
//    sums them in corner order without FMA (__fmul_rn, __fadd_rn): the
//    reduced input is the plain twin's to the bit, so kernel and twin see
//    the same ReLU masks. The epilogue reads the texels again (from L2) for
//    dw, reduced over the half-warp, and adds dx_plane * w_k into each texel
//    with one float4 atomicAdd a lane and corner: 128 vector reductions a
//    row. No [N][8C] corner rows or their gradient ever reach device memory.
//  * weight gradients without atomics: each persistent block adds its tiles'
//    contractions into a private float32 partial of all 47,748 gradient
//    values (weights and biases, in ops/mlp.py's _GRAD_SIZES order) with
//    plain vector loads and stores; a second short kernel sums the partials
//    in block order. Blocks take tiles blockIdx.x, + gridDim.x, ... and
//    every in-block sum runs in a fixed order, so two launches give the
//    same gradients bit for bit.
//  * products, float32: FFMA, csrc/ffma.cuh's engine, on 64-row
//    shared-memory tiles (a thread holds a 4 x 8 block of the output). The
//    weights (190 KB) do not fit beside the activations, so each product
//    streams its weight from L2 in 16-row chunks through two cp.async
//    stages: the next chunk copies while this one is multiplied, one
//    barrier a chunk. The forward's tiles (107 KB) let two blocks share an
//    SM; the backward's live tiles (x, h0, h1 and the head cotangent, 131 KB
//    at 64 rows, 185 KB with the rest) leave room for one. Split-TF32
//    tensor-core products and 8 x 8 register tiles were built and measured
//    (PERF.md, section 6): the recomputed hidden layers must round as the
//    twin's dense layers do, or ReLU masks flip and the weight gradients
//    leave their bound, and the 8 x 8 tiles were slower. So float32 stays
//    on this engine.
//  * products, bf16 backward: mma.sync m16n8k8 bf16 on the tensor cores. A
//    warp owns 16 output columns of the 64-row tile; activations stay in the
//    float tiles (bf16 values, packed as the fragments load), the weights
//    come from L2 in fragment order (one coalesced load a warp and 8 x 8
//    block, the next k step's loaded while this one multiplies), and the
//    weight-gradient products contract the tile's rows on the same route.
//  * bf16 forward: the tensor-core chain of field_mlp.cuh with its gather
//    input mode (gather_inputs).
//  * a ragged N is masked in the kernel: rows past the end read nothing,
//    write nothing and contribute nothing to any gradient.

#include "ffma.cuh"
#include "field_mlp.cuh"

namespace {

constexpr int FIN = 176, HID = 128, CF = 64, NOUT = 68;  // production widths
constexpr int QC = 64, NPE = FIN - 2 * QC, NAUX = NPE + 8;
using ffma_engine::KC;   // weight rows a staged chunk (FFMA engine)
using ffma_engine::LDW;  // a weight stage's row
using ffma_engine::NT;   // threads a block: 8 warps
using ffma_engine::TM;   // rows a tile: 64
constexpr int LDX = FIN + 4, LDH = HID + 4, LDD = CF + 4;  // f32 row strides

// the flat gradient vector (ops/mlp.py's _GRAD_SIZES order; weights [in][out])
constexpr int DW0 = 0, DW1 = DW0 + FIN * HID, DWF = DW1 + HID * HID,
              DWA = DWF + HID * CF, DWR = DWA + HID, DB0 = DWR + CF * 3,
              DB1 = DB0 + HID, DBF = DB1 + HID, DBA = DBF + CF, DBR = DBA + 1,
              NGRAD = DBR + 3;
static_assert(NGRAD % 4 == 0, "a block's partial stays 16-byte aligned");

// per-tile shared memory beyond the activations: the corner weights [TM][8],
// each row's two texel bases [TM][2] (ints), and the column-sum scratch
constexpr int kRowFloats = TM * 8 + TM * 2;
constexpr int kScratch = 16 * HID;
using ffma_engine::kStageFloats;  // the FFMA engine's weight stages
// float32 forward: x/h1 [TM][LDX] | h0/feat [TM][LDH] | stages | rows
constexpr int kFwdFloats = TM * LDX + TM * LDH + kStageFloats + kRowFloats;
// backward (BwdSmem): x | h0/da0 | h1/da1 | feat/dfa | g | bias sums | rows
// | scratch, and the stages on the FFMA engine
constexpr int kBiasFloats = HID + HID + LDD + 4;
constexpr int kBwdFloats = TM * LDX + 2 * TM * LDH + 2 * TM * LDD +
                           kBiasFloats + kRowFloats + kScratch;

template <typename T>
struct Planes {
  const T *xy, *zy;  // [H][W][QC]
  int W;
};

template <typename T> struct WeightOf { using type = float; };
template <> struct WeightOf<bf16> { using type = uint32_t; };

// float32: W^T [in][out] (w*_kn) and W [out][in] as they are; bf16: the
// same in fragment order (ops/mlp_quad.py:_frags; w0 padded to 192 columns)
template <typename T>
struct Params {
  using F = typename WeightOf<T>::type;
  const F *w0_kn, *w1_kn, *wf_kn, *w0, *w1, *wf;
  const float *wa, *wr;                 // fc_alpha [128], fc_rgb [3][64]
  const float *b0, *b1, *bf, *ba, *br;  // [128], [128], [64], [1], [3]
};

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const bf162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const bf162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// texel offset of corner k (y0x0, y0x1, y1x0, y1x1) from the cell's y0x0
__device__ __forceinline__ int corner(int k, int W) {
  return (k >> 1) * W + (k & 1);
}

// s (+)= v * w, each product and sum rounded on its own (no FMA)
__device__ __forceinline__ void corner_add(float4& s, const float4& v, float w,
                                           bool first) {
  const float4 m = make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w),
                               __fmul_rn(v.z, w), __fmul_rn(v.w, w));
  s = first ? m
            : make_float4(__fadd_rn(s.x, m.x), __fadd_rn(s.y, m.y),
                          __fadd_rn(s.z, m.z), __fadd_rn(s.w, m.w));
}

// The texel base (y0 * W + x0) of plane p's cell for a row, from its quad row.
__device__ __forceinline__ int texel_base(const int* __restrict__ rows, int p,
                                          int W) {
  const int q = __ldg(rows + p);
  const int y0 = q / (W - 1);
  return q + y0;  // y0 * (W - 1) + x0 + y0
}

// The prologue of the float engines: for each of the tile's rows, gather the
// 4 + 4 corner texels, corner-reduce them into the MLP input row [xy | zy |
// posenc] of X, rounded to T; the corner weights into W8 [TM][8] and the two
// texel bases into Base [TM][2]. One warp a row; rows at or past `valid`
// are zero.
template <typename T>
__device__ void gather_rows(float* X, float* W8, int* Base, const Planes<T>& pl,
                            const int* __restrict__ rows,
                            const float* __restrict__ aux, int valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = lane >> 4, c = 4 * (lane & 15);
  const T* plane = p ? pl.zy : pl.xy;
  for (int r = warp; r < TM; r += NT / 32) {
    float* xr = X + r * LDX;
    if (r >= valid) {
      for (int j = lane; j < FIN; j += 32) xr[j] = 0.f;
      if (lane < 8) W8[r * 8 + lane] = 0.f;
      if (lane < 2) Base[r * 2 + lane] = 0;
      continue;
    }
    const float* a = aux + size_t(r) * NAUX;
    const int base = texel_base(rows + 2 * r, p, pl.W);
    const T* t = plane + size_t(base) * QC + c;
    float4 s;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      corner_add(s, ld4(t + size_t(corner(k, pl.W)) * QC),
                 __ldg(a + NPE + 4 * p + k), k == 0);
    *reinterpret_cast<float4*>(xr + p * QC + c) =
        make_float4(rnd<T>(s.x), rnd<T>(s.y), rnd<T>(s.z), rnd<T>(s.w));
    for (int j = lane; j < NPE; j += 32) xr[2 * QC + j] = rnd<T>(__ldg(a + j));
    if (lane < 8) W8[r * 8 + lane] = __ldg(a + NPE + lane);
    if ((lane & 15) == 0) Base[r * 2 + p] = base;
  }
}

// The backward's epilogue for one tile: Dx [TM][LDX] holds the tile's f32 dx.
// One warp a row, as in gather_rows: dw[k] = texel_k . dx_plane (a
// half-warp reduction), dx_plane * w_k added into texel k of the plane's
// gradient, d(posenc) = dx's tail; daux = [d(posenc) | dw]. Rows at or past
// `valid` write nothing.
template <typename T>
__device__ void splat_rows(const float* Dx, const float* W8, const int* Base,
                           const Planes<T>& pl, float* __restrict__ dxy,
                           float* __restrict__ dzy, float* __restrict__ daux,
                           int valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = lane >> 4, c = 4 * (lane & 15);
  const T* plane = p ? pl.zy : pl.xy;
  float* dplane = p ? dzy : dxy;
  for (int r = warp; r < valid; r += NT / 32) {
    const float4 d = *reinterpret_cast<const float4*>(Dx + r * LDX + p * QC + c);
    const size_t base = size_t(Base[r * 2 + p]);
    float* da = daux + size_t(r) * NAUX;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const size_t off = (base + corner(k, pl.W)) * QC + c;
      const float4 v = ld4(plane + off);
      float s = fmaf(v.x, d.x, fmaf(v.y, d.y, fmaf(v.z, d.z, v.w * d.w)));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if ((lane & 15) == 0) da[NPE + 4 * p + k] = s;
      const float w = W8[r * 8 + 4 * p + k];
      atomicAdd(reinterpret_cast<float4*>(dplane + off),
                make_float4(d.x * w, d.y * w, d.z * w, d.w * w));
    }
    for (int j = lane; j < NPE; j += 32) da[j] = Dx[r * LDX + 2 * QC + j];
  }
}

// Ask L2 for the streamed rows of the tile of up to TM points at row0 (its
// cells and aux), one prefetch a thread and 128-byte line, so that a later
// gather's first loads hit L2.
__device__ __forceinline__ void prefetch_tile(const int* rows,
                                              const float* aux, long long row0,
                                              long long N) {
  if (row0 >= N) return;
  const int n = int(N - row0 < TM ? N - row0 : TM);
  const char* r = reinterpret_cast<const char*>(rows + 2 * row0);
  const char* a = reinterpret_cast<const char*>(aux + row0 * NAUX);
  const int lr = (n * 8 + 127) / 128, la = (n * NAUX * 4 + 127) / 128;
  for (int i = threadIdx.x; i < lr + la; i += blockDim.x)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(i < lr ? r + i * 128
                                                         : a + (i - lr) * 128));
}

// ---------------------------------------------------------------------------
// the bf16 engine: mma.sync m16n8k8 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// two floats that hold bf16 values, packed (the first in the low half)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const bf162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One warp's m16n8k8 operands from float tiles that hold bf16 values, lane
// = 4 g + t as in the PTX fragment layouts: element (m, k) of A at p[m * sm
// + k * sk], element (k, n) of B at p[k * sk + n * sn]. A weight's B comes
// in fragment order instead (one uint32 a lane and 8 x 8 block, see
// ops/mlp_quad.py:_frags).
struct AFrag { uint32_t r[2]; };
__device__ __forceinline__ AFrag load_a(const float* p, int sm, int sk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return AFrag{{pack(p[g * sm + 2 * t * sk], p[g * sm + (2 * t + 1) * sk]),
            pack(p[(g + 8) * sm + 2 * t * sk],
                 p[(g + 8) * sm + (2 * t + 1) * sk])}};
}
__device__ __forceinline__ uint32_t load_b(const float* p, int sk, int sn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return pack(p[2 * t * sk + g * sn], p[(2 * t + 1) * sk + g * sn]);
}

// Fragment element e of acc[m][j]: row 16 m + g + 8 (e >> 1), column
// 8 (nb0 + j) + 2 t + (e & 1).

// acc[m][j] = A[16 m .. 16 m + 16][:8 KB] . B[:8 KB][8 (nb0 + j) ..] for
// the tile's 64 rows (m < 4) and the warp's NJ column blocks; A a float
// tile (row stride lda), B a weight in fragment order, NB column blocks
// wide. The next k step's B fragments load while this one's multiply.
template <int NJ>
__device__ __forceinline__ void gemm_nn(float (&acc)[4][NJ][4], const float* A,
                                        int lda, int KB,
                                        const uint32_t* __restrict__ F,
                                        int NB, int nb0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  uint32_t b[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) b[j] = __ldg(F + (nb0 + j) * 32 + lane);
  for (int kb = 0; kb < KB; ++kb) {
    uint32_t nb[NJ];
    const int kn = kb + 1 < KB ? kb + 1 : kb;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      nb[j] = __ldg(F + (size_t(kn) * NB + nb0 + j) * 32 + lane);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const AFrag a = load_a(A + 16 * m * lda + 8 * kb, lda, 1);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma(acc[m][j], a.r[0], a.r[1], b[j]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = nb[j];
  }
}

// P[i][o] += sum over the tile's rows r of A[r][i] * B[r][o], for all MI*16
// inputs i and the warp's NJ output column blocks (o from 8 nb0): a weight
// gradient's share of one tile, contracted on the tensor cores and added
// into the block's own partial P (row stride ldp) with plain float2 loads
// and stores (each element is owned by one thread).
template <int MI, int NJ>
__device__ __forceinline__ void gemm_tn(const float* A, int lda, const float* B,
                                        int ldb, float* P, int ldp, int nb0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll 1
  for (int kb = 0; kb < TM / 8; ++kb) {
    uint32_t b[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = load_b(B + 8 * kb * ldb + 8 * (nb0 + j), ldb, 1);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const AFrag a = load_a(A + 8 * kb * lda + 16 * i, 1, lda);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma(acc[i][j], a.r[0], a.r[1], b[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        float2* o = reinterpret_cast<float2*>(
            P + (16 * i + g + 8 * v) * ldp + 8 * (nb0 + j) + 2 * t);
        float2 s = *o;
        s.x += acc[i][j][2 * v];
        s.y += acc[i][j][2 * v + 1];
        *o = s;
      }
}

// Out[row][col] = bf16(relu(acc + bias)) for the warp's fragments.
template <int NJ>
__device__ __forceinline__ void store_relu(const float (&acc)[4][NJ][4],
                                           const float* __restrict__ bias,
                                           float* Out, int ldo, int nb0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = 8 * (nb0 + j) + 2 * t;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        *reinterpret_cast<float2*>(Out + (16 * m + g + 8 * v) * ldo + col) =
            make_float2(rnd<bf16>(fmaxf(acc[m][j][2 * v] + b0, 0.f)),
                        rnd<bf16>(fmaxf(acc[m][j][2 * v + 1] + b1, 0.f)));
  }
}

// The cotangent of a hidden layer, for the warp's fragments: da = acc (+
// the density head's share dsig[row] * wa[col]) where the activation Hd was
// positive, else 0; bf16(da) replaces Hd in place (each element is read and
// written by one thread). The column sums of da before rounding (over the
// thread's 8 rows, then a fixed shuffle tree over g) go to sB: the warp
// owns its columns.
template <int NJ>
__device__ __forceinline__ void mask_store(const float (&acc)[4][NJ][4],
                                           const float* dsig, int ldsig,
                                           const float* __restrict__ wa,
                                           float* Hd, int ldh, float* sB,
                                           int nb0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 8 * (nb0 + j) + 2 * t + h;
      const float w = dsig ? rnd<bf16>(__ldg(wa + col)) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int r = 16 * m + g + 8 * v;
          float x = acc[m][j][2 * v + h];
          if (dsig) x = fmaf(dsig[r * ldsig], w, x);
          x = Hd[r * ldh + col] > 0.f ? x : 0.f;
          sum += x;
          Hd[r * ldh + col] = rnd<bf16>(x);
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      if (g == 0) sB[col] += sum;
    }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// the backward's steps outside the products, shared by both engines
// ---------------------------------------------------------------------------

// The tile's cotangent rows g [TM][68] into G [TM][LDD]; rows past `valid`
// are zero.
__device__ __forceinline__ void load_g(float* G, const float* __restrict__ g,
                                       int valid) {
  for (int i = threadIdx.x; i < TM * (NOUT / 4); i += NT) {
    const int r = i / (NOUT / 4), c = (i % (NOUT / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      v = __ldg(reinterpret_cast<const float4*>(g + r * NOUT + c));
    *reinterpret_cast<float4*>(G + r * LDD + c) = v;
  }
}

// With rnd(feat) in D and g in G: fc_rgb's weight gradient dwr[k][c] +=
// sum_r feat[r][k] * rnd(g_rgb[r][c]) into the partial, and the rgb and
// alpha bias sums; then, after a barrier, D = rnd(dfa), dfa = [g_feat +
// g_rgb . wr^T | g_sigma], and the feature bias sums (summed before
// rounding). Ends with a barrier.
template <typename T>
__device__ __forceinline__ void head_grads(float* D, const float* G,
                                           const float* __restrict__ wr,
                                           float* P, float* sBh, float* sBr,
                                           float* S) {
  const int tid = threadIdx.x;
  if (tid < CF * 3) {
    const int k = tid / 3, c = tid % 3;
    float s = 0.f;
    for (int r = 0; r < TM; ++r)
      s = fmaf(D[r * LDD + k], rnd<T>(G[r * LDD + c]), s);
    P[DWR + tid] += s;
  } else if (tid < CF * 3 + 3) {
    const int c = tid - CF * 3;
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += G[r * LDD + c];
    sBr[c] += s;  // this thread alone owns sBr[c]
  } else if (tid == CF * 3 + 3) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s += G[r * LDD + 3 + CF];
    sBh[CF] += s;  // d(b_alpha): this thread alone owns it
  }
  __syncthreads();
  {
    const int c = tid & 63;  // one column a thread: NT % 64 == 0
    const float w0 = rnd<T>(__ldg(wr + c)), w1 = rnd<T>(__ldg(wr + CF + c)),
                w2 = rnd<T>(__ldg(wr + 2 * CF + c));
    float sum = 0.f;
    for (int r = tid >> 6; r < TM; r += NT / 64) {
      const float* grow = G + r * LDD;
      const float v = grow[3 + c] + grow[0] * w0 + grow[1] * w1 + grow[2] * w2;
      sum += v;
      D[r * LDD + c] = rnd<T>(v);
    }
    S[(tid >> 6) * CF + c] = sum;
    if (tid < TM) D[tid * LDD + CF] = rnd<T>(G[tid * LDD + 3 + CF]);
  }
  __syncthreads();
  if (tid < CF)
    sBh[tid] += ((S[tid] + S[CF + tid]) + S[2 * CF + tid]) + S[3 * CF + tid];
}

// dwa[k] += sum_r h1[r][k] * rnd(dsigma[r]) (D's column CF) into the
// partial.
__device__ __forceinline__ void alpha_grad(const float* H1, const float* D,
                                           float* P) {
  const int tid = threadIdx.x;
  if (tid < HID) {
    float s = 0.f;
    for (int r = 0; r < TM; ++r) s = fmaf(H1[r * LDH + tid], D[r * LDD + CF], s);
    P[DWA + tid] += s;
  }
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
// forward, float32
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 2)
quad_fwd_kernel(Planes<float> pl, const int* __restrict__ rows,
                const float* __restrict__ aux, Params<float> p,
                float* __restrict__ out, long long N) {
  extern __shared__ __align__(16) float sm[];
  float* X = sm;             // x, then h1
  float* H = X + TM * LDX;   // h0, then feat with row stride LDD
  float* Ws = H + TM * LDH;  // two weight stages
  float* W8 = Ws + 2 * KC * LDW;
  int* Base = reinterpret_cast<int*>(W8 + TM * 8);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long ntiles = (N + TM - 1) / TM;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TM;
    const int valid = int(N - row0 < TM ? N - row0 : TM);
    __syncthreads();  // the tile before is done with X and H
    gather_rows(X, W8, Base, pl, rows + 2 * row0, aux + row0 * NAUX, valid);
    float acc[4][8];
    ffma_engine::gemm_nn<2>(acc, X, LDX, FIN, p.w0_kn, HID, Ws);
    ffma_engine::store_relu(acc, p.b0, H, LDH);
    ffma_engine::gemm_nn<2>(acc, H, LDH, HID, p.w1_kn, HID, Ws);
    ffma_engine::store_relu(acc, p.b1, X, LDX);
    float accf[4][4];
    ffma_engine::gemm_nn<1>(accf, X, LDX, HID, p.wf_kn, CF, Ws);
    {
      const int col = tx * 4;
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.bf + col));
      const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = accf[i][c] + bb[c];
          H[r * LDD + col + c] = v;
          if (r < valid) out[(row0 + r) * NOUT + 3 + col + c] = v;
        }
      }
    }
    __syncthreads();
    {  // sigma = h1 . wa + ba: four threads a row
      const int r = tid >> 2, q = tid & 3;
      float s = 0.f;
#pragma unroll 8
      for (int j = 0; j < HID / 4; ++j)
        s = fmaf(X[r * LDX + q + 4 * j], __ldg(p.wa + q + 4 * j), s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0 && r < valid)
        out[(row0 + r) * NOUT + 3 + CF] = s + __ldg(p.ba);
    }
    if (tid < TM * 3) {  // rgb = feat . wr + br
      const int r = tid / 3, c = tid % 3;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < CF; ++k)
        s = fmaf(H[r * LDD + k], __ldg(p.wr + c * CF + k), s);
      if (r < valid) out[(row0 + r) * NOUT + c] = s + __ldg(p.br + c);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: float32 planes on the FFMA engine, bf16 planes on the tensor
// cores. part: this launch's per-block partials [gridDim.x][NGRAD], zeroed
// by the caller; dxy, dzy [H][W][QC] f32, zeroed by the caller.
// ---------------------------------------------------------------------------

// The backward's shared-memory tiles, in this order: x, then dx | h0, then
// da0 | h1, then da1 | rnd(feat), then rnd(dfa) [TM][65] | g [TM][68] | the
// bias sums | corner weights and texel bases | column-sum scratch [16][HID]
// | (FFMA only) two weight stages.
struct BwdSmem {
  float *X, *H0, *H1, *D, *G, *sB0, *sB1, *sBh, *sBr, *W8, *S, *Ws;
  int* Base;
  __device__ explicit BwdSmem(float* sm) {
    X = sm;
    H0 = X + TM * LDX;
    H1 = H0 + TM * LDH;
    D = H1 + TM * LDH;
    G = D + TM * LDD;
    sB0 = G + TM * LDD;
    sB1 = sB0 + HID;
    sBh = sB1 + HID;  // [65]
    sBr = sBh + LDD;  // [3]
    W8 = sBr + 4;
    Base = reinterpret_cast<int*>(W8 + TM * 8);
    S = W8 + kRowFloats;
    Ws = S + kScratch;
  }
};

__global__ void __launch_bounds__(NT, 1)
quad_bwd_f32_kernel(Planes<float> pl, const int* __restrict__ rows,
                    const float* __restrict__ aux, const float* __restrict__ g,
                    Params<float> p, float* __restrict__ dxy,
                    float* __restrict__ dzy, float* __restrict__ daux,
                    float* __restrict__ part, long long N) {
  extern __shared__ __align__(16) float sm[];
  const BwdSmem s(sm);
  float* P = part + size_t(blockIdx.x) * NGRAD;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int i = tid; i < kBiasFloats; i += NT) s.sB0[i] = 0.f;
  const long long ntiles = (N + TM - 1) / TM;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TM;
    const int valid = int(N - row0 < TM ? N - row0 : TM);
    __syncthreads();  // the tile before is done with every buffer
    gather_rows(s.X, s.W8, s.Base, pl, rows + 2 * row0, aux + row0 * NAUX,
                valid);
    load_g(s.G, g + row0 * NOUT, valid);

    // --- the forward again: h0, h1, feat
    float acc[4][8];
    ffma_engine::gemm_nn<2>(acc, s.X, LDX, FIN, p.w0_kn, HID, s.Ws);
    ffma_engine::store_relu(acc, p.b0, s.H0, LDH);
    ffma_engine::gemm_nn<2>(acc, s.H0, LDH, HID, p.w1_kn, HID, s.Ws);
    ffma_engine::store_relu(acc, p.b1, s.H1, LDH);
    {
      float accf[4][4];
      ffma_engine::gemm_nn<1>(accf, s.H1, LDH, HID, p.wf_kn, CF, s.Ws);
      const int col = tx * 4;
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.bf + col));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(s.D + (ty * 4 + i) * LDD + col) =
            make_float4(accf[i][0] + b.x, accf[i][1] + b.y, accf[i][2] + b.z,
                        accf[i][3] + b.w);
    }
    __syncthreads();
    head_grads<float>(s.D, s.G, p.wr, P, s.sBh, s.sBr, s.S);

    // --- heads: dwf += h1^T dfeat, dwa += h1^T dsigma; dh1 -> da1 in place
    ffma_engine::gemm_tn<HID / 16, 1>(s.H1, LDH, s.D, LDD, P + DWF);
    alpha_grad(s.H1, s.D, P);
    ffma_engine::gemm_nn<2>(acc, s.D, LDD, CF, p.wf, HID, s.Ws);
    ffma_engine::mask_store(acc, s.D + CF, LDD, p.wa, s.H1, LDH, s.S);
    __syncthreads();
    ffma_engine::col_sums(s.S, s.sB1);

    // --- layer1: dw1 += h0^T da1; dh0 -> da0 in place
    ffma_engine::gemm_tn<HID / 16, 2>(s.H0, LDH, s.H1, LDH, P + DW1);
    ffma_engine::gemm_nn<2>(acc, s.H1, LDH, HID, p.w1, HID, s.Ws);
    ffma_engine::mask_store(acc, nullptr, 0, nullptr, s.H0, LDH, s.S);
    __syncthreads();
    ffma_engine::col_sums(s.S, s.sB0);

    // --- layer0: dw0 += x^T da0; dx = da0 . w0^T
    ffma_engine::gemm_tn<FIN / 16, 2>(s.X, LDX, s.H0, LDH, P + DW0);
    float acc3[4][12];
    ffma_engine::gemm_nn<3>(acc3, s.H0, LDH, HID, p.w0, FIN, s.Ws);
    // gemm_nn's barriers have seen every thread past gemm_tn's reads of X
#pragma unroll
    for (int gq = 0; gq < 3; ++gq) {
      const int col = gq * 64 + tx * 4;
      if (col < FIN) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(s.X + (ty * 4 + i) * LDX + col) =
              make_float4(acc3[i][4 * gq + 0], acc3[i][4 * gq + 1],
                          acc3[i][4 * gq + 2], acc3[i][4 * gq + 3]);
      }
    }
    __syncthreads();
    splat_rows(s.X, s.W8, s.Base, pl, dxy, dzy, daux + row0 * NAUX, valid);
  }
  __syncthreads();
  store_bias_partials(P, s.sB0, s.sB1, s.sBh, s.sBr);
}

__global__ void __launch_bounds__(NT, 1)
quad_bwd_bf16_kernel(Planes<bf16> pl, const int* __restrict__ rows,
                     const float* __restrict__ aux, const float* __restrict__ g,
                     Params<bf16> p, float* __restrict__ dxy,
                     float* __restrict__ dzy, float* __restrict__ daux,
                     float* __restrict__ part, long long N) {
  extern __shared__ __align__(16) float sm[];
  const BwdSmem s(sm);
  float* P = part + size_t(blockIdx.x) * NGRAD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  for (int i = tid; i < kBiasFloats; i += NT) s.sB0[i] = 0.f;
  const long long ntiles = (N + TM - 1) / TM;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TM;
    const int valid = int(N - row0 < TM ? N - row0 : TM);
    __syncthreads();  // the tile before is done with every buffer
    gather_rows(s.X, s.W8, s.Base, pl, rows + 2 * row0, aux + row0 * NAUX,
                valid);
    load_g(s.G, g + row0 * NOUT, valid);
    __syncthreads();

    // --- the forward again: h0, h1, rnd(feat); a warp owns 16 columns
    float acc[4][2][4];
    tc::gemm_nn<2>(acc, s.X, LDX, FIN / 8, p.w0_kn, HID / 8, 2 * warp);
    tc::store_relu<2>(acc, p.b0, s.H0, LDH, 2 * warp);
    __syncthreads();
    tc::gemm_nn<2>(acc, s.H0, LDH, HID / 8, p.w1_kn, HID / 8, 2 * warp);
    tc::store_relu<2>(acc, p.b1, s.H1, LDH, 2 * warp);
    __syncthreads();
    {
      float accf[4][1][4];
      tc::gemm_nn<1>(accf, s.H1, LDH, HID / 8, p.wf_kn, CF / 8, warp);
      const int col = 8 * warp + 2 * t;
      const float b0 = __ldg(p.bf + col), b1 = __ldg(p.bf + col + 1);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int v = 0; v < 2; ++v)
          *reinterpret_cast<float2*>(s.D + (16 * m + gq + 8 * v) * LDD + col) =
              make_float2(rnd<bf16>(accf[m][0][2 * v] + b0),
                          rnd<bf16>(accf[m][0][2 * v + 1] + b1));
    }
    __syncthreads();
    head_grads<bf16>(s.D, s.G, p.wr, P, s.sBh, s.sBr, s.S);

    // --- heads: dwf += h1^T dfeat, dwa += h1^T dsigma; dh1 -> da1 in place
    tc::gemm_tn<HID / 16, 1>(s.H1, LDH, s.D, LDD, P + DWF, CF, warp);
    alpha_grad(s.H1, s.D, P);
    tc::gemm_nn<2>(acc, s.D, LDD, CF / 8, p.wf, HID / 8, 2 * warp);
    __syncthreads();  // every warp is done reading H1
    tc::mask_store<2>(acc, s.D + CF, LDD, p.wa, s.H1, LDH, s.sB1, 2 * warp);
    __syncthreads();

    // --- layer1: dw1 += h0^T da1; dh0 -> da0 in place
    tc::gemm_tn<HID / 16, 2>(s.H0, LDH, s.H1, LDH, P + DW1, HID, 2 * warp);
    tc::gemm_nn<2>(acc, s.H1, LDH, HID / 8, p.w1, HID / 8, 2 * warp);
    __syncthreads();  // every warp is done reading H0
    tc::mask_store<2>(acc, nullptr, 0, nullptr, s.H0, LDH, s.sB0, 2 * warp);
    __syncthreads();

    // --- layer0: dw0 += x^T da0; dx = da0 . w0^T (24 column blocks, the
    // last two zero)
    tc::gemm_tn<FIN / 16, 2>(s.X, LDX, s.H0, LDH, P + DW0, HID, 2 * warp);
    float acc3[4][3][4];
    tc::gemm_nn<3>(acc3, s.H0, LDH, HID / 8, p.w0, 24, 3 * warp);
    __syncthreads();  // every warp is done reading X
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int col = 8 * (3 * warp + j) + 2 * t;
      if (col < FIN) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int v = 0; v < 2; ++v)
            *reinterpret_cast<float2*>(s.X + (16 * m + gq + 8 * v) * LDX +
                                       col) =
                make_float2(acc3[m][j][2 * v], acc3[m][j][2 * v + 1]);
      }
    }
    __syncthreads();
    splat_rows(s.X, s.W8, s.Base, pl, dxy, dzy, daux + row0 * NAUX, valid);
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

// ---------------------------------------------------------------------------
// forward, bf16: the tensor-core chain of field_mlp.cuh, gathered rows in
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
quad_fwd_mma_kernel(Planes<bf16> pl, const int* __restrict__ rows,
                    const float* __restrict__ aux, Weights w,
                    float* __restrict__ out, long long N, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* sF = reinterpret_cast<const float*>(smem + L.h);
  const float* sSig = reinterpret_cast<const float*>(smem + L.sig);
  const float* sRgb = reinterpret_cast<const float*>(smem + L.rgb);
  const long long ntiles = (N + kPoints - 1) / kPoints;

  stage_weights<HID, CF>(smem, L, w);
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long pt0 = tile * kPoints;
    const int valid = int(N - pt0 < kPoints ? N - pt0 : kPoints);
    // the next tile's rows: the gather's loads then start from L2
    for (int h = 0; h < kPoints; h += TM)
      prefetch_tile(rows, aux, pt0 + h + kPoints * gridDim.x, N);
    __syncthreads();  // weights staged
    gather_inputs(smem, L, pl.xy, pl.zy, pl.W, rows, aux, long(pt0), valid,
                  QC, NPE, warp, lane);
    __syncwarp();
    mlp_rows<HID, CF>(smem, L, warp, lane);
    __syncwarp();
    // a warp's 16 rows are one contiguous span of the output
    const int n = min(16, valid - warp * 16);
    float* o = out + (pt0 + warp * 16) * NOUT;
    for (int i = lane; i < n * NOUT; i += 32) {
      const int pr = warp * 16 + i / NOUT, c = i % NOUT;
      o[i] = c < 3 ? sRgb[pr * 3 + c]
                   : c < 3 + CF ? sF[pr * L.ldf + c - 3] : sSig[pr];
    }
    __syncwarp();  // the rows are read before the next tile overwrites them
  }
}

template <typename T>
Params<T> make_params(const void* w0_kn, const void* w1_kn, const void* wf_kn,
                      const void* w0, const void* w1, const void* wf,
                      const void* wa, const void* wr, const void* b0,
                      const void* b1, const void* bf, const void* ba,
                      const void* br) {
  using F = typename WeightOf<T>::type;
  return Params<T>{(const F*)w0_kn, (const F*)w1_kn, (const F*)wf_kn,
                   (const F*)w0,    (const F*)w1,    (const F*)wf,
                   (const float*)wa, (const float*)wr, (const float*)b0,
                   (const float*)b1, (const float*)bf, (const float*)ba,
                   (const float*)br};
}

template <typename T>
constexpr size_t bwd_bytes() {
  return size_t(kBwdFloats + (sizeof(T) == 4 ? kStageFloats : 0)) * 4;
}

template <typename T>
int bwd_grid(long long N, int* grid) {
  const long long ntiles = (N + TM - 1) / TM;
  if constexpr (sizeof(T) == 4)
    return int(launch_config(quad_bwd_f32_kernel, NT, bwd_bytes<T>(), ntiles,
                             grid));
  else
    return int(launch_config(quad_bwd_bf16_kernel, NT, bwd_bytes<T>(), ntiles,
                             grid));
}

template <typename T>
int launch_bwd(const Planes<T>& pl, const int* rows, const float* aux,
               const float* g, const Params<T>& p, float* dxy, float* dzy,
               float* daux, float* part, int nblk, float* grads, long long N,
               void* stream) {
  int grid = 0;
  int e = bwd_grid<T>(N, &grid);
  if (e) return e;
  if (grid != nblk) return int(cudaErrorInvalidValue);
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 4)
    quad_bwd_f32_kernel<<<grid, NT, bwd_bytes<T>(), s>>>(
        pl, rows, aux, g, p, dxy, dzy, daux, part, N);
  else
    quad_bwd_bf16_kernel<<<grid, NT, bwd_bytes<T>(), s>>>(
        pl, rows, aux, g, p, dxy, dzy, daux, part, N);
  if ((e = int(cudaGetLastError()))) return e;
  sum_partials_kernel<<<(NGRAD + 255) / 256, 256, 0, s>>>(part, nblk, grads);
  return int(cudaGetLastError());
}

bool shape_ok(int H, int W, long long N) {
  return H >= 2 && W >= 2 && N >= 0;
}

}  // namespace

extern "C" {

const char* quad_error_string(int e) {
  return cudaGetErrorString(cudaError_t(e));
}

// planes [H][W][64] f32, rows [N][2] int32, aux [N][56] f32 -> out [N][68]
// f32. Weights f32: w*_kn as [in][out], w0_kn's 176 input rows in block
// order.
int quad_forward_f32(const void* pxy, const void* pzy, int H, int W,
                     const void* rows, const void* aux, const void* w0_kn,
                     const void* w1_kn, const void* wf_kn, const void* wa,
                     const void* wr, const void* b0, const void* b1,
                     const void* bf, const void* ba, const void* br,
                     void* out, long long N, void* stream) {
  if (!shape_ok(H, W, N)) return int(cudaErrorInvalidValue);
  if (N == 0) return int(cudaSuccess);
  const Params<float> p = make_params<float>(
      w0_kn, w1_kn, wf_kn, nullptr, nullptr, nullptr, wa, wr, b0, b1, bf, ba,
      br);
  const Planes<float> pl{(const float*)pxy, (const float*)pzy, W};
  const size_t bytes = size_t(kFwdFloats) * 4;
  int grid = 0;
  cudaError_t e = launch_config(quad_fwd_kernel, NT, bytes, (N + TM - 1) / TM,
                                &grid);
  if (e != cudaSuccess) return int(e);
  quad_fwd_kernel<<<grid, NT, bytes, (cudaStream_t)stream>>>(
      pl, (const int*)rows, (const float*)aux, p, (float*)out, N);
  return int(cudaGetLastError());
}

// planes [H][W][64] bf16, rows, aux as above -> out [N][68] f32. Weights
// bf16 as [out][in] (wh stacks fc_rgbFeat's 64 rows and fc_alpha's row),
// w0's 176 input columns in block order; biases f32.
int quad_forward_bf16(const void* pxy, const void* pzy, int H, int W,
                      const void* rows, const void* aux, const void* w0,
                      const void* b0, const void* w1, const void* b1,
                      const void* wh, const void* bh, const void* wr,
                      const void* br, void* out, long long N, void* stream) {
  if (!shape_ok(H, W, N)) return int(cudaErrorInvalidValue);
  if (N == 0) return int(cudaSuccess);
  const Layout L = make_layout<HID, CF>(FIN, 0);
  const Weights w{(const bf16*)w0, (const bf16*)w1, (const bf16*)wh,
                  (const bf16*)wr, (const float*)b0, (const float*)b1,
                  (const float*)bh, (const float*)br};
  const Planes<bf16> pl{(const bf16*)pxy, (const bf16*)pzy, W};
  int grid = 0;
  cudaError_t e = launch_config(quad_fwd_mma_kernel, kThreads, L.total,
                                (N + kPoints - 1) / kPoints, &grid);
  if (e != cudaSuccess) return int(e);
  quad_fwd_mma_kernel<<<grid, kThreads, L.total, (cudaStream_t)stream>>>(
      pl, (const int*)rows, (const float*)aux, w, (float*)out, N, L);
  return int(cudaGetLastError());
}

// The backward kernel's grid for N rows: the number of per-block partials
// [grid][47748] f32 that quad_backward needs.
int quad_backward_blocks(long long N, int planes_bf16, int* grid) {
  if (N < 0) return int(cudaErrorInvalidValue);
  *grid = 0;
  if (N == 0) return int(cudaSuccess);
  return planes_bf16 ? bwd_grid<bf16>(N, grid) : bwd_grid<float>(N, grid);
}

// planes [H][W][64] (f32, or bf16 when planes_bf16), rows [N][2] int32, aux
// [N][56] f32, g [N][68] f32 -> dxy, dzy [H][W][64] f32 (zeroed by the
// caller; the texels' gradients are added in), daux [N][56] f32 and grads
// [47748] f32, the weight gradients as [in][out] (dw0's rows in block order)
// then the bias gradients. part [nblk][47748] f32, zeroed by the caller,
// nblk from quad_backward_blocks. w*_kn = W^T [in][out] and w* = W
// [out][in], w0's 176 inputs in block order: float32 as they are for f32
// planes; for bf16 planes in bf16 fragment order (ops/mlp_quad.py:_frags,
// w0 padded to 192 columns). wa, wr and the biases f32, rounded to the
// planes' type in the kernel.
int quad_backward(const void* pxy, const void* pzy, int H, int W,
                  const void* rows, const void* aux, const void* g,
                  const void* w0_kn, const void* w1_kn, const void* wf_kn,
                  const void* w0, const void* w1, const void* wf,
                  const void* wa, const void* wr, const void* b0,
                  const void* b1, const void* bf, void* dxy, void* dzy,
                  void* daux, void* part, int nblk, void* grads, long long N,
                  int planes_bf16, void* stream) {
  if (!shape_ok(H, W, N)) return int(cudaErrorInvalidValue);
  if (N == 0) return int(cudaSuccess);
  if (planes_bf16)
    return launch_bwd(Planes<bf16>{(const bf16*)pxy, (const bf16*)pzy, W},
                      (const int*)rows, (const float*)aux, (const float*)g,
                      make_params<bf16>(w0_kn, w1_kn, wf_kn, w0, w1, wf, wa,
                                        wr, b0, b1, bf, nullptr, nullptr),
                      (float*)dxy, (float*)dzy, (float*)daux, (float*)part,
                      nblk, (float*)grads, N, stream);
  return launch_bwd(Planes<float>{(const float*)pxy, (const float*)pzy, W},
                    (const int*)rows, (const float*)aux, (const float*)g,
                    make_params<float>(w0_kn, w1_kn, wf_kn, w0, w1, wf, wa,
                                       wr, b0, b1, bf, nullptr, nullptr),
                    (float*)dxy, (float*)dzy, (float*)daux, (float*)part,
                    nblk, (float*)grads, N, stream);
}

}  // extern "C"
