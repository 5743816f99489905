// The NeRF field's dense chain, forward and backward, written for Hopper
// (sm_90a). Plain C entry points, bound from Python with ctypes
// (havatar_tpu_torch/ops/mlp.py).
//
// What they replace:
//   mlp_forward_f32, mlp_forward_bf16
//       -> havatar_tpu/ops/pallas_mlp.py:fused_mlp_chain, forward
//          (Pallas kernel _mlp_kernel)
//   mlp_backward (float32 or bf16 x)
//       -> havatar_tpu/ops/pallas_mlp.py:fused_mlp_chain, backward
//          (Pallas kernel _mlp_bwd_kernel)
//   field_eval_f32, field_eval_bf16
//       -> havatar_tpu/ops/pallas_field.py:fused_field_eval (Pallas kernel
//          _field_kernel; inference only, no backward)
//
// The function: x [N, 176] (plane features ++ posenc) through two 128-wide
// relu layers, then the feature head (64) and the density head (1) off the
// second layer and the colour head (3) off the features; out [N, 68] f32 =
// [rgb | feat | sigma]. cdt is x's type: weights and the hidden activations
// (and feat, as the colour head's input) are rounded to cdt, every product
// accumulates in f32, biases are f32. The backward recomputes the
// activations from x, runs the transposed chain with the cotangents rounded
// to cdt before each product, and sums all weight and bias gradients over
// the rows; bias gradients sum the cotangents before rounding.
//
// What bounds them on an H100: operations, in float32. A row costs 47,424
// multiply-adds forward (176*128 + 128*128 + 128*65 + 64*3) and three times
// that backward, against 976 bytes forward (704 in, 272 out) and 1,952
// backward: at 67 TFLOP/s and 3.35 TB/s the float32 products take about five
// times as long as the bytes. In bf16 on the tensor cores (989 TFLOP/s) the
// forward is bound by its bytes instead.
//
// What the design does about it:
//  * float32 (what stage-1 training runs): TF32 tensor-core products keep 10
//    mantissa bits and would miss the gradient bound, so the products are
//    FFMA on shared-memory tiles. A persistent block of 256 threads walks
//    over tiles of 64 rows; the tile's activations stay in shared memory
//    from x to the outputs, so the only device-memory traffic is x, g, out
//    and dx. The weights (190 KB in float32) do not fit beside the
//    activations, so each product streams its weight from L2 through a 12 KB
//    stage, 16 rows at a time, the next chunk prefetched into registers
//    while the current one is multiplied. A thread holds a 4 x 8 (or 4 x 4,
//    4 x 12) block of the output in registers; A comes from shared memory as
//    broadcast 16-byte loads and B as conflict-free 16-byte loads.
//  * weight gradients: blocks run at once, so there is no sequential grid to
//    carry a sum. Each block contracts its tile's rows in registers and adds
//    the tile's partial into the zeroed float32 outputs with atomicAdd (the
//    order of those additions differs from run to run); bias gradients are
//    carried in shared memory over all of a block's tiles and added once.
//  * a ragged N is masked in the kernel: rows past the end load zeros, write
//    nothing, and contribute nothing to any gradient.
//  * bf16 forward: the tensor-core chain that the march kernels run
//    (field_mlp.cuh), with the [rgb | feat | sigma] rows written out instead
//    of composited.
//  * bf16 backward: the float32 engine with cdt = bf16 (operands rounded to
//    bf16 where the function says so, products on FFMA). It computes the
//    function exactly and leaves the tensor cores idle: a first version.
//  * field_eval entry points: the forward engines with a second input mode,
//    PE. Their input is the points [N, 3] f32 and the plane features
//    [N, 128] (f32 for the FFMA engine, bf16 for the tensor-core one); the
//    loader stages a tile's points (one contiguous 12-byte-a-row block, read
//    with coalesced 4-byte loads) in shared memory, copies the feature rows
//    and writes the 48 posenc columns of the x tile itself, in the order
//    [F, (sin, sin + pi/2), C], rounded to the chain's type. The angle is
//    p * 2^f (exact), and the second column is sinf of the float32-rounded
//    angle + pi/2, as the twin's sin(angles + pi/2) computes it, not the
//    cosine: the two differ by an ulp of the angle, 6e-5 at |angle| ~ 600.
//    sinf, not __sinf (no fast math). Layer0 takes x in the reference's
//    order: no permutation. A row moves 12 + 512 (f32) or 256 (bf16) bytes
//    in and 272 out against the same 47,424 multiply-adds: float32 stays
//    bound by operations, bf16 by bytes.

#include "field_mlp.cuh"

namespace {

constexpr int FIN = 176, HID = 128, CF = 64, NOUT = 68;  // production widths
constexpr int TM = 64;     // rows a tile
constexpr int NT = 256;    // threads a block, as 16 (rows) x 16 (columns)
constexpr int KC = 16;     // weight rows a staged chunk
constexpr int LDX = FIN + 4, LDH = HID + 4, LDD = CF + 4;  // f32 row strides
constexpr int LDW = 192;   // staged chunk row: up to three 64-column groups
// the field_eval entry points: posenc columns, plane features a row, posenc
// frequencies
constexpr int NPE = 48, FEAT = FIN - NPE, NFREQ = NPE / 6;

// What a forward's input rows are: x [N][FIN]; or plane features [N][FEAT]
// with the points [N][3] (PE).
enum class In { X, PE };

// forward: x/h1 [TM][LDX] | h0/feat [TM][LDH] | weight stage [KC][LDW]
constexpr int kFwdFloats = TM * LDX + TM * LDH + KC * LDW;
// backward: x | h0/da0 | h1/da1 | feat/dfa | g | weight stage | bias sums
constexpr int kBiasFloats = HID + HID + LDD + 4;
constexpr int kBwdFloats =
    TM * LDX + 2 * TM * LDH + 2 * TM * LDD + KC * LDW + kBiasFloats;
constexpr int kPeFloats = TM * 3;    // the field_eval entry points' points

constexpr int extra_floats(In in) {
  return in == In::PE ? kPeFloats : 0;
}

struct Params {
  // [in][out] copies, k-major for the forward products
  const float *w0_kn, *w1_kn, *wf_kn;  // [176][128], [128][128], [128][64]
  // [out][in] (torch Linear), k-major for the transposed chain
  const float *w0, *w1, *wf;           // [128][176], [128][128], [64][128]
  const float *wa, *wr;                // fc_alpha [128], fc_rgb [3][64]
  const float *b0, *b1, *bf, *ba, *br; // [128], [128], [64], [1], [3]
};

struct Grads {  // float32, zeroed by the caller; weights as [in][out]
  float *dw0, *dw1, *dwf, *dwa, *dwr;  // [176][128] [128][128] [128][64] [128] [64][3]
  float *db0, *db1, *dbf, *dba, *dbr;  // [128] [128] [64] [1] [3]
};

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Rows of x (type T, W wide) into the first W columns of a float tile; rows
// at or past `valid` are zero.
template <int W = FIN>
__device__ __forceinline__ void load_rows(float* X, const float* __restrict__ x,
                                          int valid) {
  for (int i = threadIdx.x; i < TM * (W / 4); i += NT) {
    const int r = i / (W / 4), c = (i % (W / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      v = __ldg(reinterpret_cast<const float4*>(x + size_t(r) * W + c));
    *reinterpret_cast<float4*>(X + r * LDX + c) = v;
  }
}

__device__ __forceinline__ void load_rows(float* X, const bf16* __restrict__ x,
                                          int valid) {
  for (int i = threadIdx.x; i < TM * (FIN / 8); i += NT) {
    const int r = i / (FIN / 8), c = (i % (FIN / 8)) * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < valid) {
      const uint4 u =
          __ldg(reinterpret_cast<const uint4*>(x + size_t(r) * FIN + c));
      const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
    }
    float* o = X + r * LDX + c;
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Posenc column j (of NPE) of the point p[0..2]: frequency f = j / 6, sin or
// sin(+ pi/2) by j / 3 % 2, coordinate j % 3. The product by 2^f is exact;
// the sum with pi/2 rounds to float32 before the sine, as in the twin.
__device__ __forceinline__ float posenc(const float* p, int j) {
  const float ang = __fmul_rn(p[j % 3], float(1 << (j / 6)));
  return sinf((j / 3) & 1 ? __fadd_rn(ang, 1.5707963267948966f) : ang);
}

// The PE loader of the float32 engine: the tile's points [rows][3] (one
// contiguous block) into P [TM][3], its feature rows [rows][FEAT] into X's
// first FEAT columns, then posenc into X's last NPE columns. Rows at or past
// `valid` are zero. All threads call it: it has a barrier.
__device__ __forceinline__ void load_pe_rows(float* X, float* P,
                                             const float* __restrict__ pts,
                                             const float* __restrict__ feat,
                                             int valid) {
  for (int i = threadIdx.x; i < TM * 3; i += NT)
    P[i] = i < 3 * valid ? __ldg(pts + i) : 0.f;
  load_rows<FEAT>(X, feat, valid);
  __syncthreads();  // the points are staged
  for (int i = threadIdx.x; i < TM * NPE; i += NT) {
    const int r = i / NPE, j = i % NPE;
    X[r * LDX + FEAT + j] = r < valid ? posenc(P + 3 * r, j) : 0.f;
  }
}

// The PE loader of the tensor-core engine, for one warp's 16 rows of the
// tile that starts at point pt0: points staged in P [16][3], feature rows
// [FEAT] bf16 copied 16 bytes a lane, posenc written as bf16 after them.
// Rows at or past `valid` are zero.
__device__ void pe_inputs(unsigned char* smem, const Layout& L,
                          const bf16* __restrict__ feat,
                          const float* __restrict__ pts, long pt0, int valid,
                          int warp, int lane) {
  bf16* sX = reinterpret_cast<bf16*>(smem + L.x) + warp * 16 * L.ldx;
  float* P = reinterpret_cast<float*>(smem + L.extra) + warp * 16 * 3;
  const long p0 = pt0 + warp * 16;
  const int rows = max(0, min(16, valid - warp * 16));
  for (int i = lane; i < 16 * 3; i += 32)
    P[i] = i < 3 * rows ? pts[p0 * 3 + i] : 0.f;
  constexpr int nch = FEAT / 8;  // 16-byte chunks a row
  for (int i = lane; i < 16 * nch; i += 32) {
    const int row = i / nch, ch = i % nch;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows)
      v = *reinterpret_cast<const uint4*>(feat + (p0 + row) * FEAT + ch * 8);
    *reinterpret_cast<uint4*>(sX + row * L.ldx + ch * 8) = v;
  }
  __syncwarp();  // the points are staged
  for (int i = lane; i < 16 * NPE; i += 32) {
    const int row = i / NPE, j = i % NPE;
    sX[row * L.ldx + FEAT + j] =
        __float2bfloat16(row < rows ? posenc(P + 3 * row, j) : 0.f);
  }
}

// One chunk of a k-major weight W[K][N] in device memory: rows k0 .. k0+KC,
// NG*64 columns (zero past N), rounded to T. A thread carries NG float4.
template <typename T, int NG>
__device__ __forceinline__ void chunk_load(float4 (&pre)[NG],
                                           const float* __restrict__ W, int N,
                                           int k0) {
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int i = threadIdx.x + j * NT;
    const int kk = i / (NG * 16), col = (i % (NG * 16)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < N)
      v = __ldg(reinterpret_cast<const float4*>(W + size_t(k0 + kk) * N + col));
    pre[j] = make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
  }
}

template <int NG>
__device__ __forceinline__ void chunk_store(const float4 (&pre)[NG], float* Ws) {
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int i = threadIdx.x + j * NT;
    const int kk = i / (NG * 16), col = (i % (NG * 16)) * 4;
    *reinterpret_cast<float4*>(Ws + kk * LDW + col) = pre[j];
  }
}

// acc[i][4g + c] = sum over k < K of A[ty*4 + i][k] * W[k][g*64 + tx*4 + c]
// for the block's TM x (NG*64) output. A is a shared-memory tile (row stride
// lda), W a k-major weight in device memory, staged through Ws. The first
// barrier also publishes the tile that the caller has just written.
template <typename T, int NG>
__device__ __forceinline__ void gemm_nn(float (&acc)[4][4 * NG], const float* As,
                                        int lda, int K,
                                        const float* __restrict__ W, int N,
                                        float* Ws) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
  float4 pre[NG];
  chunk_load<T, NG>(pre, W, N, 0);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the chunk before has been read
    chunk_store<NG>(pre, Ws);
    __syncthreads();
    if (k0 + KC < K) chunk_load<T, NG>(pre, W, N, k0 + KC);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            As + (ty * 4 + i) * lda + k0 + kk);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 b = *reinterpret_cast<const float4*>(
              Ws + (kk + q) * LDW + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * g + 0] = fmaf(a[i][q], b.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(a[i][q], b.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(a[i][q], b.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(a[i][q], b.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }
}

// dW[i*16 + ty][g*64 + tx*4 + c] += sum over the tile's rows r of
// A[r][i*16 + ty] * B[r][g*64 + tx*4 + c]: a weight gradient's share of one
// tile, contracted in registers and added to device memory with atomics.
// dW is [KI*16][NG*64].
template <int KI, int NG>
__device__ __forceinline__ void gemm_tn(const float* As, int lda,
                                        const float* Bs, int ldb,
                                        float* __restrict__ dW) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[KI][4 * NG];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int r = 0; r < TM; ++r) {
    float a[KI];
#pragma unroll
    for (int i = 0; i < KI; ++i) a[i] = As[r * lda + i * 16 + ty];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 b =
          *reinterpret_cast<const float4*>(Bs + r * ldb + g * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        acc[i][4 * g + 0] = fmaf(a[i], b.x, acc[i][4 * g + 0]);
        acc[i][4 * g + 1] = fmaf(a[i], b.y, acc[i][4 * g + 1]);
        acc[i][4 * g + 2] = fmaf(a[i], b.z, acc[i][4 * g + 2]);
        acc[i][4 * g + 3] = fmaf(a[i], b.w, acc[i][4 * g + 3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        atomicAdd(dW + (i * 16 + ty) * (NG * 64) + g * 64 + tx * 4 + c,
                  acc[i][4 * g + c]);
}

// Out[r][col] = rnd(relu(acc + bias)) over the block's TM x 128 output.
template <typename T>
__device__ __forceinline__ void store_relu(const float (&acc)[4][8],
                                           const float* __restrict__ bias,
                                           float* Out, int ldo) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int col = g * 64 + tx * 4;
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(Out + (ty * 4 + i) * ldo + col) = make_float4(
          rnd<T>(fmaxf(acc[i][4 * g + 0] + b.x, 0.f)),
          rnd<T>(fmaxf(acc[i][4 * g + 1] + b.y, 0.f)),
          rnd<T>(fmaxf(acc[i][4 * g + 2] + b.z, 0.f)),
          rnd<T>(fmaxf(acc[i][4 * g + 3] + b.w, 0.f)));
  }
}

// The cotangent of a hidden layer: da = acc (+ the density head's share)
// where the activation Hd was positive, else 0. Its column sums, before
// rounding, go to the bias sums sB; rnd(da) replaces Hd in place (each
// element is read and written by one thread).
template <typename T>
__device__ __forceinline__ void mask_store(const float (&acc)[4][8],
                                           const float* dsig, int ldsig,
                                           const float* __restrict__ wa,
                                           float* Hd, int ldh, float* sB) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = g * 64 + tx * 4 + c;
      const float w = dsig ? rnd<T>(__ldg(wa + col)) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float v = acc[i][4 * g + c];
        if (dsig) v = fmaf(dsig[r * ldsig], w, v);
        v = Hd[r * ldh + col] > 0.f ? v : 0.f;
        sum += v;
        Hd[r * ldh + col] = rnd<T>(v);
      }
      atomicAdd(sB + col, sum);
    }
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(bf16* p, float a, float b, float c,
                                       float d) {
  bf162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---------------------------------------------------------------------------
// forward, float32
// ---------------------------------------------------------------------------

// PE: x is the plane features [N][FEAT] and aux the points [N][3].
template <typename T, In IN>
__global__ void __launch_bounds__(NT, 2)
mlp_fwd_kernel(const T* __restrict__ x, const float* __restrict__ aux,
               Params p, float* __restrict__ out, long long N) {
  extern __shared__ __align__(16) float sm[];
  float* X = sm;             // x, then h1
  float* H = X + TM * LDX;   // h0, then rnd(feat) with row stride LDD
  float* Ws = H + TM * LDH;
  float* Ex = Ws + KC * LDW;  // PE: the tile's points
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long ntiles = (N + TM - 1) / TM;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TM;
    const int valid = int(N - row0 < TM ? N - row0 : TM);
    __syncthreads();  // the tile before is done with X, H and Ex
    if constexpr (IN == In::PE)
      load_pe_rows(X, Ex, aux + row0 * 3, x + row0 * FEAT, valid);
    else
      load_rows(X, x + row0 * FIN, valid);
    float acc[4][8];
    gemm_nn<T, 2>(acc, X, LDX, FIN, p.w0_kn, HID, Ws);
    store_relu<T>(acc, p.b0, H, LDH);
    gemm_nn<T, 2>(acc, H, LDH, HID, p.w1_kn, HID, Ws);
    store_relu<T>(acc, p.b1, X, LDX);
    float accf[4][4];
    gemm_nn<T, 1>(accf, X, LDX, HID, p.wf_kn, CF, Ws);
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
          H[r * LDD + col + c] = rnd<T>(v);
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
        s = fmaf(X[r * LDX + q + 4 * j], rnd<T>(__ldg(p.wa + q + 4 * j)), s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0 && r < valid)
        out[(row0 + r) * NOUT + 3 + CF] = s + __ldg(p.ba);
    }
    if (tid < TM * 3) {  // rgb = rnd(feat) . wr + br
      const int r = tid / 3, c = tid % 3;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < CF; ++k)
        s = fmaf(H[r * LDD + k], rnd<T>(__ldg(p.wr + c * CF + k)), s);
      if (r < valid) out[(row0 + r) * NOUT + c] = s + __ldg(p.br + c);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, float32 or bf16 x
// ---------------------------------------------------------------------------

// dx [N][FIN] is written in T.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
mlp_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g, Params p,
               T* __restrict__ dx, Grads gr, long long N) {
  extern __shared__ __align__(16) float sm[];
  float* X = sm;               // x
  float* H0 = X + TM * LDX;    // h0, then da0
  float* H1 = H0 + TM * LDH;   // h1, then da1
  float* D = H1 + TM * LDH;    // rnd(feat), then rnd(dfa) [TM][65]
  float* G = D + TM * LDD;     // g [TM][68]
  float* Ws = G + TM * LDD;
  float* sB0 = Ws + KC * LDW;  // bias-gradient sums over this block's tiles
  float* sB1 = sB0 + HID;
  float* sBh = sB1 + HID;      // [65]
  float* sBr = sBh + LDD;      // [3]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int i = tid; i < kBiasFloats; i += NT) sB0[i] = 0.f;
  const long long ntiles = (N + TM - 1) / TM;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TM;
    const int valid = int(N - row0 < TM ? N - row0 : TM);
    __syncthreads();  // the tile before is done with every buffer
    load_rows(X, x + row0 * FIN, valid);
    for (int i = tid; i < TM * (NOUT / 4); i += NT) {
      const int r = i / (NOUT / 4), c = (i % (NOUT / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < valid)
        v = __ldg(reinterpret_cast<const float4*>(g + (row0 + r) * NOUT + c));
      *reinterpret_cast<float4*>(G + r * LDD + c) = v;
    }

    // --- the forward again: h0, h1, rnd(feat)
    float acc[4][8];
    gemm_nn<T, 2>(acc, X, LDX, FIN, p.w0_kn, HID, Ws);
    store_relu<T>(acc, p.b0, H0, LDH);
    gemm_nn<T, 2>(acc, H0, LDH, HID, p.w1_kn, HID, Ws);
    store_relu<T>(acc, p.b1, H1, LDH);
    {
      float accf[4][4];
      gemm_nn<T, 1>(accf, H1, LDH, HID, p.wf_kn, CF, Ws);
      const int col = tx * 4;
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.bf + col));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store4(D + (ty * 4 + i) * LDD + col, rnd<T>(accf[i][0] + b.x),
               rnd<T>(accf[i][1] + b.y), rnd<T>(accf[i][2] + b.z),
               rnd<T>(accf[i][3] + b.w));
    }
    __syncthreads();

    // --- fc_rgb: dwr[k][c] += sum_r feat[r][k] * rnd(g_rgb[r][c])
    if (tid < CF * 3) {
      const int k = tid / 3, c = tid % 3;
      float s = 0.f;
      for (int r = 0; r < TM; ++r)
        s = fmaf(D[r * LDD + k], rnd<T>(G[r * LDD + c]), s);
      atomicAdd(gr.dwr + tid, s);
    } else if (tid < CF * 3 + 3) {
      const int c = tid - CF * 3;
      float s = 0.f;
      for (int r = 0; r < TM; ++r) s += G[r * LDD + c];
      sBr[c] += s;  // this thread alone owns sBr[c]
    }
    __syncthreads();

    // --- dfa = [g_feat + g_rgb . wr^T | g_sigma]: sums before rounding
    {
      const int c = tid & 63;  // one column a thread: NT % 64 == 0
      const float w0 = rnd<T>(__ldg(p.wr + c)),
                  w1 = rnd<T>(__ldg(p.wr + CF + c)),
                  w2 = rnd<T>(__ldg(p.wr + 2 * CF + c));
      float sum = 0.f;
      for (int r = tid >> 6; r < TM; r += NT / 64) {
        const float* grow = G + r * LDD;
        const float v =
            grow[3 + c] + grow[0] * w0 + grow[1] * w1 + grow[2] * w2;
        sum += v;
        D[r * LDD + c] = rnd<T>(v);
      }
      atomicAdd(sBh + c, sum);
      if (tid < TM) {
        const float v = G[tid * LDD + 3 + CF];
        D[tid * LDD + CF] = rnd<T>(v);
        atomicAdd(sBh + CF, v);
      }
    }
    __syncthreads();

    // --- heads: dwf += h1^T dfeat, dwa += h1^T dsigma; dh1 -> da1 in place
    gemm_tn<HID / 16, 1>(H1, LDH, D, LDD, gr.dwf);
    if (tid < HID) {
      float s = 0.f;
      for (int r = 0; r < TM; ++r)
        s = fmaf(H1[r * LDH + tid], D[r * LDD + CF], s);
      atomicAdd(gr.dwa + tid, s);
    }
    gemm_nn<T, 2>(acc, D, LDD, CF, p.wf, HID, Ws);
    mask_store<T>(acc, D + CF, LDD, p.wa, H1, LDH, sB1);
    __syncthreads();

    // --- layer1: dw1 += h0^T da1; dh0 -> da0 in place
    gemm_tn<HID / 16, 2>(H0, LDH, H1, LDH, gr.dw1);
    gemm_nn<T, 2>(acc, H1, LDH, HID, p.w1, HID, Ws);
    mask_store<T>(acc, nullptr, 0, nullptr, H0, LDH, sB0);
    __syncthreads();

    // --- layer0: dw0 += x^T da0; dx = da0 . w0^T
    gemm_tn<FIN / 16, 2>(X, LDX, H0, LDH, gr.dw0);
    float acc3[4][12];
    gemm_nn<T, 3>(acc3, H0, LDH, HID, p.w0, FIN, Ws);
    // gemm_nn's barriers have seen every thread past gemm_tn's reads of X
#pragma unroll
    for (int gq = 0; gq < 3; ++gq) {
      const int col = gq * 64 + tx * 4;
      if (col < FIN) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          if (r < valid)
            store4(dx + (row0 + r) * FIN + col, acc3[i][4 * gq + 0],
                   acc3[i][4 * gq + 1], acc3[i][4 * gq + 2],
                   acc3[i][4 * gq + 3]);
        }
      }
    }
  }
  __syncthreads();
  if (tid < HID) {
    atomicAdd(gr.db0 + tid, sB0[tid]);
    atomicAdd(gr.db1 + tid, sB1[tid]);
  }
  if (tid < CF) atomicAdd(gr.dbf + tid, sBh[tid]);
  if (tid == CF) atomicAdd(gr.dba, sBh[CF]);
  if (tid < 3) atomicAdd(gr.dbr + tid, sBr[tid]);
}

// ---------------------------------------------------------------------------
// forward, bf16: the march kernels' tensor-core chain, rows written out
// ---------------------------------------------------------------------------

// PE: x is the plane features [N][FEAT] bf16 and aux the points [N][3] f32
// (pe_inputs).
template <int H, int CFT, In IN>
__global__ void __launch_bounds__(kThreads, 1)
mlp_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ aux,
                   Weights w, float* __restrict__ out, long long N, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* sF = reinterpret_cast<const float*>(smem + L.h);
  const float* sSig = reinterpret_cast<const float*>(smem + L.sig);
  const float* sRgb = reinterpret_cast<const float*>(smem + L.rgb);
  const long long ntiles = (N + kPoints - 1) / kPoints;

  stage_weights<H, CFT>(smem, L, w);
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long pt0 = tile * kPoints;
    const int valid = int(N - pt0 < kPoints ? N - pt0 : kPoints);
    __syncthreads();  // weights staged
    if constexpr (IN == In::PE)
      pe_inputs(smem, L, x, aux, long(pt0), valid, warp, lane);
    else
      copy_inputs(smem, L, x, long(pt0), valid, warp, lane);
    __syncwarp();
    mlp_rows<H, CFT>(smem, L, warp, lane);
    __syncwarp();
    // a warp's 16 rows are one contiguous span of the output
    const int rows = min(16, valid - warp * 16);
    float* o = out + (pt0 + warp * 16) * (CFT + 4);
    for (int i = lane; i < rows * (CFT + 4); i += 32) {
      const int pr = warp * 16 + i / (CFT + 4), c = i % (CFT + 4);
      o[i] = c < 3 ? sRgb[pr * 3 + c]
                   : c < 3 + CFT ? sF[pr * L.ldf + c - 3] : sSig[pr];
    }
    __syncwarp();  // the rows are read before the next tile overwrites them
  }
}

bool widths_ok(int fin, int hid, int cf) {
  return fin == FIN && hid == HID && cf == CF;
}

template <In IN>
int launch_fwd_f32(const float* x, const float* aux, const Params& p,
                   float* out, long long N, void* stream) {
  auto kern = mlp_fwd_kernel<float, IN>;
  const size_t bytes = size_t(kFwdFloats + extra_floats(IN)) * 4;
  int grid = 0;
  cudaError_t e = launch_config(kern, NT, bytes, (N + TM - 1) / TM, &grid);
  if (e != cudaSuccess) return int(e);
  kern<<<grid, NT, bytes, (cudaStream_t)stream>>>(x, aux, p, out, N);
  return int(cudaGetLastError());
}

template <In IN>
int launch_fwd_mma(const bf16* x, const float* aux, const Weights& w,
                   float* out, long long N, const Layout& L, void* stream) {
  auto kern = mlp_fwd_mma_kernel<HID, CF, IN>;
  int grid = 0;
  cudaError_t e = launch_config(kern, kThreads, L.total,
                                (N + kPoints - 1) / kPoints, &grid);
  if (e != cudaSuccess) return int(e);
  kern<<<grid, kThreads, L.total, (cudaStream_t)stream>>>(x, aux, w, out, N,
                                                          L);
  return int(cudaGetLastError());
}

template <typename T>
int launch_bwd(const T* x, const float* g, const Params& p, T* dx,
               const Grads& gr, long long N, void* stream) {
  auto kern = mlp_bwd_kernel<T>;
  const size_t bytes = size_t(kBwdFloats) * 4;
  int grid = 0;
  cudaError_t e = launch_config(kern, NT, bytes, (N + TM - 1) / TM, &grid);
  if (e != cudaSuccess) return int(e);
  kern<<<grid, NT, bytes, (cudaStream_t)stream>>>(x, g, p, dx, gr, N);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mlp_error_string(int e) {
  return cudaGetErrorString(cudaError_t(e));
}

// x [N][176] f32 -> out [N][68] f32. Weights f32: w*_kn as [in][out].
int mlp_forward_f32(const void* x, const void* w0_kn, const void* w1_kn,
                    const void* wf_kn, const void* wa, const void* wr,
                    const void* b0, const void* b1, const void* bf,
                    const void* ba, const void* br, void* out, long long N,
                    int fin, int hid, int cf, void* stream) {
  if (!widths_ok(fin, hid, cf) || N < 0) return int(cudaErrorInvalidValue);
  if (N == 0) return int(cudaSuccess);
  Params p{};
  p.w0_kn = (const float*)w0_kn; p.w1_kn = (const float*)w1_kn;
  p.wf_kn = (const float*)wf_kn; p.wa = (const float*)wa;
  p.wr = (const float*)wr; p.b0 = (const float*)b0; p.b1 = (const float*)b1;
  p.bf = (const float*)bf; p.ba = (const float*)ba; p.br = (const float*)br;
  return launch_fwd_f32<In::X>((const float*)x, nullptr, p, (float*)out, N,
                               stream);
}

// x [N][176] bf16 -> out [N][68] f32. Weights bf16 as [out][in] (wh stacks
// fc_rgbFeat's 64 rows and fc_alpha's row), biases f32.
int mlp_forward_bf16(const void* x, const void* w0, const void* b0,
                     const void* w1, const void* b1, const void* wh,
                     const void* bh, const void* wr, const void* br,
                     void* out, long long N, int fin, int hid, int cf,
                     void* stream) {
  if (!widths_ok(fin, hid, cf) || N < 0) return int(cudaErrorInvalidValue);
  if (N == 0) return int(cudaSuccess);
  const Layout L = make_layout<HID, CF>(fin, 0);
  const Weights w{(const bf16*)w0, (const bf16*)w1, (const bf16*)wh,
                  (const bf16*)wr, (const float*)b0, (const float*)b1,
                  (const float*)bh, (const float*)br};
  return launch_fwd_mma<In::X>((const bf16*)x, nullptr, w, (float*)out, N, L,
                               stream);
}

// x [N][176] (f32, or bf16 when x_is_bf16), g [N][68] f32 -> dx in x's
// type and the float32 gradients, which the caller has zeroed. Weights f32
// in both layouts; the kernel rounds them to x's type.
int mlp_backward(const void* x, const void* g, const void* w0_kn,
                 const void* w1_kn, const void* wf_kn, const void* w0,
                 const void* w1, const void* wf, const void* wa,
                 const void* wr, const void* b0, const void* b1,
                 const void* bf, void* dx, void* dw0, void* dw1, void* dwf,
                 void* dwa, void* dwr, void* db0, void* db1, void* dbf,
                 void* dba, void* dbr, long long N, int fin, int hid, int cf,
                 int x_is_bf16, void* stream) {
  if (!widths_ok(fin, hid, cf) || N < 0) return int(cudaErrorInvalidValue);
  if (N == 0) return int(cudaSuccess);
  Params p{};
  p.w0_kn = (const float*)w0_kn; p.w1_kn = (const float*)w1_kn;
  p.wf_kn = (const float*)wf_kn; p.w0 = (const float*)w0;
  p.w1 = (const float*)w1; p.wf = (const float*)wf; p.wa = (const float*)wa;
  p.wr = (const float*)wr; p.b0 = (const float*)b0; p.b1 = (const float*)b1;
  p.bf = (const float*)bf;
  const Grads gr{(float*)dw0, (float*)dw1, (float*)dwf, (float*)dwa,
                 (float*)dwr, (float*)db0, (float*)db1, (float*)dbf,
                 (float*)dba, (float*)dbr};
  if (x_is_bf16)
    return launch_bwd((const bf16*)x, (const float*)g, p, (bf16*)dx, gr, N,
                      stream);
  return launch_bwd((const float*)x, (const float*)g, p, (float*)dx, gr, N,
                    stream);
}

// pts [N][3] f32 and plane features [N][128] f32 -> out [N][68] f32: posenc
// of the points (num_freqs 8) in the kernel, then the chain on [feat |
// posenc]. Weights as for mlp_forward_f32, w0_kn's 176 input rows in the
// reference's order.
int field_eval_f32(const void* pts, const void* feat, const void* w0_kn,
                   const void* w1_kn, const void* wf_kn, const void* wa,
                   const void* wr, const void* b0, const void* b1,
                   const void* bf, const void* ba, const void* br, void* out,
                   long long N, int feat_in, int num_freqs, int hid, int cf,
                   void* stream) {
  if (!widths_ok(feat_in + 6 * num_freqs, hid, cf) || feat_in != FEAT ||
      num_freqs != NFREQ || N < 0)
    return int(cudaErrorInvalidValue);
  if (N == 0) return int(cudaSuccess);
  Params p{};
  p.w0_kn = (const float*)w0_kn; p.w1_kn = (const float*)w1_kn;
  p.wf_kn = (const float*)wf_kn; p.wa = (const float*)wa;
  p.wr = (const float*)wr; p.b0 = (const float*)b0; p.b1 = (const float*)b1;
  p.bf = (const float*)bf; p.ba = (const float*)ba; p.br = (const float*)br;
  return launch_fwd_f32<In::PE>((const float*)feat, (const float*)pts, p,
                                (float*)out, N, stream);
}

// pts [N][3] f32 and plane features [N][128] bf16 -> out [N][68] f32.
// Weights as for mlp_forward_bf16, w0's 176 input columns in the
// reference's order.
int field_eval_bf16(const void* pts, const void* feat, const void* w0,
                    const void* b0, const void* w1, const void* b1,
                    const void* wh, const void* bh, const void* wr,
                    const void* br, void* out, long long N, int feat_in,
                    int num_freqs, int hid, int cf, void* stream) {
  if (!widths_ok(feat_in + 6 * num_freqs, hid, cf) || feat_in != FEAT ||
      num_freqs != NFREQ || N < 0)
    return int(cudaErrorInvalidValue);
  if (N == 0) return int(cudaSuccess);
  const Layout L = make_layout<HID, CF>(FIN, size_t(kPoints) * 3 * 4);
  const Weights w{(const bf16*)w0, (const bf16*)w1, (const bf16*)wh,
                  (const bf16*)wr, (const float*)b0, (const float*)b1,
                  (const float*)bh, (const float*)br};
  return launch_fwd_mma<In::PE>((const bf16*)feat, (const float*)pts, w,
                                (float*)out, N, L, stream);
}

}  // extern "C"
