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
// backward. In float32 the products bound both: on split TF32 (three TF32
// tensor-core products for one, 495/3 TFLOP/s) or on FFMA (67 TFLOP/s). In
// bf16 on the tensor cores (989 TFLOP/s) the forward is bound by its bytes.
//
// What the design does about it:
//  * backward, both types: the body of csrc/chain_bwd.cuh, shared with the
//    quad op's backward (csrc/quad.cu). This file supplies its prologue
//    (load_rows: a tile's x rows into shared memory) and its epilogue
//    (store_rows: the tile's dx rows in x's type). A persistent block walks
//    over 64-row (float32) or 128-row (bf16) tiles; the activations stay in
//    shared memory, so the only device-memory traffic is x, g and dx, the
//    weights from L2 and the block's gradient partial. Weight
//    gradients go into per-block partials summed in block order, without
//    atomics: two launches give the same gradients bit for bit. bf16 runs
//    every product on mma.sync m16n8k16 bf16; float32 recomputes h0, h1 and
//    feat on FFMA (their ReLU masks must be the twin's) and runs the
//    transposed chain and the weight gradients on split TF32.
//  * forward, float32: the five products' three wide ones on split TF32
//    (chain_bwd.cuh's tc::gemm_nn) on 64-row tiles, activations in shared
//    memory (80 KB: two blocks an SM), the weights split once a call into
//    fragment order and read from L2, one float4 a lane and 8 x 8 block;
//    the density and colour heads (129 + 192 multiply-adds a row) on FFMA.
//    No gradient depends on the forward's masks: the backward recomputes
//    its own. The out rows are gathered in shared memory and written with
//    coalesced 16-byte stores.
//  * a ragged N is masked in the kernel: rows past the end load zeros, write
//    nothing, and contribute nothing to any gradient.
//  * bf16 forward: the tensor-core chain that the march kernels run
//    (field_mlp.cuh), with the [rgb | feat | sigma] rows written out instead
//    of composited.
//  * field_eval entry points: the forward engines with a second input mode,
//    PE. The float32 one runs its products on FFMA (csrc/ffma.cuh, weights
//    streamed from L2 through two cp.async stages): through split TF32 its
//    posenc columns would not come out of identity weights bit for bit.
//    Their input is the points [N, 3] f32 and the plane features [N, 128]
//    (f32 for the FFMA forward, bf16 for the tensor-core one); the
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

#include "chain_bwd.cuh"

namespace {

// the field_eval entry points: posenc columns, plane features a row, posenc
// frequencies
constexpr int NPE = 48, FEAT = FIN - NPE, NFREQ = NPE / 6;

// What a forward's input rows are: x [N][FIN]; or plane features [N][FEAT]
// with the points [N][3] (PE).
enum class In { X, PE };

// float32 forward: x/h1 [TM][LDX] | h0, then the out rows [TM][NOUT] |
// (FFMA) two weight stages | (PE) the tile's points [TM][3]
constexpr int kFwdFloats = TM * LDX + TM * LDH;
constexpr int kPeFloats = TM * 3;

constexpr size_t fwd_bytes(In in, bool split) {
  return size_t(kFwdFloats + (split ? 0 : kStageFloats) +
                (in == In::PE ? kPeFloats : 0)) * 4;
}

// The float32 forward's weights: W^T [in][out] of layer0, layer1 and the
// feature head (split TF32: in fragment order, ops/mlp.py:_tf32_frags;
// FFMA: as they are), then fc_alpha [128], fc_rgb [3][64] and the biases,
// f32.
struct FwdParams {
  const float *w0_kn, *w1_kn, *wf_kn;
  const float *wa, *wr, *b0, *b1, *bf, *ba, *br;
};

// Rows of x (type T, W wide) into the first W columns of a float tile; rows
// at or past `valid` are zero. Streamed (read once: evict first).
template <int W = FIN>
__device__ __forceinline__ void load_rows(float* X, const float* __restrict__ x,
                                          int valid) {
  for (int i = threadIdx.x; i < TM * (W / 4); i += NT) {
    const int r = i / (W / 4), c = (i % (W / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      v = __ldcs(reinterpret_cast<const float4*>(x + size_t(r) * W + c));
    *reinterpret_cast<float4*>(X + r * LDX + c) = v;
  }
}

// bf16 x rows into the backward's bf16 tile (Tile<bf16>), 16 bytes a copy.
__device__ __forceinline__ void load_rows(bf16* X, const bf16* __restrict__ x,
                                          int valid) {
  constexpr int C = FIN / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < Tile<bf16>::M * C; i += NT) {
    const int r = i / C, c = (i % C) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      v = __ldcs(reinterpret_cast<const uint4*>(x + size_t(r) * FIN + c));
    *reinterpret_cast<uint4*>(X + r * Tile<bf16>::LDX + c) = v;
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

// Streamed stores (written once: evict first).
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

__device__ __forceinline__ void store4(bf16* p, float a, float b, float c,
                                       float d) {
  bf162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), u);
}

// ---------------------------------------------------------------------------
// forward, float32: split TF32 on the tensor cores
// ---------------------------------------------------------------------------

// PE: x is the plane features [N][FEAT] and aux the points [N][3]. kSplit:
// the three wide products on split TF32, else on FFMA (csrc/ffma.cuh).
template <In IN, bool kSplit>
__global__ void __launch_bounds__(NT, 2)
mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ aux,
               FwdParams p, float* __restrict__ out, long long N) {
  extern __shared__ __align__(16) float sm[];
  float* X = sm;             // x, then h1
  float* H = X + TM * LDX;   // h0, then the out rows O [TM][NOUT]
  float* O = H;
  float* Ws = H + TM * LDH;  // FFMA: two weight stages
  float* Ex = Ws + (kSplit ? 0 : kStageFloats);  // PE: the tile's points
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const long long ntiles = (N + TM - 1) / TM;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * TM;
    const int valid = int(N - row0 < TM ? N - row0 : TM);
    __syncthreads();  // the tile before is done with X, H and Ex
    if constexpr (IN == In::PE)
      load_pe_rows(X, Ex, aux + row0 * 3, x + row0 * FEAT, valid);
    else
      load_rows(X, x + row0 * FIN, valid);
    if constexpr (kSplit) {  // a warp owns 16 columns of h0 and h1, 8 of feat
      const float4* w0 = reinterpret_cast<const float4*>(p.w0_kn);
      const float4* w1 = reinterpret_cast<const float4*>(p.w1_kn);
      const float4* wf = reinterpret_cast<const float4*>(p.wf_kn);
      __syncthreads();
      float acc[4][2][4];
      tc::gemm_nn<4, 2>(acc, X, LDX, FIN / 8, w0, HID / 8, 2 * warp);
      tc::store_relu<float>(acc, p.b0, H, LDH, 2 * warp);
      __syncthreads();
      tc::gemm_nn<4, 2>(acc, H, LDH, HID / 8, w1, HID / 8, 2 * warp);
      tc::store_relu<float>(acc, p.b1, X, LDX, 2 * warp);  // X: read above
      __syncthreads();
      float accf[4][1][4];
      tc::gemm_nn<4, 1>(accf, X, LDX, HID / 8, wf, CF / 8, warp);
      // feat + bf into O (H was read above, before the barrier)
      const int col = 8 * warp + 2 * t;
      const float b0 = __ldg(p.bf + col), b1 = __ldg(p.bf + col + 1);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float* o = O + (16 * m + gq + 8 * v) * NOUT + 3 + col;
          o[0] = accf[m][0][2 * v] + b0;
          o[1] = accf[m][0][2 * v + 1] + b1;
        }
    } else {  // a thread owns a 4 x 8 block of h0 and h1, 4 x 4 of feat;
      // each product's first barrier publishes what the last one wrote
      const int ty = tid >> 4, tx = tid & 15;
      float acc[4][8];
      ffma_engine::gemm_nn<2>(acc, X, LDX, FIN, p.w0_kn, HID, Ws);
      ffma_engine::store_relu(acc, p.b0, H, LDH);
      ffma_engine::gemm_nn<2>(acc, H, LDH, HID, p.w1_kn, HID, Ws);
      ffma_engine::store_relu(acc, p.b1, X, LDX);
      float accf[4][4];
      ffma_engine::gemm_nn<1>(accf, X, LDX, HID, p.wf_kn, CF, Ws);
      const int col = tx * 4;
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.bf + col));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* o = O + (ty * 4 + i) * NOUT + 3 + col;
        o[0] = accf[i][0] + b.x;
        o[1] = accf[i][1] + b.y;
        o[2] = accf[i][2] + b.z;
        o[3] = accf[i][3] + b.w;
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
      if (q == 0) O[r * NOUT + 3 + CF] = s + __ldg(p.ba);
    }
    if (tid < TM * 3) {  // rgb = feat . wr + br
      const int r = tid / 3, c = tid % 3;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < CF; ++k)
        s = fmaf(O[r * NOUT + 3 + k], __ldg(p.wr + c * CF + k), s);
      O[r * NOUT + c] = s + __ldg(p.br + c);
    }
    __syncthreads();
    // the tile's valid rows are one contiguous span of out
    float4* o4 = reinterpret_cast<float4*>(out + row0 * NOUT);
    const float4* s4 = reinterpret_cast<const float4*>(O);
    for (int i = tid; i < valid * (NOUT / 4); i += NT) __stcs(o4 + i, s4[i]);
  }
}

// ---------------------------------------------------------------------------
// backward, float32 or bf16 x: the shared body (chain_bwd.cuh) between the
// loads of x's rows and the stores of dx's. part: this launch's per-block
// partials [gridDim.x][NGRAD], zeroed by the caller.
// ---------------------------------------------------------------------------

// The tile's dx rows [valid][FIN] in T from the f32 tile Dx.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dx, const float* Dx,
                                           int valid) {
  for (int i = threadIdx.x; i < valid * (FIN / 4); i += NT) {
    const int r = i / (FIN / 4), c = (i % (FIN / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(Dx + r * LDXF + c);
    store4(dx + size_t(r) * FIN + c, v.x, v.y, v.z, v.w);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
mlp_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
               Params<T> p, T* __restrict__ dx, float* __restrict__ part,
               long long N) {
  extern __shared__ __align__(16) unsigned char smem[];
  chain_bwd<T>(
      smem, p, g, part, N,
      [&](const BwdSmem<T>& s, long long row0, int valid) {
        load_rows(s.X, x + row0 * FIN, valid);
      },
      [&](const BwdSmem<T>& s, long long row0, int valid) {
        store_rows(dx + row0 * FIN, s.Dx, valid);
      });
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
  const float* F = reinterpret_cast<const float*>(warp_rows(smem, L, warp));
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
    mlp_warp<H, CFT>(smem, L, warp, lane);
    __syncwarp();
    // a warp's 16 rows are one contiguous span of the output
    const int rows = min(16, valid - warp * 16);
    float* o = out + (pt0 + warp * 16) * (CFT + 4);
    for (int i = lane; i < rows * (CFT + 4); i += 32) {
      const int r = i / (CFT + 4), pr = warp * 16 + r, c = i % (CFT + 4);
      o[i] = c < 3 ? sRgb[pr * 3 + c]
                   : c < 3 + CFT ? F[r * L.ldf + c - 3] : sSig[pr];
    }
    __syncwarp();  // the rows are read before the next tile overwrites them
  }
}

bool widths_ok(int fin, int hid, int cf) {
  return fin == FIN && hid == HID && cf == CF;
}

template <In IN, bool kSplit>
int launch_fwd_f32(const float* x, const float* aux, const FwdParams& p,
                   float* out, long long N, void* stream) {
  auto kern = mlp_fwd_kernel<IN, kSplit>;
  const size_t bytes = fwd_bytes(IN, kSplit);
  int grid = 0;
  cudaError_t e = launch_config(kern, NT, bytes, (N + TM - 1) / TM, &grid);
  if (e != cudaSuccess) return int(e);
  kern<<<grid, NT, bytes, (cudaStream_t)stream>>>(x, aux, p, out, N);
  return int(cudaGetLastError());
}

FwdParams fwd_params(const void* w0_kn, const void* w1_kn, const void* wf_kn,
                     const void* wa, const void* wr, const void* b0,
                     const void* b1, const void* bf, const void* ba,
                     const void* br) {
  return FwdParams{(const float*)w0_kn, (const float*)w1_kn,
                   (const float*)wf_kn, (const float*)wa, (const float*)wr,
                   (const float*)b0,    (const float*)b1, (const float*)bf,
                   (const float*)ba,    (const float*)br};
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

}  // namespace

extern "C" {

const char* mlp_error_string(int e) {
  return cudaGetErrorString(cudaError_t(e));
}

// x [N][176] f32 -> out [N][68] f32. Weights: w*_kn = W^T [in][out] in
// split-TF32 fragment order (ops/mlp.py:_tf32_frags), wa, wr and the biases
// f32.
int mlp_forward_f32(const void* x, const void* w0_kn, const void* w1_kn,
                    const void* wf_kn, const void* wa, const void* wr,
                    const void* b0, const void* b1, const void* bf,
                    const void* ba, const void* br, void* out, long long N,
                    int fin, int hid, int cf, void* stream) {
  if (!widths_ok(fin, hid, cf) || N < 0) return int(cudaErrorInvalidValue);
  if (N == 0) return int(cudaSuccess);
  return launch_fwd_f32<In::X, true>(
      (const float*)x, nullptr,
      fwd_params(w0_kn, w1_kn, wf_kn, wa, wr, b0, b1, bf, ba, br),
      (float*)out, N, stream);
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
  const Layout L = make_layout<HID, CF>(fin, kPoints, 0);
  const Weights w{(const bf16*)w0, (const bf16*)w1, (const bf16*)wh,
                  (const bf16*)wr, (const float*)b0, (const float*)b1,
                  (const float*)bh, (const float*)br};
  return launch_fwd_mma<In::X>((const bf16*)x, nullptr, w, (float*)out, N, L,
                               stream);
}

// The backward kernel's grid for N rows: the number of per-block partials
// [grid][47748] f32 that mlp_backward needs.
int mlp_backward_blocks(long long N, int x_is_bf16, int* grid) {
  if (N < 0) return int(cudaErrorInvalidValue);
  *grid = 0;
  if (N == 0) return int(cudaSuccess);
  return x_is_bf16 ? bwd_grid<bf16>(mlp_bwd_kernel<bf16>, N, grid)
                   : bwd_grid<float>(mlp_bwd_kernel<float>, N, grid);
}

// x [N][176] (f32, or bf16 when x_is_bf16), g [N][68] f32 -> dx in x's type
// and grads [47748] f32: the weight gradients as [in][out], then the bias
// gradients (ops/mlp.py's _GRAD_SIZES order). part [nblk][47748] f32,
// zeroed by the caller, nblk from mlp_backward_blocks. Weights as
// chain_bwd.cuh's Params take them: for f32 x, w*_kn = W^T [in][out] f32
// and w* = W [out][in] in split-TF32 fragment order (ops/mlp.py:
// _tf32_frags); for bf16 x all six in bf16 fragment order (ops/mlp.py:
// _frags); w0 padded to 192 columns. wa, wr and the biases f32, rounded to
// x's type in the kernel.
int mlp_backward(const void* x, const void* g, const void* w0_kn,
                 const void* w1_kn, const void* wf_kn, const void* w0,
                 const void* w1, const void* wf, const void* wa,
                 const void* wr, const void* b0, const void* b1,
                 const void* bf, void* dx, void* part, int nblk, void* grads,
                 long long N, int fin, int hid, int cf, int x_is_bf16,
                 void* stream) {
  if (!widths_ok(fin, hid, cf) || N < 0) return int(cudaErrorInvalidValue);
  if (N == 0) return int(cudaSuccess);
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16)
    return launch_bwd<bf16>(
        mlp_bwd_kernel<bf16>, nblk, N, (float*)part, (float*)grads, s,
        (const bf16*)x, (const float*)g,
        make_params<bf16>(w0_kn, w1_kn, wf_kn, w0, w1, wf, wa, wr, b0, b1, bf,
                          nullptr, nullptr),
        (bf16*)dx);
  return launch_bwd<float>(
      mlp_bwd_kernel<float>, nblk, N, (float*)part, (float*)grads, s,
      (const float*)x, (const float*)g,
      make_params<float>(w0_kn, w1_kn, wf_kn, w0, w1, wf, wa, wr, b0, b1, bf,
                         nullptr, nullptr),
      (float*)dx);
}

// pts [N][3] f32 and plane features [N][128] f32 -> out [N][68] f32: posenc
// of the points (num_freqs 8) in the kernel, then the chain on [feat |
// posenc]. The products on FFMA: through the split-TF32 route the posenc
// columns would not pass through identity weights bit for bit
// (tests/test_torch_field_eval_cuda.py). Weights f32: w*_kn = W^T [in][out]
// as they are, w0_kn's 176 input rows in the reference's order; wa, wr and
// the biases.
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
  return launch_fwd_f32<In::PE, false>(
      (const float*)feat, (const float*)pts,
      fwd_params(w0_kn, w1_kn, wf_kn, wa, wr, b0, b1, bf, ba, br),
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
  const Layout L =
      make_layout<HID, CF>(FIN, kPoints, size_t(kPoints) * 3 * 4);
  const Weights w{(const bf16*)w0, (const bf16*)w1, (const bf16*)wh,
                  (const bf16*)wr, (const float*)b0, (const float*)b1,
                  (const float*)bh, (const float*)br};
  return launch_fwd_mma<In::PE>((const bf16*)feat, (const float*)pts, w,
                                (float*)out, N, L, stream);
}

}  // extern "C"
