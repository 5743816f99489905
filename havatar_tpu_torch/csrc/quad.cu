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
// 4 + 4 texel rows a row. At 1,048,576 rows float32 is bound by its
// products: the forward's on FFMA (1.50 ms at 67 TFLOP/s), the backward's
// recompute on FFMA and the rest on split TF32 (2.74 ms; 4.49 all on FFMA);
// bf16 by its bytes forward (0.16 ms) and its tensor-core products backward
// (0.35 ms).
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
//  * the backward's body is the dense chain's, csrc/chain_bwd.cuh, shared
//    with csrc/mlp.cu: this file supplies its prologue (gather_rows) and its
//    epilogue (splat_rows). Weight gradients go into per-block partials
//    summed in block order, without atomics, so two launches give the same
//    gradients bit for bit. bf16 runs every product on mma.sync m16n8k16;
//    float32 recomputes h0, h1 and feat on FFMA (their ReLU masks must be
//    the twin's) and runs the transposed chain and the weight gradients on
//    split TF32 (three TF32 products for one float32 product).
//  * float32 forward: FFMA, csrc/ffma.cuh's engine, on 64-row shared-memory
//    tiles (a thread holds a 4 x 8 block of the output). The weights (190
//    KB) do not fit beside the activations, so each product streams its
//    weight from L2 in 16-row chunks through two cp.async stages: the next
//    chunk copies while this one is multiplied, one barrier a chunk. The
//    tiles (107 KB) let two blocks share an SM.
//  * bf16 forward: the tensor-core chain of field_mlp.cuh with its gather
//    input mode (gather_inputs).
//  * a ragged N is masked in the kernel: rows past the end read nothing,
//    write nothing and contribute nothing to any gradient.

#include "chain_bwd.cuh"

namespace {

constexpr int QC = 64, NPE = FIN - 2 * QC, NAUX = NPE + 8;

// float32 forward: x/h1 [TM][LDX] | h0/feat [TM][LDH] | stages | the rows'
// corner weights [TM][8] and texel bases [TM][2]
constexpr int kFwdFloats = TM * LDX + TM * LDH + kStageFloats + TM * 10;

template <typename T>
struct Planes {
  const T *xy, *zy;  // [H][W][QC]
  int W;
};

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

// The prologue of the float32 forward and of the backward: for each of the
// tile's Tile<T>::M rows, gather the 4 + 4 corner texels, corner-reduce
// them into the MLP input row [xy | zy | posenc] of X (Tile<T>'s type and
// stride), rounded to T; the corner weights into W8 [M][8] and the two
// texel bases into Base [M][2]. One warp a row; rows at or past `valid`
// are zero.
template <typename T>
__device__ void gather_rows(typename Tile<T>::E* X, float* W8, int* Base,
                            const Planes<T>& pl, const int* __restrict__ rows,
                            const float* __restrict__ aux, int valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = lane >> 4, c = 4 * (lane & 15);
  const T* plane = p ? pl.zy : pl.xy;
  for (int r = warp; r < Tile<T>::M; r += NT / 32) {
    auto* xr = X + r * Tile<T>::LDX;
    if (r >= valid) {
      for (int j = lane; j < FIN; j += 32) stf(xr + j, 0.f);
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
    st4(xr + p * QC + c,
        make_float4(rnd<T>(s.x), rnd<T>(s.y), rnd<T>(s.z), rnd<T>(s.w)));
    for (int j = lane; j < NPE; j += 32)
      stf(xr + 2 * QC + j, rnd<T>(__ldg(a + j)));
    if (lane < 8) W8[r * 8 + lane] = __ldg(a + NPE + lane);
    if ((lane & 15) == 0) Base[r * 2 + p] = base;
  }
}

// The backward's epilogue for one tile: Dx [M][LDXF] holds the tile's f32
// dx.
// One warp a row, as in gather_rows: dw[k] = texel_k . dx_plane (a
// half-warp reduction), dx_plane * w_k added into texel k of the plane's
// gradient, d(posenc) = dx's tail; daux = [d(posenc) | dw], streamed (written
// once: evict first). Rows at or past `valid` write nothing.
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
    const float4 d =
        *reinterpret_cast<const float4*>(Dx + r * LDXF + p * QC + c);
    const size_t base = size_t(Base[r * 2 + p]);
    float* da = daux + size_t(r) * NAUX;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const size_t off = (base + corner(k, pl.W)) * QC + c;
      const float4 v = ld4(plane + off);
      float s = fmaf(v.x, d.x, fmaf(v.y, d.y, fmaf(v.z, d.z, v.w * d.w)));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if ((lane & 15) == 0) __stcs(da + NPE + 4 * p + k, s);
      const float w = W8[r * 8 + 4 * p + k];
      atomicAdd(reinterpret_cast<float4*>(dplane + off),
                make_float4(d.x * w, d.y * w, d.z * w, d.w * w));
    }
    for (int j = lane; j < NPE; j += 32)
      __stcs(da + j, Dx[r * LDXF + 2 * QC + j]);
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
// backward: the shared body (chain_bwd.cuh) between the gather and the
// splat. part: this launch's per-block partials [gridDim.x][NGRAD], zeroed
// by the caller; dxy, dzy [H][W][QC] f32, zeroed by the caller.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT, 1)
quad_bwd_kernel(Planes<T> pl, const int* __restrict__ rows,
                const float* __restrict__ aux, const float* __restrict__ g,
                Params<T> p, float* __restrict__ dxy, float* __restrict__ dzy,
                float* __restrict__ daux, float* __restrict__ part,
                long long N) {
  extern __shared__ __align__(16) unsigned char smem[];
  chain_bwd<T>(
      smem, p, g, part, N,
      [&](const BwdSmem<T>& s, long long row0, int valid) {
        gather_rows(s.X, s.W8, s.Base, pl, rows + 2 * row0, aux + row0 * NAUX,
                    valid);
      },
      [&](const BwdSmem<T>& s, long long row0, int valid) {
        splat_rows(s.Dx, s.W8, s.Base, pl, dxy, dzy, daux + row0 * NAUX,
                   valid);
      });
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
  return planes_bf16 ? bwd_grid<bf16>(quad_bwd_kernel<bf16>, N, grid)
                     : bwd_grid<float>(quad_bwd_kernel<float>, N, grid);
}

// planes [H][W][64] (f32, or bf16 when planes_bf16), rows [N][2] int32, aux
// [N][56] f32, g [N][68] f32 -> dxy, dzy [H][W][64] f32 (zeroed by the
// caller; the texels' gradients are added in), daux [N][56] f32 and grads
// [47748] f32, the weight gradients as [in][out] (dw0's rows in block order)
// then the bias gradients. part [nblk][47748] f32, zeroed by the caller,
// nblk from quad_backward_blocks. Weights as chain_bwd.cuh's Params take
// them, w0's 176 inputs in block order: for f32 planes w*_kn = W^T [in][out]
// f32 and w* = W [out][in] in split-TF32 fragment order
// (ops/mlp.py:_tf32_frags); for bf16 planes all six in bf16 fragment order
// (ops/mlp.py:_frags); w0 padded to 192 columns. wa, wr and the biases f32,
// rounded to the planes' type in the kernel.
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
  const cudaStream_t s = (cudaStream_t)stream;
  if (planes_bf16)
    return launch_bwd<bf16>(
        quad_bwd_kernel<bf16>, nblk, N, (float*)part, (float*)grads, s,
        Planes<bf16>{(const bf16*)pxy, (const bf16*)pzy, W}, (const int*)rows,
        (const float*)aux, (const float*)g,
        make_params<bf16>(w0_kn, w1_kn, wf_kn, w0, w1, wf, wa, wr, b0, b1, bf,
                          nullptr, nullptr),
        (float*)dxy, (float*)dzy, (float*)daux);
  return launch_bwd<float>(
      quad_bwd_kernel<float>, nblk, N, (float*)part, (float*)grads, s,
      Planes<float>{(const float*)pxy, (const float*)pzy, W}, (const int*)rows,
      (const float*)aux, (const float*)g,
      make_params<float>(w0_kn, w1_kn, wf_kn, w0, w1, wf, wa, wr, b0, b1, bf,
                         nullptr, nullptr),
      (float*)dxy, (float*)dzy, (float*)daux);
}

}  // extern "C"
