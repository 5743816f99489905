// Fused NeRF field MLP + alpha compositing for the reenactment ray march,
// written for Hopper (sm_90a). Four kernels, each with a plain C entry point
// bound from Python with ctypes (havatar_tpu_torch/ops/march.py). The MLP's
// device code (weight staging, the tensor-core chain on a warp's 16 rows)
// is in field_mlp.cuh, which mlp.cu shares.
//
// What they replace:
//   march_coarse   -> havatar_tpu/ops/pallas_march.py:fused_march_coarse_quad
//                     (Pallas kernel _coarse_kernel_quad, _build_x_quad,
//                     _coarse_body)
//   march_fine     -> havatar_tpu/ops/pallas_march.py:fused_march_fine_quad
//                     (Pallas kernel _fine_kernel_quad, _fine_body)
//   march_coarse_x -> havatar_tpu/ops/pallas_march.py:fused_march_coarse
//                     (Pallas kernel _coarse_kernel, _coarse_body)
//   march_fine_x   -> havatar_tpu/ops/pallas_march.py:fused_march_fine
//                     (Pallas kernel _fine_kernel, _fine_body)
//
// The first two read raw bilinear corner rows and reduce them in the kernel;
// the _x pair reads the MLP input already reduced, [.., fin] bf16 in the
// reference's interleaved channel order (plane feature 2c + p, then posenc),
// with layer0 NOT permuted. The four share everything after the input stage.
//
// What bounds them on an H100: memory. At the 128^2 frame (R = 16384 rays,
// 16 samples a ray, C = 64 plane channels) the coarse kernel must read
// ~268 MB of raw bilinear corner rows (bf16) and ~59 MB of posenc + corner
// weights (f32) and write ~18 MB of packed keeps: ~0.1 ms at 3.35 TB/s. Its
// MLP is ~25 GFLOP, ~0.025 ms at the bf16 tensor-core peak. The fine kernel
// moves about the same.
//
// What the design does about it: every input byte is read once and nothing
// between the gather and the per-ray maps goes back to device memory. A
// persistent block per SM stages the five weight matrices in shared memory
// once (~104 KB bf16, rows padded so MMA fragment loads hit distinct banks)
// and then walks over tiles of 128 samples. Each of its 8 warps owns 16
// samples: it corner-reduces their quad rows in f32 (coalesced 4-byte loads,
// 128 B per corner per warp) into a bf16 MLP input row in shared memory, then
// runs the 5-layer chain with mma.sync m16n8k16 (bf16 in, f32 accumulate),
// keeping activations in shared memory. The compositing runs per ray after
// one block barrier. This first version overlaps loads with compute only
// across the 8 warps of a block; TMA/wgmma pipelining is later work.
//
// The _x kernels move about a third of that: ~92 MB of reduced input, 1 MB
// of dists and the same outputs, ~0.035 ms at 3.35 TB/s against the same
// ~0.025 ms of MLP, so they are bound by memory too, but only just. Their
// input stage is a straight copy: a warp's 16 rows are one contiguous span
// of device memory, read with 16-byte loads and stored into the padded
// shared-memory tile.
//
// Numerics follow the TPU kernel: bf16 MLP inputs and hidden activations,
// f32 accumulation, f32 corner reduction and compositing, sigma kept to f32
// accuracy in the keeps as a (hi, lo) bf16 pair. The transmittance is a
// direct product (the TPU takes exp(sum(log))), which differs by rounding.

#include "field_mlp.cuh"

namespace {

// One warp: corner-reduce its 16 samples' quad rows into MLP input rows
// [xy (C) | zy (C) | posenc (n_pe)] in bf16 (the block order that the
// permuted layer0 expects). Rows at or past `valid` are zero.
__device__ void build_inputs(unsigned char* smem, const Layout& L,
                             const bf16* __restrict__ quads,
                             const float* __restrict__ aux, long pt0,
                             int valid, int C, int n_pe, int warp, int lane) {
  bf16* sX = reinterpret_cast<bf16*>(smem + L.x);
  const int naux = n_pe + 8;
  for (int i = 0; i < 16; ++i) {
    const int p = warp * 16 + i;
    bf16* xr = sX + p * L.ldx;
    if (p >= valid) {
      for (int c = lane; c < L.fin; c += 32) xr[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* q = quads + (pt0 + p) * long(8 * C);
    const float* a = aux + (pt0 + p) * long(naux);
    float w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = a[n_pe + k];
    for (int c2 = lane; c2 < C / 2; c2 += 32) {
      float xy0 = 0.f, xy1 = 0.f, zy0 = 0.f, zy1 = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bf162 v = *reinterpret_cast<const bf162*>(q + k * C + 2 * c2);
        const bf162 u =
            *reinterpret_cast<const bf162*>(q + (4 + k) * C + 2 * c2);
        xy0 += __bfloat162float(v.x) * w[k];
        xy1 += __bfloat162float(v.y) * w[k];
        zy0 += __bfloat162float(u.x) * w[4 + k];
        zy1 += __bfloat162float(u.y) * w[4 + k];
      }
      *reinterpret_cast<bf162*>(xr + 2 * c2) = __floats2bfloat162_rn(xy0, xy1);
      *reinterpret_cast<bf162*>(xr + C + 2 * c2) =
          __floats2bfloat162_rn(zy0, zy1);
    }
    for (int j = lane; j < n_pe; j += 32) xr[2 * C + j] = __float2bfloat16(a[j]);
  }
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// After the MLP and a block barrier: composite one tile's rays in sample
// order and write rgbmap, weights and the packed half-rate keeps.
template <int CF>
__device__ void coarse_composite(unsigned char* smem, const Layout& L,
                                 const float* __restrict__ dists,
                                 float* rgbmap, float* weights, bf16* keeps,
                                 int ray0, int nrays, int S) {
  const int S2 = S / 2, NC = 3 + CF, KW = CF + 5;
  const long pt0 = long(ray0) * S;
  const float* sF = reinterpret_cast<const float*>(smem + L.h);
  const float* sSig = reinterpret_cast<const float*>(smem + L.sig);
  const float* sRgb = reinterpret_cast<const float*>(smem + L.rgb);
  float* sW = reinterpret_cast<float*>(smem + L.extra);

  // transmittance: one thread per ray, in sample order
  if (threadIdx.x < nrays) {
    const int r = threadIdx.x;
    float T = 1.f;
    for (int s = 0; s < S; ++s) {
      const int p = r * S + s;
      const float alpha = 1.f - expf(-fmaxf(sSig[p], 0.f) * dists[pt0 + p]);
      sW[p] = alpha * T;
      T *= 1.f - alpha + 1e-10f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrays * S; i += blockDim.x)
    weights[pt0 + i] = sW[i];
  for (int i = threadIdx.x; i < nrays * NC; i += blockDim.x) {
    const int r = i / NC, c = i % NC;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const int p = r * S + s;
      const float v = c < 3 ? sigmoidf(sRgb[p * 3 + c]) : sF[p * L.ldf + c - 3];
      acc += sW[p] * v;
    }
    rgbmap[long(ray0 + r) * NC + c] = acc;
  }
  // half-rate keeps, packed [feat | rgb | sigma_hi | sigma_lo]
  for (int i = threadIdx.x; i < nrays * S2 * KW; i += blockDim.x) {
    const int c = i % KW, j = (i / KW) % S2, r = i / (KW * S2);
    const int p = r * S + 2 * j;
    bf16 v;
    if (c < CF) {
      v = __float2bfloat16(sF[p * L.ldf + c]);
    } else if (c < CF + 3) {
      v = __float2bfloat16(sRgb[p * 3 + c - CF]);
    } else {
      const bf16 hi = __float2bfloat16(sSig[p]);
      v = c == CF + 3 ? hi : __float2bfloat16(sSig[p] - __bfloat162float(hi));
    }
    keeps[(long(ray0) * S2) * KW + i] = v;
  }
}

template <int H, int CF>
__global__ void __launch_bounds__(kThreads, 1)
coarse_kernel(const bf16* __restrict__ quads, const float* __restrict__ aux,
              const float* __restrict__ dists, Weights w, float* rgbmap,
              float* weights, bf16* keeps, int R, int S, int C, int n_pe,
              Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int TR = kPoints / S;
  const int ntiles = (R + TR - 1) / TR;

  stage_weights<H, CF>(smem, L, w);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int ray0 = tile * TR;
    const int nrays = min(TR, R - ray0);
    __syncthreads();  // weights staged / previous tile's reads finished
    build_inputs(smem, L, quads, aux, long(ray0) * S, nrays * S, C, n_pe,
                 warp, lane);
    __syncwarp();
    mlp_rows<H, CF>(smem, L, warp, lane);
    __syncthreads();
    coarse_composite<CF>(smem, L, dists, rgbmap, weights, keeps, ray0, nrays,
                         S);
  }
}

// The coarse pass on an already-reduced MLP input x [R, S, fin].
template <int H, int CF>
__global__ void __launch_bounds__(kThreads, 1)
coarse_x_kernel(const bf16* __restrict__ x, const float* __restrict__ dists,
                Weights w, float* rgbmap, float* weights, bf16* keeps, int R,
                int S, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int TR = kPoints / S;
  const int ntiles = (R + TR - 1) / TR;

  stage_weights<H, CF>(smem, L, w);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int ray0 = tile * TR;
    const int nrays = min(TR, R - ray0);
    __syncthreads();  // weights staged / previous tile's reads finished
    copy_inputs(smem, L, x, long(ray0) * S, nrays * S, warp, lane);
    __syncwarp();
    mlp_rows<H, CF>(smem, L, warp, lane);
    __syncthreads();
    coarse_composite<CF>(smem, L, dists, rgbmap, weights, keeps, ray0, nrays,
                         S);
  }
}

// After the MLP and a block barrier: composite one tile's rays over
// keeps ++ new samples in concat order by merge ranks.
template <int CF>
__device__ void fine_composite(unsigned char* smem, const Layout& L,
                               const bf16* __restrict__ keeps,
                               const float* __restrict__ dcat,
                               const int* __restrict__ ranks, float* rgbmap,
                               float* wout, int ray0, int nrays, int TR,
                               int Sn, int Sk) {
  const int Sa = Sk + Sn, NC = 3 + CF, KW = CF + 5;
  const float* sF = reinterpret_cast<const float*>(smem + L.h);
  const float* sSig = reinterpret_cast<const float*>(smem + L.sig);
  const float* sRgb = reinterpret_cast<const float*>(smem + L.rgb);
  float* sAl = reinterpret_cast<float*>(smem + L.extra);  // [TR * Sa]
  float* sW = sAl + TR * Sa;
  int* sRk = reinterpret_cast<int*>(sW + TR * Sa);

  // alpha of every concat element [keeps | new]
  for (int i = threadIdx.x; i < nrays * Sa; i += blockDim.x) {
    const int r = i / Sa, k = i % Sa;
    const long ray = ray0 + r;
    float sig;
    if (k < Sk) {
      const bf16* kr = keeps + (ray * Sk + k) * KW;
      sig = __bfloat162float(kr[CF + 3]) + __bfloat162float(kr[CF + 4]);
    } else {
      sig = sSig[r * Sn + k - Sk];
    }
    sAl[i] = 1.f - expf(-fmaxf(sig, 0.f) * dcat[ray * Sa + k]);
    sRk[i] = ranks[ray * Sa + k];
  }
  __syncthreads();
  // T_i = prod over j ranked before i of (1 - alpha_j), in concat order
  for (int i = threadIdx.x; i < nrays * Sa; i += blockDim.x) {
    const int r = i / Sa;
    const int ri = sRk[i];
    float T = 1.f;
    for (int j = 0; j < Sa; ++j)
      if (sRk[r * Sa + j] < ri) T *= 1.f - sAl[r * Sa + j] + 1e-10f;
    sW[i] = sAl[i] * T;
    wout[long(ray0) * Sa + i] = sW[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrays * NC; i += blockDim.x) {
    const int r = i / NC, c = i % NC;
    const long ray = ray0 + r;
    float acc_k = 0.f, acc_n = 0.f;
    for (int k = 0; k < Sk; ++k) {
      const float v = __bfloat162float(
          keeps[(ray * Sk + k) * KW + (c < 3 ? CF + c : c - 3)]);
      acc_k += sW[r * Sa + k] * (c < 3 ? sigmoidf(v) : v);
    }
    for (int s = 0; s < Sn; ++s) {
      const int p = r * Sn + s;
      const float v = c < 3 ? sigmoidf(sRgb[p * 3 + c]) : sF[p * L.ldf + c - 3];
      acc_n += sW[r * Sa + Sk + s] * v;
    }
    rgbmap[ray * NC + c] = acc_k + acc_n;
  }
}

template <int H, int CF>
__global__ void __launch_bounds__(kThreads, 1)
fine_kernel(const bf16* __restrict__ qn, const float* __restrict__ auxn,
            const bf16* __restrict__ keeps, const float* __restrict__ dcat,
            const int* __restrict__ ranks, Weights w, float* rgbmap,
            float* wout, int R, int Sn, int Sk, int C, int n_pe, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int TR = kPoints / Sn;
  const int ntiles = (R + TR - 1) / TR;

  stage_weights<H, CF>(smem, L, w);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int ray0 = tile * TR;
    const int nrays = min(TR, R - ray0);
    __syncthreads();
    build_inputs(smem, L, qn, auxn, long(ray0) * Sn, nrays * Sn, C, n_pe,
                 warp, lane);
    __syncwarp();
    mlp_rows<H, CF>(smem, L, warp, lane);
    __syncthreads();
    fine_composite<CF>(smem, L, keeps, dcat, ranks, rgbmap, wout, ray0, nrays,
                       TR, Sn, Sk);
  }
}

// The fine pass on an already-reduced MLP input xn [R, Sn, fin].
template <int H, int CF>
__global__ void __launch_bounds__(kThreads, 1)
fine_x_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ keeps,
              const float* __restrict__ dcat, const int* __restrict__ ranks,
              Weights w, float* rgbmap, float* wout, int R, int Sn, int Sk,
              Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int TR = kPoints / Sn;
  const int ntiles = (R + TR - 1) / TR;

  stage_weights<H, CF>(smem, L, w);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int ray0 = tile * TR;
    const int nrays = min(TR, R - ray0);
    __syncthreads();
    copy_inputs(smem, L, xn, long(ray0) * Sn, nrays * Sn, warp, lane);
    __syncwarp();
    mlp_rows<H, CF>(smem, L, warp, lane);
    __syncthreads();
    fine_composite<CF>(smem, L, keeps, dcat, ranks, rgbmap, wout, ray0, nrays,
                       TR, Sn, Sk);
  }
}

bool dims_ok(int S, int C, int n_pe) {
  return S > 0 && kPoints % S == 0 && C > 0 && C % 2 == 0 && n_pe >= 0 &&
         (2 * C + n_pe) % 16 == 0;
}

bool x_dims_ok(int S, int fin) {
  return S > 0 && kPoints % S == 0 && fin > 0 && fin % 16 == 0;
}

}  // namespace

extern "C" {

const char* march_error_string(int e) {
  return cudaGetErrorString(cudaError_t(e));
}

int march_coarse(const void* quads, const void* aux, const void* dists,
                 const void* w0, const void* b0, const void* w1,
                 const void* b1, const void* wh, const void* bh,
                 const void* wr, const void* br, void* rgbmap, void* weights,
                 void* keeps, int R, int S, int C, int n_pe, int H, int cf,
                 void* stream) {
  if (H != 128 || cf != 64 || S % 2 || !dims_ok(S, C, n_pe))
    return int(cudaErrorInvalidValue);
  if (R == 0) return int(cudaSuccess);
  const Layout L = make_layout<128, 64>(2 * C + n_pe, size_t(kPoints) * 4);
  const Weights w{(const bf16*)w0, (const bf16*)w1, (const bf16*)wh,
                  (const bf16*)wr, (const float*)b0, (const float*)b1,
                  (const float*)bh, (const float*)br};
  auto kern = coarse_kernel<128, 64>;
  const int ntiles = (R + kPoints / S - 1) / (kPoints / S);
  int grid = 0;
  cudaError_t e = launch_config(kern, kThreads, L.total, ntiles, &grid);
  if (e != cudaSuccess) return int(e);
  kern<<<grid, kThreads, L.total, (cudaStream_t)stream>>>(
      (const bf16*)quads, (const float*)aux, (const float*)dists, w,
      (float*)rgbmap, (float*)weights, (bf16*)keeps, R, S, C, n_pe, L);
  return int(cudaGetLastError());
}

int march_fine(const void* qn, const void* auxn, const void* keeps,
               const void* dcat, const void* ranks, const void* w0,
               const void* b0, const void* w1, const void* b1,
               const void* wh, const void* bh, const void* wr,
               const void* br, void* rgbmap, void* wout, int R, int Sn,
               int Sk, int C, int n_pe, int H, int cf, void* stream) {
  if (H != 128 || cf != 64 || Sk < 0 || !dims_ok(Sn, C, n_pe))
    return int(cudaErrorInvalidValue);
  if (R == 0) return int(cudaSuccess);
  const int TR = kPoints / Sn;
  const Layout L = make_layout<128, 64>(2 * C + n_pe,
                                        size_t(TR) * (Sk + Sn) * 12);
  const Weights w{(const bf16*)w0, (const bf16*)w1, (const bf16*)wh,
                  (const bf16*)wr, (const float*)b0, (const float*)b1,
                  (const float*)bh, (const float*)br};
  auto kern = fine_kernel<128, 64>;
  int grid = 0;
  cudaError_t e =
      launch_config(kern, kThreads, L.total, (R + TR - 1) / TR, &grid);
  if (e != cudaSuccess) return int(e);
  kern<<<grid, kThreads, L.total, (cudaStream_t)stream>>>(
      (const bf16*)qn, (const float*)auxn, (const bf16*)keeps,
      (const float*)dcat, (const int*)ranks, w, (float*)rgbmap,
      (float*)wout, R, Sn, Sk, C, n_pe, L);
  return int(cudaGetLastError());
}

int march_coarse_x(const void* x, const void* dists, const void* w0,
                   const void* b0, const void* w1, const void* b1,
                   const void* wh, const void* bh, const void* wr,
                   const void* br, void* rgbmap, void* weights, void* keeps,
                   int R, int S, int fin, int H, int cf, void* stream) {
  if (H != 128 || cf != 64 || S % 2 || !x_dims_ok(S, fin))
    return int(cudaErrorInvalidValue);
  if (R == 0) return int(cudaSuccess);
  const Layout L = make_layout<128, 64>(fin, size_t(kPoints) * 4);
  const Weights w{(const bf16*)w0, (const bf16*)w1, (const bf16*)wh,
                  (const bf16*)wr, (const float*)b0, (const float*)b1,
                  (const float*)bh, (const float*)br};
  auto kern = coarse_x_kernel<128, 64>;
  const int ntiles = (R + kPoints / S - 1) / (kPoints / S);
  int grid = 0;
  cudaError_t e = launch_config(kern, kThreads, L.total, ntiles, &grid);
  if (e != cudaSuccess) return int(e);
  kern<<<grid, kThreads, L.total, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)dists, w, (float*)rgbmap, (float*)weights,
      (bf16*)keeps, R, S, L);
  return int(cudaGetLastError());
}

int march_fine_x(const void* xn, const void* keeps, const void* dcat,
                 const void* ranks, const void* w0, const void* b0,
                 const void* w1, const void* b1, const void* wh,
                 const void* bh, const void* wr, const void* br, void* rgbmap,
                 void* wout, int R, int Sn, int Sk, int fin, int H, int cf,
                 void* stream) {
  if (H != 128 || cf != 64 || Sk < 0 || !x_dims_ok(Sn, fin))
    return int(cudaErrorInvalidValue);
  if (R == 0) return int(cudaSuccess);
  const int TR = kPoints / Sn;
  const Layout L = make_layout<128, 64>(fin, size_t(TR) * (Sk + Sn) * 12);
  const Weights w{(const bf16*)w0, (const bf16*)w1, (const bf16*)wh,
                  (const bf16*)wr, (const float*)b0, (const float*)b1,
                  (const float*)bh, (const float*)br};
  auto kern = fine_x_kernel<128, 64>;
  int grid = 0;
  cudaError_t e =
      launch_config(kern, kThreads, L.total, (R + TR - 1) / TR, &grid);
  if (e != cudaSuccess) return int(e);
  kern<<<grid, kThreads, L.total, (cudaStream_t)stream>>>(
      (const bf16*)xn, (const bf16*)keeps, (const float*)dcat,
      (const int*)ranks, w, (float*)rgbmap, (float*)wout, R, Sn, Sk, L);
  return int(cudaGetLastError());
}

}  // extern "C"
