// The field MLP on tensor cores, shared by the CUDA sources that run it
// (march.cu: the four fused march kernels; mlp.cu: the bf16 forward of the
// fused dense chain). A persistent block stages the five weight matrices in
// shared memory once (bf16, rows padded so MMA fragment loads hit distinct
// banks); each of its 8 warps then owns 16 rows of a 128-row tile and runs
// the chain on them with mma.sync m16n8k16 (bf16 in, f32 accumulate),
// keeping activations in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {


typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPoints = kWarps * 16;  // one 16-row MMA tile per warp
constexpr int kPad = 8;               // bf16 row padding: spreads banks

struct Layout {
  int fin, ldw0, ldw1, ldwh, ldwr, ldx, ldh, ldf;
  size_t w0, w1, wh, wr, b0, b1, bh, br, x, h, sig, rgb, extra, total;
};

inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

template <int H, int CF>
Layout make_layout(int fin, size_t extra_bytes) {
  constexpr int NH = CF + 8;  // feature head ++ alpha head, padded to 8
  Layout L;
  L.fin = fin;
  L.ldw0 = fin + kPad;
  L.ldw1 = H + kPad;
  L.ldwh = H + kPad;
  L.ldwr = CF + kPad;
  L.ldx = (fin > H ? fin : H) + kPad;
  L.ldh = H + kPad;
  L.ldf = (H + kPad) / 2;  // f32 feature rows alias the h1 rows
  size_t o = 0;
  L.w0 = o; o = align16(o + size_t(H) * L.ldw0 * 2);
  L.w1 = o; o = align16(o + size_t(H) * L.ldw1 * 2);
  L.wh = o; o = align16(o + size_t(NH) * L.ldwh * 2);
  L.wr = o; o = align16(o + size_t(8) * L.ldwr * 2);
  L.b0 = o; o = align16(o + size_t(H) * 4);
  L.b1 = o; o = align16(o + size_t(H) * 4);
  L.bh = o; o = align16(o + size_t(NH) * 4);
  L.br = o; o = align16(o + 8 * 4);
  L.x = o; o = align16(o + size_t(kPoints) * L.ldx * 2);
  L.h = o; o = align16(o + size_t(kPoints) * L.ldh * 2);
  L.sig = o; o = align16(o + size_t(kPoints) * 4);
  L.rgb = o; o = align16(o + size_t(kPoints) * 3 * 4);
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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[j] = A[16 x K] * Bt[n0 + 8j .. n0 + 8j + 7, :K]^T for one warp.
// A is row-major (lda), Bt holds the weight as [N][K] (torch Linear layout).
template <int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const bf16* A,
                                          int lda, const bf16* Bt, int ldb,
                                          int K, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k = 0; k < K; k += 16) {
    const bf16* ar = A + g * lda + k + 2 * t;
    const uint32_t a0 = ld32(ar), a1 = ld32(ar + 8 * lda);
    const uint32_t a2 = ld32(ar + 8), a3 = ld32(ar + 8 * lda + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* br = Bt + (n0 + j * 8 + g) * ldb + k + 2 * t;
      mma_bf16(acc[j], a0, a1, a2, a3, ld32(br), ld32(br + 8));
    }
  }
}

// out[16 rows, n0 .. n0 + 8NT) = bf16(relu(acc + bias))
template <int NT>
__device__ __forceinline__ void store_relu_bf16(const float (&acc)[NT][4],
                                                const float* bias, bf16* out,
                                                int ldo, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    const float c0 = bias[col], c1 = bias[col + 1];
    *reinterpret_cast<bf162*>(out + g * ldo + col) = __floats2bfloat162_rn(
        fmaxf(acc[j][0] + c0, 0.f), fmaxf(acc[j][1] + c1, 0.f));
    *reinterpret_cast<bf162*>(out + (g + 8) * ldo + col) =
        __floats2bfloat162_rn(fmaxf(acc[j][2] + c0, 0.f),
                              fmaxf(acc[j][3] + c1, 0.f));
  }
}

template <int H, int CF>
__device__ void stage_weights(unsigned char* smem, const Layout& L,
                              const Weights& w) {
  constexpr int NH = CF + 8;
  bf16* sW0 = reinterpret_cast<bf16*>(smem + L.w0);
  bf16* sW1 = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* sWh = reinterpret_cast<bf16*>(smem + L.wh);
  bf16* sWr = reinterpret_cast<bf16*>(smem + L.wr);
  float* sB0 = reinterpret_cast<float*>(smem + L.b0);
  float* sB1 = reinterpret_cast<float*>(smem + L.b1);
  float* sBh = reinterpret_cast<float*>(smem + L.bh);
  float* sBr = reinterpret_cast<float*>(smem + L.br);
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < H * L.fin; i += blockDim.x)
    sW0[(i / L.fin) * L.ldw0 + i % L.fin] = w.w0[i];
  for (int i = threadIdx.x; i < H * H; i += blockDim.x)
    sW1[(i / H) * L.ldw1 + i % H] = w.w1[i];
  for (int i = threadIdx.x; i < NH * H; i += blockDim.x)
    sWh[(i / H) * L.ldwh + i % H] = i < (CF + 1) * H ? w.wh[i] : zero;
  for (int i = threadIdx.x; i < 8 * CF; i += blockDim.x)
    sWr[(i / CF) * L.ldwr + i % CF] = i < 3 * CF ? w.wr[i] : zero;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    sB0[i] = w.b0[i];
    sB1[i] = w.b1[i];
  }
  for (int i = threadIdx.x; i < NH; i += blockDim.x)
    sBh[i] = i < CF + 1 ? w.bh[i] : 0.f;
  for (int i = threadIdx.x; i < 8; i += blockDim.x)
    sBr[i] = i < 3 ? w.br[i] : 0.f;
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

// One warp: the field MLP on its 16 rows of sX. Leaves feat (f32) in sF,
// sigma in sSig and raw rgb in sRgb.
template <int H, int CF>
__device__ void mlp_rows(unsigned char* smem, const Layout& L, int warp,
                         int lane) {
  constexpr int NH = CF + 8;
  const bf16* sW0 = reinterpret_cast<const bf16*>(smem + L.w0);
  const bf16* sW1 = reinterpret_cast<const bf16*>(smem + L.w1);
  const bf16* sWh = reinterpret_cast<const bf16*>(smem + L.wh);
  const bf16* sWr = reinterpret_cast<const bf16*>(smem + L.wr);
  const float* sB0 = reinterpret_cast<const float*>(smem + L.b0);
  const float* sB1 = reinterpret_cast<const float*>(smem + L.b1);
  const float* sBh = reinterpret_cast<const float*>(smem + L.bh);
  const float* sBr = reinterpret_cast<const float*>(smem + L.br);
  const int r0 = warp * 16;
  bf16* X = reinterpret_cast<bf16*>(smem + L.x) + r0 * L.ldx;
  bf16* Hh = reinterpret_cast<bf16*>(smem + L.h) + r0 * L.ldh;
  float* F = reinterpret_cast<float*>(smem + L.h) + r0 * L.ldf;
  float* sSig = reinterpret_cast<float*>(smem + L.sig) + r0;
  float* sRgb = reinterpret_cast<float*>(smem + L.rgb) + r0 * 3;
  const int g = lane >> 2, t = lane & 3;

  // layer0: x -> h1 (in Hh); layer1: h1 -> h2 (over x, now dead)
#pragma unroll 1
  for (int n0 = 0; n0 < H; n0 += 64) {
    float acc[8][4];
    warp_gemm<8>(acc, X, L.ldx, sW0, L.ldw0, L.fin, n0, lane);
    store_relu_bf16<8>(acc, sB0, Hh, L.ldh, n0, lane);
  }
  __syncwarp();
#pragma unroll 1
  for (int n0 = 0; n0 < H; n0 += 64) {
    float acc[8][4];
    warp_gemm<8>(acc, Hh, L.ldh, sW1, L.ldw1, H, n0, lane);
    store_relu_bf16<8>(acc, sB1, X, L.ldx, n0, lane);
  }
  __syncwarp();
  // heads: [feat (CF) | sigma | 7 zero rows] from h2
  {
    float acc[NH / 8][4];
    warp_gemm<NH / 8>(acc, X, L.ldx, sWh, L.ldwh, H, 0, lane);
    __syncwarp();  // all lanes are done reading h2 before X is overwritten
#pragma unroll
    for (int j = 0; j < NH / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + (e >> 1) * 8, col = j * 8 + 2 * t + (e & 1);
        const float v = acc[j][e] + sBh[col];
        if (col < CF) {
          F[row * L.ldf + col] = v;
          X[row * L.ldx + col] = __float2bfloat16(v);  // fc_rgb input
        } else if (col == CF) {
          sSig[row] = v;
        }
      }
    }
  }
  __syncwarp();
  // fc_rgb on bf16(feat)
  {
    float acc[1][4];
    warp_gemm<1>(acc, X, L.ldx, sWr, L.ldwr, CF, 0, lane);
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
