// The float32 product engine: FFMA (outside the tensor cores) on 64-row
// shared-memory tiles, for Hopper (sm_90a). Device code only; included by
// csrc/chain_bwd.cuh, whose float32 backward recomputes h0, h1 and feat on
// it, and by csrc/quad.cu, whose float32 forward runs on it.
//
// A block of NT = 256 threads computes a TM x (NG*64) output, each thread
// a 4 x 4*NG register tile (rows ty*4 + i, columns g*64 + tx*4 + c; ty =
// tid / 16, tx = tid % 16). Products by a weight (gemm_nn) stream the
// weight from device memory (mostly L2) in KC-row chunks through two
// cp.async stages: the next chunk copies while this one is multiplied, one
// block barrier a chunk. Each output of gemm_nn is one chain of fmaf in k
// order, so it rounds as a plain row-by-column dot product does: the
// backward's recomputed ReLU masks are then the plain twin's.
//
// Measured against this engine on an H100 (PERF.md, section 6): 8 x 8
// register tiles (two warp groups with their own barriers, splitting a
// product's k range, rows or columns) and three cp.async stages; all were
// slower.

#pragma once

#include <cuda_runtime.h>

namespace ffma_engine {

constexpr int TM = 64;    // rows a tile
constexpr int NT = 256;   // threads a block
constexpr int KC = 16;    // weight rows a staged chunk
constexpr int LDW = 192;  // a stage's row: up to three 64-column groups
constexpr int kStageFloats = 2 * KC * LDW;  // the two stages


__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = unsigned(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// Start copying rows k0 .. k0+KC of a k-major weight W[K][N] in device
// memory, NG*64 columns (zero past N), into the stage Ws [KC][LDW].
template <int NG>
__device__ __forceinline__ void chunk_async(float* Ws,
                                            const float* __restrict__ W, int N,
                                            int k0) {
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int i = threadIdx.x + j * NT;
    const int kk = i / (NG * 16), col = (i % (NG * 16)) * 4;
    cp_async16(Ws + kk * LDW + col,
               col < N ? W + size_t(k0 + kk) * N + col : W, col < N);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc[i][4g + c] = sum over k < K of A[ty*4 + i][k] * W[k][g*64 + tx*4 + c]
// for the block's TM x (NG*64) output. A is a shared-memory tile (row stride
// lda), W a k-major weight in device memory, streamed through two stages Ws
// [2][KC][LDW] with cp.async: the next chunk copies while this one is
// multiplied, one barrier a chunk. The first barrier also publishes the
// tile that the caller has just written and frees the stages.
template <int NG>
__device__ __forceinline__ void gemm_nn(float (&acc)[4][4 * NG], const float* As,
                                        int lda, int K,
                                        const float* __restrict__ W, int N,
                                        float* Ws) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
  __syncthreads();
  chunk_async<NG>(Ws, W, N, 0);
  for (int k0 = 0; k0 < K; k0 += KC) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // this chunk is in; every thread is done with the last
    const float* Wc = Ws + ((k0 / KC) & 1) * KC * LDW;
    if (k0 + KC < K)
      chunk_async<NG>(Ws + (((k0 / KC) + 1) & 1) * KC * LDW, W, N, k0 + KC);
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
              Wc + (kk + q) * LDW + g * 64 + tx * 4);
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

// Out[r][col] = relu(acc + bias) over the block's TM x 128 output.
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
          fmaxf(acc[i][4 * g + 0] + b.x, 0.f), fmaxf(acc[i][4 * g + 1] + b.y, 0.f),
          fmaxf(acc[i][4 * g + 2] + b.z, 0.f), fmaxf(acc[i][4 * g + 3] + b.w, 0.f));
  }
}

}  // namespace ffma_engine
