// The float32 product engine: FFMA (outside the tensor cores) on 64-row
// shared-memory tiles, for Hopper (sm_90a). Device code only; included by
// csrc/quad.cu (csrc/mlp.cu keeps an older copy without the cp.async
// stages until its own redesign).
//
// A block of NT = 256 threads computes a TM x (NG*64) output, each thread
// a 4 x 4*NG register tile (rows ty*4 + i, columns g*64 + tx*4 + c; ty =
// tid / 16, tx = tid % 16). Products by a weight (gemm_nn) stream the
// weight from device memory (mostly L2) in KC-row chunks through two
// cp.async stages: the next chunk copies while this one is multiplied, one
// block barrier a chunk. Weight gradients (gemm_tn) contract a tile's rows
// in registers and add into a float32 partial in device memory with plain
// vector loads and stores. Each output of gemm_nn is one chain of fmaf in k
// order, so it rounds as a plain row-by-column dot product does.
//
// Measured against this engine on an H100 (PERF.md, section 6): 8 x 8
// register tiles (two warp groups with their own barriers, splitting a
// product's k range, rows or columns, or one group on the transposed
// products while the other contracts the weight gradients) and three
// cp.async stages; all were slower.

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

// P[i*16 + ty][g*64 + tx*4 + c] += sum over the tile's rows r of
// A[r][i*16 + ty] * B[r][g*64 + tx*4 + c]: a weight gradient's share of one
// tile, contracted in registers and added into the block's own partial P
// [KI*16][NG*64] with plain vector loads and stores (each element is owned
// by one thread).
template <int KI, int NG>
__device__ __forceinline__ void gemm_tn(const float* As, int lda,
                                        const float* Bs, int ldb, float* P) {
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
    for (int g = 0; g < NG; ++g) {
      float4* o = reinterpret_cast<float4*>(P + (i * 16 + ty) * (NG * 64) +
                                            g * 64 + tx * 4);
      float4 v = *o;
      v.x += acc[i][4 * g + 0];
      v.y += acc[i][4 * g + 1];
      v.z += acc[i][4 * g + 2];
      v.w += acc[i][4 * g + 3];
      *o = v;
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

// The cotangent of a hidden layer: da = acc (+ the density head's share)
// where the activation Hd was positive, else 0, in place of Hd (each element
// is read and written by one thread). Each thread's column sums over its 4
// rows go to S[ty][col]; col_sums adds them up after a barrier.
__device__ __forceinline__ void mask_store(const float (&acc)[4][8],
                                           const float* dsig, int ldsig,
                                           const float* __restrict__ wa,
                                           float* Hd, int ldh, float* S) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = g * 64 + tx * 4 + c;
      const float w = dsig ? __ldg(wa + col) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float v = acc[i][4 * g + c];
        if (dsig) v = fmaf(dsig[r * ldsig], w, v);
        v = Hd[r * ldh + col] > 0.f ? v : 0.f;
        sum += v;
        Hd[r * ldh + col] = v;
      }
      S[ty * 128 + col] = sum;
    }
  }
}

// sB[col] += the 16 partial column sums in S, in order.
__device__ __forceinline__ void col_sums(const float* S, float* sB) {
  const int tid = threadIdx.x;
  if (tid < 128) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) s += S[j * 128 + tid];
    sB[tid] += s;
  }
}

}  // namespace ffma_engine
