// One float32 product C [64][128] = A [64][176] . B [176][128] (the quad
// chain's first layer at one tile) on four routes, for
// tests/test_torch_split_tf32_cuda.py to hold against float64:
//   0  FFMA, one thread an output, k in order
//   1  one TF32 mma.sync m16n8k8 product a k step (hi . hi)
//   2  split TF32 in one accumulator: a = hi + lo, b = hi + lo with hi =
//      tf32(v), lo = tf32(v - hi); each k step adds lo.hi + hi.lo, then
//      hi.hi (the small terms first)
//   3  split TF32, the small terms in a second accumulator added at the end
// Plain C entry point, bound with ctypes. Built for sm_90a.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int M = 64, K = 176, N = 128;

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void ffma_kernel(const float* A, const float* B, float* C) {
  const int i = blockIdx.x, j = threadIdx.x;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s = fmaf(A[i * K + k], B[k * N + j], s);
  C[i * N + j] = s;
}

// one warp a 16 x 8 output block: 4 x 16 blocks
__global__ void mma_kernel(const float* A, const float* B, float* C,
                           int route) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * blockIdx.x, n0 = 8 * blockIdx.y;
  float c[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 8) {
    // fragment elements: a (g, t) (g+8, t) (g, t+4) (g+8, t+4); b (t, g)
    // (t+4, g); c (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1)
    const float av[4] = {A[(m0 + g) * K + k0 + t], A[(m0 + g + 8) * K + k0 + t],
                         A[(m0 + g) * K + k0 + t + 4],
                         A[(m0 + g + 8) * K + k0 + t + 4]};
    const float bv[2] = {B[(k0 + t) * N + n0 + g], B[(k0 + t + 4) * N + n0 + g]};
    uint32_t ah[4], al[4], bh[2], bl[2];
    for (int e = 0; e < 4; ++e) {
      ah[e] = tf32(av[e]);
      al[e] = tf32(av[e] - __uint_as_float(ah[e]));
    }
    for (int e = 0; e < 2; ++e) {
      bh[e] = tf32(bv[e]);
      bl[e] = tf32(bv[e] - __uint_as_float(bh[e]));
    }
    if (route == 1) {
      mma(c, ah, bh);
    } else if (route == 2) {
      mma(c, al, bh);
      mma(c, ah, bl);
      mma(c, ah, bh);
    } else {
      mma(d, al, bh);
      mma(d, ah, bl);
      mma(c, ah, bh);
    }
  }
  const float out[4] = {c[0] + d[0], c[1] + d[1], c[2] + d[2], c[3] + d[3]};
  C[(m0 + g) * N + n0 + 2 * t] = out[0];
  C[(m0 + g) * N + n0 + 2 * t + 1] = out[1];
  C[(m0 + g + 8) * N + n0 + 2 * t] = out[2];
  C[(m0 + g + 8) * N + n0 + 2 * t + 1] = out[3];
}

}  // namespace

extern "C" int split_tf32_product(const void* A, const void* B, void* C,
                                  int route) {
  if (route == 0)
    ffma_kernel<<<M, N>>>((const float*)A, (const float*)B, (float*)C);
  else
    mma_kernel<<<dim3(M / 16, N / 8), 32>>>((const float*)A, (const float*)B,
                                            (float*)C, route);
  if (cudaError_t e = cudaGetLastError()) return int(e);
  return int(cudaDeviceSynchronize());
}
