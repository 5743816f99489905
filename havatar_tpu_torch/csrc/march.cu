// Fused NeRF field MLP + alpha compositing for the reenactment ray march,
// written for Hopper (sm_90a). Four kernels, each with a plain C entry point
// bound from Python with ctypes (havatar_tpu_torch/ops/march.py). They run
// the input stages and the MLP of field_mlp.cuh, which mlp.cu and quad.cu
// share; the compositing is this file's own.
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
// The first two take the two bf16 feature planes [B][H][W][C] (C = 64),
// each sample's bilinear cell in both planes (rows [R][S][2] int32: y0 *
// (W - 1) + x0, ops/mlp_quad.py:quad_rows) and aux [R][S][n_pe + 8] f32 =
// posenc ++ the 8 corner weights; they gather the four corner texels of
// each cell from the planes themselves and corner-reduce them in f32 (the
// TPU kernels read corner rows [R][S][8C] that XLA gathered; no such tensor
// exists here). Ray r belongs to batch item r / (R / B). The _x pair reads
// the MLP input already reduced, [R][S][fin] bf16 in the reference's
// interleaved channel order (plane feature 2c + p, then posenc), with layer0
// NOT permuted. The four share the MLP and the compositing.
//
// What bounds them on an H100: at the 128^2 frame (R = 16384 rays, 16
// samples a ray) the coarse kernel reads the cells (2 MB), aux (59 MB), the
// deltas (1 MB) and the planes (4 MB, which L2 then holds while the gather
// reads each texel about 16 times) and writes the rgbmap (4.4 MB), the
// weights (1 MB) and the keeps (18 MB): about 90 MB, 0.027 ms at 3.35 TB/s.
// Its MLP is about 25 GFLOP, 0.026 ms at the bf16 tensor-core peak. The fine
// kernel reads the keeps instead of writing them. So both are bound by
// bytes and operations about equally, at about 0.03 ms (the corner-rows
// contract's bound was 0.105 ms, its 268 MB of corner rows the largest
// part). What holds them above that is latency and shared memory: the
// gather reads 1 KB of texels from L2 a sample, a 16-row warp tile reads
// every weight (96 KB) from shared memory for its products, the
// compositing is a scan along each ray, and the weights (104 KB of shared
// memory) leave room for one block of 16 warps an SM.
//
// What the design does about it:
//  * a persistent block of 16 warps an SM stages the five weight matrices
//    in shared memory once (16-byte loads; rows padded so fragment loads
//    hit distinct banks); each warp then works on 16 samples at a time
//    with no block-wide barrier: gather, MLP and compositing. A ray of
//    S > 16 samples spans S / 16 warps, a team that meets at a named
//    barrier; shorter rays are a warp's own. So the warps drift apart and
//    one warp's loads overlap another's products (8 warps: 1.4x slower).
//  * the gather: a warp first issues every DRAM load of its 16 samples (the
//    cells, one int a lane; the aux rows as 16-byte loads, posenc rounded
//    into the input tile, the corner weights staged in shared memory), then
//    the corner texels of 4 samples at a time (lanes 0-15 on the XY plane,
//    16-31 on ZY, four channels a lane: 16 8-byte loads in flight a lane;
//    8 samples ran slower at 128 registers), summed in corner order without
//    FMA (__fmul_rn, __fadd_rn), the plain twin's rounding to the bit.
//  * the MLP (field_mlp.cuh:mlp_warp, the chain of every bf16 forward in
//    the port; mma.sync m16n8k16, bf16 in, f32 accumulate) keeps its
//    hidden activations in registers: an m16n8 accumulator is the next
//    product's A fragment once rounded to bf16, so only the input rows and
//    the f32 features touch shared memory, and ldmatrix loads the
//    fragments. The features go over the dead input rows, and past them
//    lies the warp's scratch for the compositing.
//  * the compositing runs on the warp that owns the samples. Coarse: a lane
//    a sample, alpha and the transmittance as a segmented prefix product
//    over the lanes (the warps of a longer ray pass their products and
//    their partial sums through shared memory, summed in warp order), the
//    per-ray sums with lanes over channels; the keeps (every 2nd sample:
//    feat, rgb, sigma as a bf16 (hi, lo) pair) are packed in the scratch
//    and written with 16-byte stores, a warp's 8 keep rows being one
//    aligned span. Fine: each concat element (keeps ++ new samples) puts
//    1 - alpha into its ranked slot, a warp takes the exclusive product in
//    that sorted order (O(Sa)) and each element reads its T back by rank;
//    the keeps are read once, channels on lanes, 8 keep rows' loads in
//    flight.
//  * no atomics and a fixed order in every sum: two launches agree bit for
//    bit.

// The _x kernels move less: ~92 MB of reduced input, 1 MB of dists and the
// same outputs, ~0.035 ms at 3.35 TB/s. Their input stage is a straight
// copy (field_mlp.cuh:copy_inputs, a warp's 16 rows one contiguous span
// read with 16-byte loads); they run the same loop, MLP and compositing.
//
// Numerics follow the TPU kernel: bf16 MLP inputs and hidden activations,
// f32 accumulation, f32 corner reduction and compositing, sigma kept to f32
// accuracy in the keeps as a (hi, lo) bf16 pair. The transmittance is a
// direct product (the TPU takes exp(sum(log))) in another association
// order than the twin's, which differs by rounding.

#include "field_mlp.cuh"

namespace {

constexpr int kCF = 64, kHid = 128, kNC = 3 + kCF, kKW = kCF + 5;
constexpr int kLdf = kCF + 4; // f32 feature rows: make_layout's ldf
constexpr int kFBytes = 16 * kLdf * 4;  // a warp's feature rows
constexpr int kMinFin = 176;  // input rows at least this wide: room for
                              // the feature rows and the scratch

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// A team of nw warps: one warp, or the nw warps of one ray.
__device__ __forceinline__ void team_sync(int team, int nw) {
  if (nw == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(32 * nw)
                 : "memory");
}

// Shared memory as field_mlp.cuh:make_layout lays it out for a tile of 16
// warps: past a warp's feature rows [16][kLdf] f32 lies the compositing's
// scratch; the gather stages its corner weights [16][8] f32 a warp.
Layout march_layout(int fin, bool gather) {
  return make_layout<kHid, kCF>(fin, kPoints,
                                gather ? size_t(kPoints) * 8 * 4 : 0,
                                kMinFin);
}

// the compositing's scratch of a warp: past its feature rows
constexpr int scratch_bytes(int ldx) { return 16 * ldx * 2 - kFBytes; }

// ---------------------------------------------------------------------------
// input stages: one warp, its 16 samples from global row pt0 (valid of
// them; the rest are zero rows)
// ---------------------------------------------------------------------------

// Gather the corner texels from the planes by the samples' cells and
// corner-reduce them (field_mlp.cuh:gather_inputs).
struct GatherIn {
  PlanePair pl;
  const int* rows;   // [R * S][2]
  const float* aux;  // [R * S][n_pe + 8]
  int n_pe;

  __device__ void operator()(unsigned char* smem, const Layout& L, long pt0,
                             int valid, int warp, int lane) const {
    gather_inputs(smem, L, pl, rows, aux, pt0, valid, n_pe, warp, lane);
  }
};

// Copy the already-reduced MLP input rows [fin] bf16.
struct CopyIn {
  const bf16* x;

  __device__ void operator()(unsigned char* smem, const Layout& L, long pt0,
                             int valid, int warp, int lane) const {
    // copy_inputs indexes from the block tile's first row
    copy_inputs(smem, L, x, pt0 - 16 * warp, valid + 16 * warp, warp, lane);
  }
};

// ---------------------------------------------------------------------------
// compositing: one team, its n valid samples (whole rays) from block row
// row0 and global row pt0; the MLP left feat in each warp's feature rows,
// sigma in sSig and raw rgb in sRgb, at block rows
// ---------------------------------------------------------------------------

struct Maps {
  unsigned char* smem;
  const float* sSig;
  const float* sRgb;
  size_t warp_bytes;
  size_t x;

  __device__ Maps(unsigned char* s, const Layout& L)
      : smem(s),
        sSig(reinterpret_cast<const float*>(s + L.sig)),
        sRgb(reinterpret_cast<const float*>(s + L.rgb)),
        warp_bytes(size_t(16) * L.ldx * 2),
        x(L.x) {}

  __device__ const float* feat(int row) const {
    return reinterpret_cast<const float*>(smem + x + (row >> 4) * warp_bytes) +
           (row & 15) * kLdf;
  }

  // channel c of the rgbmap row for block row `row`: sigmoid(rgb) or feat
  __device__ float channel(int row, int c) const {
    return c < 3 ? sigmoidf(sRgb[row * 3 + c]) : feat(row)[c - 3];
  }

  // the scratch of the warp holding block row `row`
  __device__ float* scratch(int row) const {
    return reinterpret_cast<float*>(smem + x + (row >> 4) * warp_bytes +
                                    kFBytes);
  }
};

// dst (16-byte aligned) <- src (shared, 16-byte aligned), count bf16
__device__ void copy_out(bf16* dst, const bf16* src, int count, int tid,
                         int nthreads) {
  const int nchunk = count / 8;
  for (int j = tid; j < nchunk; j += nthreads)
    reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(src)[j];
  for (int j = nchunk * 8 + tid; j < count; j += nthreads) dst[j] = src[j];
}

// One warp: the keeps of its even samples (rows row0 .. row0 + valid),
// packed [feat | rgb | sigma_hi | sigma_lo] in its scratch, then written
// to their rows of global memory, one 16-byte aligned span (pt0 % 16 == 0).
__device__ void warp_keeps(const Maps& m, int row0, long pt0, int valid,
                           int lane, bf16* keeps) {
  bf16* sKeep = reinterpret_cast<bf16*>(m.scratch(row0));  // [8][kKW]
  const int nkeep = (valid / 2) * kKW;
  for (int e = lane; e < nkeep; e += 32) {
    const int kr = e / kKW, c = e - kr * kKW, r = row0 + 2 * kr;
    bf16 v;
    if (c < kCF) {
      v = __float2bfloat16(m.feat(r)[c]);
    } else if (c < kCF + 3) {
      v = __float2bfloat16(m.sRgb[r * 3 + c - kCF]);
    } else {
      const bf16 hi = __float2bfloat16(m.sSig[r]);
      v = c == kCF + 3 ? hi : __float2bfloat16(m.sSig[r] - __bfloat162float(hi));
    }
    sKeep[e] = v;
  }
  __syncwarp();
  copy_out(keeps + (pt0 / 2) * kKW, sKeep, nkeep, lane, 32);
}

// A warp's scratch (floats): its keeps [8][kKW] bf16, its weights [16],
// its partial per-ray sums [kNC] and the product of its samples' 1 - alpha
// + 1e-10 (both read by the other warps of a ray of S > 16 samples).
constexpr int kWOff = 8 * kKW * 2 / 4, kPartOff = kWOff + 16,
              kTotOff = kPartOff + kNC;

// One warp: the compositing of its 16 samples (valid of them, whole rays
// or, for S > 16, a 16-sample part of one ray that its team's S / 16 warps
// share). Alpha and the transmittance a lane a sample, as a segmented
// prefix product over the lanes; the parts of a longer ray pass their
// products and their partial sums through shared memory, summed in warp
// order.
__device__ void coarse_warp(const Maps& m, int team, int nw, int wi,
                            int warp, int lane, long wpt0, int valid, int S,
                            const float* __restrict__ dists, float* rgbmap,
                            float* weights) {
  const int row0 = 16 * warp, seg = min(S, 16), pos = lane & (seg - 1);
  float* scr = m.scratch(row0);
  float alpha = 0.f, om = 1.f;
  if (lane < valid) {
    alpha = 1.f - expf(-fmaxf(m.sSig[row0 + lane], 0.f) * dists[wpt0 + lane]);
    om = 1.f - alpha + 1e-10f;
  }
  float inc = om;
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, inc, off);
    if (off < seg && pos >= off) inc *= u;
  }
  float T = __shfl_up_sync(0xffffffffu, inc, 1);
  if (pos == 0) T = 1.f;
  // S > 16: the team is one ray, its warps wi = 0 .. S / 16 - 1 in order
  if (S > 16) {
    if (lane == 15) scr[kTotOff] = inc;
    team_sync(team, nw);
    for (int w2 = 0; w2 < wi; ++w2)
      T *= m.scratch(16 * (warp - wi + w2))[kTotOff];
  }
  if (lane < valid) {
    const float w = alpha * T;
    weights[wpt0 + lane] = w;
    scr[kWOff + lane] = w;
  }
  __syncwarp();
  // per-ray sums over the warp's samples, lanes over channels (lane,
  // lane + 32, lane + 64)
  for (int r = 0; r < valid / seg; ++r) {
    float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < seg; ++s) {
      const int row = row0 + r * seg + s;
      const float w = scr[kWOff + r * seg + s];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int c = lane + 32 * q;
        if (c < kNC) acc[q] += w * m.channel(row, c);
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c = lane + 32 * q;
      if (c >= kNC) continue;
      if (S <= 16)
        rgbmap[(wpt0 / S + r) * kNC + c] = acc[q];
      else
        scr[kPartOff + c] = acc[q];
    }
  }
  if (S > 16) {
    team_sync(team, nw);
    if (wi == 0)
      for (int c = lane; c < kNC; c += 32) {
        float acc = 0.f;
        for (int w2 = 0; w2 < S / 16; ++w2)
          acc += m.scratch(16 * (warp + w2))[kPartOff + c];
        rgbmap[(wpt0 / S) * kNC + c] = acc;
      }
    team_sync(team, nw);  // totals and partials read before their reuse
  }
}

// the fine compositing's scratch: 4 floats an element of the team's rays,
// in its first warp's scratch
__host__ __device__ constexpr int fine_elements(int nw, int Sn, int Sk) {
  return (16 * nw / Sn) * (Sk + Sn);
}

__device__ void fine_team(unsigned char* smem, const Layout& L, int team,
                          int nw, int tid, long pt0, int n, int Sn, int Sk,
                          const bf16* __restrict__ keeps,
                          const float* __restrict__ dcat,
                          const int* __restrict__ ranks, float* rgbmap,
                          float* wout) {
  const int lane = tid & 31, wi = tid >> 5, row0 = 16 * nw * team;
  const int Sa = Sk + Sn, nr = n / Sn, E = nr * Sa, nt = 32 * nw;
  const long ray0 = pt0 / Sn;
  const Maps m(smem, L);
  float* sAl = m.scratch(row0);
  int* sRk = reinterpret_cast<int*>(sAl + E);
  float* sT = reinterpret_cast<float*>(sRk + E);  // by rank: 1 - alpha, then T
  float* sWe = sT + E;

  // alpha of every concat element [keeps | new], 1 - alpha into its rank
  for (int e = tid; e < E; e += nt) {
    const int r = e / Sa, k = e - r * Sa;
    const long ray = ray0 + r;
    float sig;
    if (k < Sk) {
      const bf16* kr = keeps + (ray * Sk + k) * kKW;
      sig = __bfloat162float(kr[kCF + 3]) + __bfloat162float(kr[kCF + 4]);
    } else {
      sig = m.sSig[row0 + r * Sn + k - Sk];
    }
    const float alpha = 1.f - expf(-fmaxf(sig, 0.f) * dcat[ray * Sa + k]);
    const int rk = min(max(ranks[ray * Sa + k], 0), Sa - 1);
    sAl[e] = alpha;
    sRk[e] = rk;
    sT[r * Sa + rk] = 1.f - alpha + 1e-10f;
  }
  team_sync(team, nw);
  // exclusive product in sorted order: a warp a ray, 32 ranks at a time
  for (int r = wi; r < nr; r += nw) {
    float carry = 1.f;
    for (int j0 = 0; j0 < Sa; j0 += 32) {
      const int j = j0 + lane;
      float inc = j < Sa ? sT[r * Sa + j] : 1.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc *= u;
      }
      float ex = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) ex = 1.f;
      if (j < Sa) sT[r * Sa + j] = carry * ex;
      carry *= __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  team_sync(team, nw);
  for (int e = tid; e < E; e += nt) {
    const int r = e / Sa, k = e - r * Sa;
    const float w = sAl[e] * sT[r * Sa + sRk[e]];
    sWe[e] = w;
    wout[(ray0 + r) * Sa + k] = w;
  }
  team_sync(team, nw);
  // per-ray sums, a warp a ray, lanes over channels (lane, lane + 32,
  // lane + 64): the keeps read once, 8 keep rows' loads in flight
  for (int r = wi; r < nr; r += nw) {
    const long ray = ray0 + r;
    const bf16* kp = keeps + ray * Sk * kKW;
    float acc_k[3] = {0.f, 0.f, 0.f}, acc_n[3] = {0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < Sk; k0 += 8) {
      float v[8][3];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int k = k0 + kk, c = lane + 32 * q;
          v[kk][q] = k < Sk && c < kNC
                         ? __bfloat162float(
                               kp[k * kKW + (c < 3 ? kCF + c : c - 3)])
                         : 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (k0 + kk >= Sk) break;
        const float w = sWe[r * Sa + k0 + kk];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int c = lane + 32 * q;
          acc_k[q] += w * (c < 3 ? sigmoidf(v[kk][q]) : v[kk][q]);
        }
      }
    }
    for (int s = 0; s < Sn; ++s) {
      const float w = sWe[r * Sa + Sk + s];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int c = lane + 32 * q;
        if (c < kNC) acc_n[q] += w * m.channel(row0 + r * Sn + s, c);
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c = lane + 32 * q;
      if (c < kNC) rgbmap[ray * kNC + c] = acc_k[q] + acc_n[q];
    }
  }
  team_sync(team, nw);  // scratch read before the next tile's input stage
}

// ---------------------------------------------------------------------------
// the kernels: a persistent block walks team tiles of 16 * nw samples
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int team_warps(int S) {
  return S > 16 ? S / 16 : 1;
}

template <class In>
__global__ void __launch_bounds__(kThreads, 1)
coarse_kernel(In in, const float* __restrict__ dists, Weights w,
              float* rgbmap, float* weights, bf16* keeps, int R, int S,
              Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = team_warps(S), teams = kWarps / nw;
  const int team = warp / nw, wi = warp - team * nw;
  const long total = long(R) * S, per = 16L * nw;
  const long ntt = (total + per - 1) / per;

  stage_weights<kHid, kCF>(smem, L, w);
  __syncthreads();
  if (team >= teams) return;  // warps no team takes (S = 128)
  for (long tt = long(blockIdx.x) * teams + team; tt < ntt;
       tt += long(gridDim.x) * teams) {
    const long pt0 = tt * per, wpt0 = pt0 + 16 * wi;
    const int n = int(min(per, total - pt0));
    const int wvalid = max(0, min(16, n - 16 * wi));
    in(smem, L, wpt0, wvalid, warp, lane);
    __syncwarp();
    mlp_warp<kHid, kCF>(smem, L, warp, lane);
    __syncwarp();
    const Maps m(smem, L);
    warp_keeps(m, 16 * warp, wpt0, wvalid, lane, keeps);
    coarse_warp(m, team, nw, wi, warp, lane, wpt0, wvalid, S, dists, rgbmap,
                weights);
  }
}

template <class In>
__global__ void __launch_bounds__(kThreads, 1)
fine_kernel(In in, const bf16* __restrict__ keeps,
            const float* __restrict__ dcat, const int* __restrict__ ranks,
            Weights w, float* rgbmap, float* wout, int R, int Sn, int Sk,
            Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = team_warps(Sn), teams = kWarps / nw;
  const int team = warp / nw, wi = warp - team * nw;
  const long total = long(R) * Sn, per = 16L * nw;
  const long ntt = (total + per - 1) / per;

  stage_weights<kHid, kCF>(smem, L, w);
  __syncthreads();
  if (team >= teams) return;  // warps no team takes (Sn = 128)
  for (long tt = long(blockIdx.x) * teams + team; tt < ntt;
       tt += long(gridDim.x) * teams) {
    const long pt0 = tt * per;
    const int n = int(min(per, total - pt0));
    in(smem, L, pt0 + 16 * wi, max(0, min(16, n - 16 * wi)), warp, lane);
    __syncwarp();
    mlp_warp<kHid, kCF>(smem, L, warp, lane);
    team_sync(team, nw);
    fine_team(smem, L, team, nw, 32 * wi + lane, pt0, n, Sn, Sk, keeps, dcat,
              ranks, rgbmap, wout);
  }
}

// samples a ray: a power of two up to 128 (a ray spans at most 8 warps)
bool samples_ok(int S) { return S > 0 && 128 % S == 0; }

// the fine compositing's scratch fits its warp's
bool fine_scratch_ok(const Layout& L, int Sn, int Sk) {
  return 16L * fine_elements(team_warps(Sn), Sn, Sk) <= scratch_bytes(L.ldx);
}

bool gather_dims_ok(int B, int H, int W, int R, int C, int n_pe) {
  return B > 0 && H >= 2 && W >= 2 && R % B == 0 && C == kPlaneC &&
         n_pe >= 0 && n_pe % 4 == 0 && n_pe + 8 <= 64 &&
         (2 * C + n_pe) % 16 == 0;
}

Weights weights_of(const void* w0, const void* b0, const void* w1,
                   const void* b1, const void* wh, const void* bh,
                   const void* wr, const void* br) {
  return Weights{(const bf16*)w0, (const bf16*)w1, (const bf16*)wh,
                 (const bf16*)wr, (const float*)b0, (const float*)b1,
                 (const float*)bh, (const float*)br};
}

GatherIn gather_in(const void* pxy, const void* pzy, const void* rows,
                   const void* aux, int B, int H, int W, int R, int S,
                   int n_pe) {
  const PlanePair pl{(const bf16*)pxy, (const bf16*)pzy,
                     long(H) * W * kPlaneC, long(R / B) * S, W,
                     (H - 1) * (W - 1) - 1};
  return GatherIn{pl, (const int*)rows, (const float*)aux, n_pe};
}

template <class K, class... Args>
int launch(K kern, const Layout& L, long rows, void* stream, Args... args) {
  const long per_block = long(kPoints);
  int grid = 0;
  cudaError_t e = launch_config(kern, kThreads, L.total,
                                (rows + per_block - 1) / per_block, &grid);
  if (e != cudaSuccess) return int(e);
  kern<<<grid, kThreads, L.total, (cudaStream_t)stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* march_error_string(int e) {
  return cudaGetErrorString(cudaError_t(e));
}

// 1 if the fine kernels' compositing scratch holds num_keep (Sk) + Sn
// elements a ray at MLP input width fin, else 0.
int march_fine_fits(int Sn, int Sk, int fin) {
  return samples_ok(Sn) && Sk >= 0 && fin > 0 &&
         fine_scratch_ok(march_layout(fin, false), Sn, Sk);
}

int march_coarse(const void* pxy, const void* pzy, const void* rows,
                 const void* aux, const void* dists, const void* w0,
                 const void* b0, const void* w1, const void* b1,
                 const void* wh, const void* bh, const void* wr,
                 const void* br, void* rgbmap, void* weights, void* keeps,
                 int B, int H, int W, int R, int S, int C, int n_pe, int hid,
                 int cf, void* stream) {
  if (hid != kHid || cf != kCF || S % 2 || !samples_ok(S) ||
      !gather_dims_ok(B, H, W, R, C, n_pe))
    return int(cudaErrorInvalidValue);
  if (R == 0) return int(cudaSuccess);
  const Layout L = march_layout(2 * C + n_pe, true);
  return launch(coarse_kernel<GatherIn>, L, long(R) * S, stream,
                gather_in(pxy, pzy, rows, aux, B, H, W, R, S, n_pe),
                (const float*)dists, weights_of(w0, b0, w1, b1, wh, bh, wr, br),
                (float*)rgbmap, (float*)weights, (bf16*)keeps, R, S, L);
}

int march_fine(const void* pxy, const void* pzy, const void* rows,
               const void* aux, const void* keeps, const void* dcat,
               const void* ranks, const void* w0, const void* b0,
               const void* w1, const void* b1, const void* wh,
               const void* bh, const void* wr, const void* br, void* rgbmap,
               void* wout, int B, int H, int W, int R, int Sn, int Sk, int C,
               int n_pe, int hid, int cf, void* stream) {
  if (hid != kHid || cf != kCF || Sk < 0 || !samples_ok(Sn) ||
      !gather_dims_ok(B, H, W, R, C, n_pe))
    return int(cudaErrorInvalidValue);
  const Layout L = march_layout(2 * C + n_pe, true);
  if (!fine_scratch_ok(L, Sn, Sk)) return int(cudaErrorInvalidValue);
  if (R == 0) return int(cudaSuccess);
  return launch(fine_kernel<GatherIn>, L, long(R) * Sn, stream,
                gather_in(pxy, pzy, rows, aux, B, H, W, R, Sn, n_pe),
                (const bf16*)keeps, (const float*)dcat, (const int*)ranks,
                weights_of(w0, b0, w1, b1, wh, bh, wr, br), (float*)rgbmap,
                (float*)wout, R, Sn, Sk, L);
}

int march_coarse_x(const void* x, const void* dists, const void* w0,
                   const void* b0, const void* w1, const void* b1,
                   const void* wh, const void* bh, const void* wr,
                   const void* br, void* rgbmap, void* weights, void* keeps,
                   int R, int S, int fin, int hid, int cf, void* stream) {
  if (hid != kHid || cf != kCF || S % 2 || !samples_ok(S) || fin <= 0 ||
      fin % 16)
    return int(cudaErrorInvalidValue);
  if (R == 0) return int(cudaSuccess);
  const Layout L = march_layout(fin, false);
  return launch(coarse_kernel<CopyIn>, L, long(R) * S, stream,
                CopyIn{(const bf16*)x}, (const float*)dists,
                weights_of(w0, b0, w1, b1, wh, bh, wr, br), (float*)rgbmap,
                (float*)weights, (bf16*)keeps, R, S, L);
}

int march_fine_x(const void* xn, const void* keeps, const void* dcat,
                 const void* ranks, const void* w0, const void* b0,
                 const void* w1, const void* b1, const void* wh,
                 const void* bh, const void* wr, const void* br, void* rgbmap,
                 void* wout, int R, int Sn, int Sk, int fin, int hid, int cf,
                 void* stream) {
  if (hid != kHid || cf != kCF || Sk < 0 || !samples_ok(Sn) || fin <= 0 ||
      fin % 16)
    return int(cudaErrorInvalidValue);
  const Layout L = march_layout(fin, false);
  if (!fine_scratch_ok(L, Sn, Sk)) return int(cudaErrorInvalidValue);
  if (R == 0) return int(cudaSuccess);
  return launch(fine_kernel<CopyIn>, L, long(R) * Sn, stream,
                CopyIn{(const bf16*)xn}, (const bf16*)keeps,
                (const float*)dcat, (const int*)ranks,
                weights_of(w0, b0, w1, b1, wh, bh, wr, br), (float*)rgbmap,
                (float*)wout, R, Sn, Sk, L);
}

}  // extern "C"
