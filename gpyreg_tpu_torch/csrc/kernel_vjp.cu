// One-pass hyperparameter gradient of the fused self-covariance, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel gpyreg_tpu/ops/pallas_kernels.py
// `_make_vjp_kernel` (launched by `_vjp_pallas` through
// `_kernel_self_fused_bwd`).  For K = sf2 * profile(t2) with
// t2_ij = sum_k (xs_ik - xs_jk)^2 and the upstream cotangent Gbar (N, N),
// any matrix, it computes with P = dK/dt2 and E = -2 * Gbar * P
//
//     ARD:  g_k = sum_ij E_ij (xs_ik - xs_jk)^2          (k = 0 .. D-1)
//     iso:  g_0 = sum_ij E_ij t2_ij
//     then  2 * sum_ij Gbar_ij K_ij                       (d / d log sf)
//     rq:   sum_ij Gbar_ij K_ij (t2 / (2 M) - alpha log M), M = 1 + t2/(2 alpha)
//
// so the gradient row has 2 (iso), D + 2 (rq) or D + 1 values.  P follows
// `pallas_kernels._dprofile`: the Matern derivatives are forced to 0 where
// t2 == 0, off the diagonal too (duplicate points), so Matern-1/2 gives no
// 0 * inf.
//
// What bounds it: reading Gbar once, N^2 * 4 bytes (1.07 GB, 0.32 ms at
// 3.35 TB/s, at N = 16384).  The arithmetic, about 5D + 6 FP32 operations
// per entry for ARD, most of them not FMAs, costs as many issue slots as
// that read.  The design halves the arithmetic and overlaps it with the
// read:
//
// - folded pairs: every term other than Gbar is symmetric in (i, j) (t2_ij
//   and t2_ji are the same float), so sum_ij Gbar_ij f_ij equals the sum
//   over i < j of (Gbar_ij + Gbar_ji) f_ij plus the diagonal, for any
//   Gbar.  The plane is cut into square 64 x 64 tiles; a work item is an
//   unordered tile pair (I, J), I <= J.  For I < J the block reads the tile
//   Gbar[I, J] and its mirror Gbar[J, I], and evaluates t2, K, P and E once
//   per entry from Gbar_ij + Gbar_ji; a diagonal tile is read once and adds
//   each entry once.  The mirror is read through shared memory, both
//   global reads stay coalesced, and the 128-byte swizzle of the tile
//   (tile_common.cuh) keeps the transposed reads free of bank conflicts;
// - a persistent grid, two blocks of 256 threads per SM, walks the pairs
//   in a fixed static order; the Gbar tiles of the next-but-one pair come
//   in by TMA (cp.async.bulk.tensor with an mbarrier) into a two-stage ring,
//   and their rows of xs by cp.async, while the current pair computes;
// - exact D: the dimensions are staged 16 at a time and the unrolled loops
//   skip those past D with a uniform branch; for D <= 16 the ARD pass
//   reuses the staged chunk, and for D > 16 each further chunk is staged
//   once per pass.  The workloads' D = 8 and D = 10 have instantiations
//   whose loops over the chunk have compile-time bounds, which the compiler
//   schedules as straight-line code;
// - t2 is the direct sum of squared differences, and the ARD contraction
//   the direct sum_ij E_ij (xs_ik - xs_jk)^2, not the TPU kernel's
//   expansion, which cancels when the data sit far from the origin;
// - sums: each thread adds its 16 entries of a pair in float32 and the
//   pair's sums into float64 registers (for D > 16, the ARD sums go warp by
//   warp into float64 shared memory), so a block keeps its running sums
//   across all of its pairs and writes one row of float64 partials at the
//   end (264 rows on a 132-SM card, not 32,768 at N = 16384).  A second
//   launch sums each column of partials in a fixed order.  No atomics: the
//   result is the same bit for bit from launch to launch;
// - TMA needs a 16-byte-aligned base and a row stride that is a multiple
//   of 16 bytes (N % 4 == 0).  For other N, or another base, the same tiles
//   come in by 4-byte cp.async into the same swizzled layout.  The wrapper
//   picks the path from N and the base (a dispatch on shape) and counts it
//   on its own key;
// - ragged edges read Gbar = 0 (TMA's and cp.async's zero fill) and add
//   nothing; offsets are 64-bit, the profile is a template parameter, and
//   the library is not built with --use_fast_math.
//
// Changed from the first CUDA version of this kernel: that one launched one
// block per 64 x 128 tile of the whole plane, read Gbar with scalar loads
// only after its first pass over the dimensions, ran all 16 dimensions of
// its chunk whatever D was, staged xs again for the ARD pass, evaluated
// every off-diagonal entry twice, and wrote one row of partials per block.
//
// Build (plain C interface, loaded with ctypes by ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "tile_common.cuh"

namespace {

using namespace tile;

constexpr int kReduceThreads = 256;

enum Profile { kSE = 0, kM1 = 1, kM3 = 2, kM5 = 3, kRQ = 4 };

// Shared memory, in floats from a 1024-byte-aligned base: two ring stages
// of [Gbar tile, mirror tile, xs rows of I, xs rows of J], one more pair of
// chunk buffers for dimensions past the first 16, two mbarriers, then the
// float64 block sums [kWarps][width].
constexpr int kStageFloats = 2 * kTileFloats + 2 * kXsFloats;
constexpr int kExtraOffset = 2 * kStageFloats;
constexpr int kBarOffset = kExtraOffset + 2 * kXsFloats;
constexpr int kRedOffset = kBarOffset + 4;  // two 8-byte mbarriers

size_t smem_bytes(int width) {
  return kRedOffset * sizeof(float) + kWarps * width * sizeof(double) + 1024;
}

// K = sf2 * profile(t2) and P = dK/dt2 (0 at t2 == 0 for the Materns).
template <int P>
__device__ __forceinline__ void value_and_slope(float t2, float sf2,
                                                float alpha, float& k,
                                                float& p) {
  if (P == kSE) {
    k = sf2 * expf(-0.5f * t2);
    p = -0.5f * k;
  } else if (P == kRQ) {
    const float m = 1.0f + 0.5f * t2 / alpha;
    k = sf2 * powf(m, -alpha);
    p = -0.5f * k / m;
  } else {
    const float deg = P == kM1 ? 1.0f : (P == kM3 ? 3.0f : 5.0f);
    const float t = sqrtf(deg * t2);
    const float em = expf(-t);
    if (P == kM1) {
      k = sf2 * em;
      p = t2 > 0.0f ? -sf2 * em * 0.5f / t : 0.0f;
    } else if (P == kM3) {
      k = sf2 * (1.0f + t) * em;
      p = t2 > 0.0f ? -sf2 * em * 1.5f : 0.0f;
    } else {
      k = sf2 * (1.0f + t * (1.0f + t / 3.0f)) * em;
      p = t2 > 0.0f ? -sf2 * em * (1.0f + t) * (5.0f / 6.0f) : 0.0f;
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// gk[k] = sum over the thread's block of E (xi[4a+r] - xj[4b+c])^2 for the
// dimensions k < kd of two staged chunks (unconditional loads, as in
// add_sq_dist).
__device__ __forceinline__ void ard_sums(float (&gk)[kChunkD],
                                         const float (&e)[4][4],
                                         const float* si, const float* sj,
                                         int a, int b, int kd) {
#pragma unroll
  for (int k = 0; k < kChunkD; ++k) {
    gk[k] = 0.0f;
    const float4 x = *reinterpret_cast<const float4*>(si + k * kT + 4 * a);
    const float4 z = *reinterpret_cast<const float4*>(sj + k * kT + 4 * b);
    if (k < kd) {
      const float xv[4] = {x.x, x.y, x.z, x.w};
      const float zv[4] = {z.x, z.y, z.z, z.w};
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float diff = xv[r] - zv[c];
          s = fmaf(e[r][c] * diff, diff, s);
        }
      gk[k] = s;
    }
  }
}

// Adds the warp's sums of gk[0 .. kd) to its float64 row: wred[k0 + k].
__device__ __forceinline__ void warp_add(double* wred,
                                         const float (&gk)[kChunkD], int k0,
                                         int kd) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kChunkD; ++k) {
    if (k < kd) {
      const double s = warp_sum(static_cast<double>(gk[k]));
      if (lane == 0) wred[k0 + k] += s;
    }
  }
}

// The Gbar tiles of pair (I, J), and the xs rows of I and J, into one ring
// stage; every thread calls it, and it commits one cp.async group.
template <bool Tma>
__device__ __forceinline__ void issue_pair(float* stage, uint64_t* bar,
                                           const Walker& w,
                                           const CUtensorMap* gmap,
                                           const float* gbar, const float* xs,
                                           int n, int d, int kd) {
  if (w.valid()) {
    const int r0 = w.i * kT;
    const int c0 = w.j * kT;
    const bool mirror = w.i != w.j;
    float* ga = stage;
    float* gb = stage + kTileFloats;
    if (Tma) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar, (mirror ? 2 : 1) * kTileFloats * sizeof(float));
        tma_load_box(ga, gmap, bar, c0, r0);
        tma_load_box(ga + kBoxFloats, gmap, bar, c0 + kBoxCols, r0);
        if (mirror) {
          tma_load_box(gb, gmap, bar, r0, c0);
          tma_load_box(gb + kBoxFloats, gmap, bar, r0 + kBoxCols, c0);
        }
      }
    } else {
      for (int e = threadIdx.x; e < (mirror ? 2 : 1) * kTileFloats;
           e += kThreads) {
        const int which = e / kTileFloats;
        const int r = (e >> 6) & (kT - 1);
        const int c = e & (kT - 1);
        const int gr = (which ? c0 : r0) + r;
        const int gc = (which ? r0 : c0) + c;
        const bool ok = gr < n && gc < n;
        cp_async4((which ? gb : ga) + swz(r, c),
                  ok ? gbar + static_cast<long long>(gr) * n + gc : gbar, ok);
      }
    }
    stage_rows_async<kT>(stage + 2 * kTileFloats, xs, n, d, r0, 0, kd);
    stage_rows_async<kT>(stage + 2 * kTileFloats + kXsFloats, xs, n, d, c0,
                         0, kd);
  }
  cp_async_commit();
}

template <int P, bool Iso, bool Tma, int KD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
kernel_vjp(const __grid_constant__ CUtensorMap gmap,
           const float* __restrict__ xs, const float* __restrict__ gbar,
           const float* __restrict__ sf2p, const float* __restrict__ alphap,
           double* __restrict__ partials, int n, int d, int width) {
  extern __shared__ unsigned char smem_raw[];
  float* sm = align1024(smem_raw);
  float* extra = sm + kExtraOffset;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + kBarOffset);
  double* red = reinterpret_cast<double*>(sm + kRedOffset);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  double* wred = red + warp * width;
  int a, b;
  quad_of(tid, a, b);
  // The specialised instantiations bound the loops over the dimensions of
  // the chunk at compile time (and nothing else: a compile-time D lets the
  // compiler hoist both passes' loads and spill).
  const int kd = KD ? KD : min(d, kChunkD);
  const bool multi = d > kChunkD;
  const float sf2 = *sf2p;
  const float alpha = *alphap;
  const int nt = (n + kT - 1) / kT;
  const long long step = gridDim.x;

  for (int i = tid; i < kWarps * width; i += kThreads) red[i] = 0.0;
  if (Tma && tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  Walker cur(nt, nt, true, blockIdx.x);
  Walker pre = cur;
  for (int s = 0; s < 2; ++s) {
    issue_pair<Tma>(sm + s * kStageFloats, &bars[s], pre, &gmap, gbar, xs, n,
                    d, kd);
    pre.advance(step);
  }

  double acc_k[kChunkD];
#pragma unroll
  for (int k = 0; k < kChunkD; ++k) acc_k[k] = 0.0;
  double acc_gk = 0.0, acc_t2 = 0.0, acc_rq = 0.0;

  for (int t = 0; cur.valid(); ++t, cur.advance(step)) {
    const int s = t & 1;
    float* stage = sm + s * kStageFloats;
    const float* ga = stage;
    const float* gb = stage + kTileFloats;
    const float* si = stage + 2 * kTileFloats;
    const float* sj = si + kXsFloats;
    const int r0 = cur.i * kT;
    const int c0 = cur.j * kT;

    cp_async_wait<1>();
    if (Tma) mbar_wait(&bars[s], (t >> 1) & 1);
    __syncthreads();

    // Gbar_ij (+ Gbar_ji for an off-diagonal pair) of the thread's block.
    float g[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(ga + swz(4 * a + r, 4 * b));
      g[r][0] = v.x;
      g[r][1] = v.y;
      g[r][2] = v.z;
      g[r][3] = v.w;
    }
    if (cur.i != cur.j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 v =
            *reinterpret_cast<const float4*>(gb + swz(4 * b + c, 4 * a));
        g[0][c] += v.x;
        g[1][c] += v.y;
        g[2][c] += v.z;
        g[3][c] += v.w;
      }
    }

    // Pass 1: t2 by direct differences.
    float t2[1][4][4];
    float (&e)[4][4] = t2[0];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) e[r][c] = 0.0f;
    add_sq_dist<1>(t2, si, kT, sj, kT, a, b, kd);
    for (int k0 = kChunkD; k0 < d; k0 += kChunkD) {
      const int kc = min(kChunkD, d - k0);
      stage_rows_sync<kT>(extra, xs, n, d, r0, k0, kc);
      stage_rows_sync<kT>(extra + kXsFloats, xs, n, d, c0, k0, kc);
      __syncthreads();
      add_sq_dist<1>(t2, extra, kT, extra + kXsFloats, kT, a, b, kc);
      __syncthreads();
    }

    // K, P and E per entry; e[r][c] turns from t2 into E.
    float s_gk = 0.0f, s_t2 = 0.0f, s_rq = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float q =
            r0 + 4 * a + r == c0 + 4 * b + c ? 0.0f : fmaxf(e[r][c], 0.0f);
        float kv, p;
        value_and_slope<P>(q, sf2, alpha, kv, p);
        const float gg = g[r][c];
        const float gkv = gg * kv;
        s_gk += gkv;
        e[r][c] = -2.0f * gg * p;
        if (Iso) s_t2 = fmaf(e[r][c], q, s_t2);
        if (P == kRQ) {
          const float mm = 1.0f + 0.5f * q / alpha;
          s_rq = fmaf(gkv, 0.5f * q / mm - alpha * logf(mm), s_rq);
        }
      }
    acc_gk += s_gk;
    if (Iso) acc_t2 += s_t2;
    if (P == kRQ) acc_rq += s_rq;

    // Pass 2 (ARD): g_k = sum E (xs_ik - xs_jk)^2 over the staged chunk,
    // then over each further chunk.
    if (!Iso) {
      float gk[kChunkD];
      ard_sums(gk, e, si, sj, a, b, kd);
      if (!multi) {
#pragma unroll
        for (int k = 0; k < kChunkD; ++k)
          if (k < kd) acc_k[k] += static_cast<double>(gk[k]);
      } else {
        warp_add(wred, gk, 0, kd);
        for (int k0 = kChunkD; k0 < d; k0 += kChunkD) {
          const int kc = min(kChunkD, d - k0);
          stage_rows_sync<kT>(extra, xs, n, d, r0, k0, kc);
          stage_rows_sync<kT>(extra + kXsFloats, xs, n, d, c0, k0, kc);
          __syncthreads();
          ard_sums(gk, e, extra, extra + kXsFloats, a, b, kc);
          warp_add(wred, gk, k0, kc);
          __syncthreads();
        }
      }
    }

    // Every thread is past its reads of this ring stage.
    __syncthreads();
    issue_pair<Tma>(stage, &bars[s], pre, &gmap, gbar, xs, n, d, kd);
    pre.advance(step);
  }

  // The block's row: [sum E t2, 2 sum Gbar K] (iso) or [g_0 .. g_{D-1},
  // 2 sum Gbar K, (rq) the alpha term], warp sums in float64, then the
  // warps in order.
  if (Iso) {
    const double v0 = warp_sum(acc_t2);
    const double v1 = warp_sum(2.0 * acc_gk);
    if (lane == 0) {
      wred[0] += v0;
      wred[1] += v1;
    }
  } else {
    if (!multi) {
#pragma unroll
      for (int k = 0; k < kChunkD; ++k) {
        if (k < kd) {
          const double v = warp_sum(acc_k[k]);
          if (lane == 0) wred[k] += v;
        }
      }
    }
    const double v = warp_sum(2.0 * acc_gk);
    if (lane == 0) wred[d] += v;
    if (P == kRQ) {
      const double w = warp_sum(acc_rq);
      if (lane == 0) wred[d + 1] += w;
    }
  }
  __syncthreads();
  for (int i = tid; i < width; i += kThreads) {
    double total = 0.0;
    for (int w = 0; w < kWarps; ++w) total += red[w * width + i];
    partials[static_cast<long long>(blockIdx.x) * width + i] = total;
  }
}

// out[w] = sum_b partials[b * width + w], in float64 in a fixed order,
// rounded once to float32.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const double* __restrict__ partials, long long blocks,
                int width, float* __restrict__ out) {
  __shared__ double s[kReduceThreads];
  const int w = blockIdx.x;
  double t = 0.0;
  for (long long b = threadIdx.x; b < blocks; b += kReduceThreads)
    t += partials[b * width + w];
  s[threadIdx.x] = t;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[w] = static_cast<float>(s[0]);
}

template <int P, bool Iso>
int launch(int tma, const float* xs, const float* gbar, const float* sf2,
           const float* alpha, double* partials, int n, int d, int width,
           long long blocks, cudaStream_t stream) {
  CUtensorMap map{};
  if (tma) {
    const int rc = make_tile_map(&map, gbar, n, n);
    if (rc != 0) return rc;
  }
  auto pick = [d](auto k0, auto k8, auto k10) {
    return specialised_d(d) == 8 ? k8 : (specialised_d(d) == 10 ? k10 : k0);
  };
  auto kern = tma ? pick(kernel_vjp<P, Iso, true, 0>,
                         kernel_vjp<P, Iso, true, 8>,
                         kernel_vjp<P, Iso, true, 10>)
                  : pick(kernel_vjp<P, Iso, false, 0>,
                         kernel_vjp<P, Iso, false, 8>,
                         kernel_vjp<P, Iso, false, 10>);
  const size_t smem = smem_bytes(width);
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      map, xs, gbar, sf2, alpha, partials, n, d, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory a block takes for a gradient row of `width`.
long long kernel_vjp_smem_bytes(int width) { return smem_bytes(width); }

// Side of the square tiles, whose unordered pairs the kernel walks.
int kernel_vjp_tile() { return kT; }

// Blocks (rows of float64 partials) of a launch over `pairs` tile pairs.
long long kernel_vjp_grid(long long pairs) { return persistent_grid(pairs); }

// Width of the gradient row: 2 (iso), D + 2 (rq) or D + 1.
int kernel_vjp_width(int profile, int iso, int d) {
  return iso ? 2 : (profile == kRQ ? d + 2 : d + 1);
}

// Launches the gradient contraction and its reduction on `stream`.  `xs`
// (n, d) and `gbar` (n, n) are contiguous float32, `sf2` and `alpha` point
// to one float each on the device, `partials` is float64 scratch of
// `blocks` = kernel_vjp_grid(pairs) rows of kernel_vjp_width(...) values,
// `out` float32 of that width.  `tma` selects the TMA loads (n % 4 == 0 and
// a 16-byte-aligned gbar) or the 4-byte cp.async loads.  Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for an unknown profile, an isotropic rq, or
// arguments the kernel does not take.
int kernel_vjp_launch(int profile, int iso, int tma, const float* xs,
                      const float* gbar, const float* sf2, const float* alpha,
                      double* partials, float* out, long long n, int d,
                      long long blocks, void* stream) {
  if (n <= 0 || d <= 0 || n >= (1LL << 31) || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = kernel_vjp_width(profile, iso, d);
  const int ni = static_cast<int>(n);
  int rc;
  if (iso) {
    switch (profile) {
      case kSE: rc = launch<kSE, true>(tma, xs, gbar, sf2, alpha, partials, ni, d, width, blocks, s); break;
      case kM1: rc = launch<kM1, true>(tma, xs, gbar, sf2, alpha, partials, ni, d, width, blocks, s); break;
      case kM3: rc = launch<kM3, true>(tma, xs, gbar, sf2, alpha, partials, ni, d, width, blocks, s); break;
      case kM5: rc = launch<kM5, true>(tma, xs, gbar, sf2, alpha, partials, ni, d, width, blocks, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (profile) {
      case kSE: rc = launch<kSE, false>(tma, xs, gbar, sf2, alpha, partials, ni, d, width, blocks, s); break;
      case kM1: rc = launch<kM1, false>(tma, xs, gbar, sf2, alpha, partials, ni, d, width, blocks, s); break;
      case kM3: rc = launch<kM3, false>(tma, xs, gbar, sf2, alpha, partials, ni, d, width, blocks, s); break;
      case kM5: rc = launch<kM5, false>(tma, xs, gbar, sf2, alpha, partials, ni, d, width, blocks, s); break;
      case kRQ: rc = launch<kRQ, false>(tma, xs, gbar, sf2, alpha, partials, ni, d, width, blocks, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (rc != 0) return rc;
  reduce_partials<<<width, kReduceThreads, 0, s>>>(partials, blocks, width,
                                                   out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
