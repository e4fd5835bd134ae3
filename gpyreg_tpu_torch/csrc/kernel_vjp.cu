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
// What bounds it: reading Gbar once, N^2 * 4 bytes (1.07 GB at N = 16384).
// The arithmetic, about 6D + 30 flops per entry for ARD, stays under the
// time of that read on the FP32 pipes at the D of the workloads (8-10).
// The design:
//
// - the tiling of kernel_tile.cu: a block of 32 x 8 threads owns a 64 x 128
//   tile of the plane, 8 x 4 entries a thread, the rows of xs staged in
//   padded shared memory 16 dimensions at a time (D is a runtime argument);
// - t2 is the direct sum of squared differences, and the ARD contraction is
//   the direct sum_ij E_ij (xs_ik - xs_jk)^2 in a second pass over the
//   staged dimensions (about 3 flops per entry and dimension), not the TPU
//   kernel's expansion sum xs^2 rowE + sum zs^2 colE - 2 sum xs (E zs),
//   which cancels when the data sit far from the origin relative to their
//   spread;
// - the 32 threads of a warp read 32 neighbouring floats of a row of Gbar:
//   every read is one coalesced 128-byte line, and each entry is read once;
// - no atomics: each block reduces its values (warp shuffles, then the 8
//   warps in order) into one row of float64 partials, and a second launch
//   sums each column of partials in a fixed order, in float64.  The result
//   is the same bit for bit from run to run, and the 2.7e8 terms at
//   N = 16384 lose no digits to a float32 running sum;
// - ragged edges are masked (an entry outside the plane has Gbar = 0, and so
//   adds 0), offsets are 64-bit, the profile is a template parameter, and
//   the library is not built with --use_fast_math.
//
// Build (plain C interface, loaded with ctypes by ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kRegN = 8;
constexpr int kRegM = 4;
constexpr int kTileN = kThreadsY * kRegN;  // 64 rows per block
constexpr int kTileM = kThreadsX * kRegM;  // 128 columns per block
constexpr int kChunkD = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;

enum Profile { kSE = 0, kM1 = 1, kM3 = 2, kM5 = 3, kRQ = 4 };

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

// Sums v[0 .. m-1] over the block in a fixed order and writes the sums to
// dst[0 .. m-1] in float64.  Every thread of the block calls it.
template <int MaxM>
__device__ __forceinline__ void block_sum_store(const float (&v)[MaxM], int m,
                                                double (*red)[kChunkD],
                                                double* dst) {
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < MaxM; ++i) {
    double s = static_cast<double>(v[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  if (tid < m) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][tid];
    dst[tid] = t;
  }
  __syncthreads();
}

__device__ __forceinline__ void stage(float (*sx)[kChunkD + 1],
                                      float (*sz)[kChunkD + 1],
                                      const float* __restrict__ xs,
                                      long long row0, long long col0,
                                      long long n, int d, int k0) {
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int i = tid; i < kTileN * kChunkD; i += kThreads) {
    const int r = i / kChunkD;
    const int k = i % kChunkD;
    const long long gr = row0 + r;
    const int gk = k0 + k;
    sx[r][k] = (gr < n && gk < d) ? xs[gr * d + gk] : 0.0f;
  }
  for (int i = tid; i < kTileM * kChunkD; i += kThreads) {
    const int c = i / kChunkD;
    const int k = i % kChunkD;
    const long long gc = col0 + c;
    const int gk = k0 + k;
    sz[c][k] = (gc < n && gk < d) ? xs[gc * d + gk] : 0.0f;
  }
}

template <int P, bool Iso>
__global__ void __launch_bounds__(kThreads)
kernel_vjp(const float* __restrict__ xs, const float* __restrict__ gbar,
           const float* __restrict__ params, double* __restrict__ partials,
           long long n, int d, int width) {
  __shared__ float sx[kTileN][kChunkD + 1];
  __shared__ float sz[kTileM][kChunkD + 1];
  __shared__ double red[kWarps][kChunkD];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.y) * kTileN;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTileM;
  double* out = partials +
      (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * width;

  // Pass 1: t2 by direct differences, as in kernel_tile.cu.
  float acc[kRegN][kRegM];
#pragma unroll
  for (int r = 0; r < kRegN; ++r)
#pragma unroll
    for (int c = 0; c < kRegM; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kChunkD) {
    stage(sx, sz, xs, row0, col0, n, d, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunkD; ++k) {
      float zv[kRegM];
#pragma unroll
      for (int c = 0; c < kRegM; ++c) zv[c] = sz[tx + kThreadsX * c][k];
#pragma unroll
      for (int r = 0; r < kRegN; ++r) {
        const float xv = sx[ty + kThreadsY * r][k];
#pragma unroll
        for (int c = 0; c < kRegM; ++c) {
          const float diff = xv - zv[c];
          acc[r][c] = fmaf(diff, diff, acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

  // K, P and E per entry; acc[r][c] becomes E.  Entries outside the plane
  // read Gbar = 0 and add nothing.
  const float sf2 = params[0];
  const float alpha = params[1];
  float s_t2 = 0.0f, s_k = 0.0f, s_rq = 0.0f;
#pragma unroll
  for (int r = 0; r < kRegN; ++r) {
    const long long gr = row0 + ty + kThreadsY * r;
#pragma unroll
    for (int c = 0; c < kRegM; ++c) {
      const long long gc = col0 + tx + kThreadsX * c;
      const float g = (gr < n && gc < n) ? gbar[gr * n + gc] : 0.0f;
      float t2 = gr == gc ? 0.0f : fmaxf(acc[r][c], 0.0f);
      float k, p;
      value_and_slope<P>(t2, sf2, alpha, k, p);
      const float e = -2.0f * g * p;
      const float gk = g * k;
      s_k += gk;
      if (Iso) s_t2 = fmaf(e, t2, s_t2);
      if (P == kRQ) {
        const float m = 1.0f + 0.5f * t2 / alpha;
        s_rq = fmaf(gk, 0.5f * t2 / m - alpha * logf(m), s_rq);
      }
      acc[r][c] = e;
    }
  }

  if (Iso) {
    const float v[2] = {s_t2, 2.0f * s_k};
    block_sum_store(v, 2, red, out);
    return;
  }
  {
    const float v[2] = {2.0f * s_k, s_rq};
    block_sum_store(v, P == kRQ ? 2 : 1, red, out + d);
  }

  // Pass 2 (ARD): g_k = sum E (xs_ik - xs_jk)^2, 16 dimensions at a time.
  for (int k0 = 0; k0 < d; k0 += kChunkD) {
    stage(sx, sz, xs, row0, col0, n, d, k0);
    __syncthreads();
    float gk[kChunkD];
#pragma unroll
    for (int k = 0; k < kChunkD; ++k) {
      float zv[kRegM];
#pragma unroll
      for (int c = 0; c < kRegM; ++c) zv[c] = sz[tx + kThreadsX * c][k];
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < kRegN; ++r) {
        const float xv = sx[ty + kThreadsY * r][k];
#pragma unroll
        for (int c = 0; c < kRegM; ++c) {
          const float diff = xv - zv[c];
          s = fmaf(acc[r][c] * diff, diff, s);
        }
      }
      gk[k] = s;
    }
    const int m = d - k0 < kChunkD ? d - k0 : kChunkD;
    // block_sum_store ends with a barrier, so the next stage is safe.
    block_sum_store(gk, m, red, out + k0);
  }
}

// out[w] = sum_b partials[b * width + w], in float64, in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const double* __restrict__ partials, long long blocks,
                int width, double* __restrict__ out) {
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
  if (threadIdx.x == 0) out[w] = s[0];
}

dim3 grid_of(long long n) {
  return dim3(static_cast<unsigned>((n + kTileM - 1) / kTileM),
              static_cast<unsigned>((n + kTileN - 1) / kTileN));
}

template <int P, bool Iso>
void launch(const float* xs, const float* gbar, const float* params,
            double* partials, long long n, int d, int width,
            cudaStream_t stream) {
  kernel_vjp<P, Iso><<<grid_of(n), dim3(kThreadsX, kThreadsY), 0, stream>>>(
      xs, gbar, params, partials, n, d, width);
}

}  // namespace

extern "C" {

// Largest N one launch covers (grid.y is at most 65535 blocks).
long long kernel_vjp_max_rows() { return 65535LL * kTileN; }

// Rows of float64 partials the launch writes for N points (one per block).
long long kernel_vjp_blocks(long long n) {
  const dim3 g = grid_of(n);
  return static_cast<long long>(g.x) * g.y;
}

// Width of the gradient row: 2 (iso), D + 2 (rq) or D + 1.
int kernel_vjp_width(int profile, int iso, int d) {
  return iso ? 2 : (profile == kRQ ? d + 2 : d + 1);
}

// Launches the gradient contraction and its reduction on `stream`.  `xs`
// (n, d) and `gbar` (n, n) are contiguous float32, `params` a device array
// [sf2, alpha], `partials` float64 scratch of kernel_vjp_blocks(n) rows of
// kernel_vjp_width(...) values, `out` float64 of that width.  Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for an unknown profile or an isotropic rq.
int kernel_vjp_launch(int profile, int iso, const float* xs, const float* gbar,
                      const float* params, double* partials, double* out,
                      long long n, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int width = kernel_vjp_width(profile, iso, d);
  if (iso) {
    switch (profile) {
      case kSE: launch<kSE, true>(xs, gbar, params, partials, n, d, width, s); break;
      case kM1: launch<kM1, true>(xs, gbar, params, partials, n, d, width, s); break;
      case kM3: launch<kM3, true>(xs, gbar, params, partials, n, d, width, s); break;
      case kM5: launch<kM5, true>(xs, gbar, params, partials, n, d, width, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (profile) {
      case kSE: launch<kSE, false>(xs, gbar, params, partials, n, d, width, s); break;
      case kM1: launch<kM1, false>(xs, gbar, params, partials, n, d, width, s); break;
      case kM3: launch<kM3, false>(xs, gbar, params, partials, n, d, width, s); break;
      case kM5: launch<kM5, false>(xs, gbar, params, partials, n, d, width, s); break;
      case kRQ: launch<kRQ, false>(xs, gbar, params, partials, n, d, width, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  reduce_partials<<<width, kReduceThreads, 0, s>>>(
      partials, kernel_vjp_blocks(n), width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
