// Fused pairwise-distance + radial-profile kernel tile for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gpyreg_tpu/ops/pallas_kernels.py
// `_make_kernel` (launched by `_kernel_cross_pallas`): for inputs that are
// already divided by the lengthscales, Xs (N, D) and Zs (M, D), it writes
//
//     K[i, j] = sf2 * profile(t2),   t2 = sum_k (Xs[i, k] - Zs[j, k])^2,
//
// with profile one of se, m1, m3, m5, rq (the same formulas as
// `pallas_kernels._profile`).  `zero_diag` marks a self-covariance build
// (Zs is Xs): t2 is forced to 0 where the global row equals the column.
//
// What bounds it: writing K.  A self-covariance at N = 16384 is 1.07 GB of
// float32, while the arithmetic is about (3D + 20) flops per entry, far
// below the FP32 rate of the card.  D (8-10 in the workloads) is far below
// any tensor-core MMA depth, and TF32 would bring back the truncation error
// that the Pallas kernel avoids by asking for a HIGHEST-precision dot.  So
// the kernel runs on the FP32 pipes, not on the tensor cores, and its
// design is about the store:
//
// - a block of 32 x 8 threads owns a 64 x 128 output tile; each thread
//   keeps an 8 x 4 register tile of t2 accumulators;
// - the block stages its 64 rows of Xs and 128 rows of Zs in shared memory,
//   16 input dimensions at a time (D is a runtime argument);
// - t2 is the direct sum of squared differences with FP32 FMAs.  The
//   self-distance diagonal comes out exactly 0, without the cancellation of
//   the norm expansion |x|^2 + |z|^2 - 2 x.z that `_zero_diag_tile`
//   repairs on the TPU; `zero_diag` and the clamp at 0 are still honoured;
// - the column of a thread's j-th accumulator is tx + 32 j, so the 32
//   threads of a warp store 32 neighbouring floats: every store is one
//   coalesced 128-byte line;
// - ragged edges are masked in the kernel: no padded copies of the inputs
//   or the output;
// - offsets are 64-bit, since N * M reaches 1.6e9 at M = 100k test points;
// - the profile is a template parameter, with full-precision expf, sqrtf
//   and powf (the library is not built with --use_fast_math).
//
// Build (plain C interface, loaded with ctypes by ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 32;  // threads along the output columns
constexpr int kThreadsY = 8;   // threads along the output rows
constexpr int kRegN = 8;       // rows per thread
constexpr int kRegM = 4;       // columns per thread
constexpr int kTileN = kThreadsY * kRegN;  // 64 rows per block
constexpr int kTileM = kThreadsX * kRegM;  // 128 columns per block
constexpr int kChunkD = 16;    // input dimensions staged at a time
constexpr int kThreads = kThreadsX * kThreadsY;

enum Profile { kSE = 0, kM1 = 1, kM3 = 2, kM5 = 3, kRQ = 4 };

template <int P>
__device__ __forceinline__ float radial(float t2, float sf2, float alpha) {
  if (P == kSE) {
    return sf2 * expf(-0.5f * t2);
  } else if (P == kM1) {
    const float t = sqrtf(t2);
    return sf2 * expf(-t);
  } else if (P == kM3) {
    const float t = sqrtf(3.0f * t2);
    return sf2 * (1.0f + t) * expf(-t);
  } else if (P == kM5) {
    const float t = sqrtf(5.0f * t2);
    return sf2 * (1.0f + t * (1.0f + t / 3.0f)) * expf(-t);
  } else {
    return sf2 * powf(1.0f + 0.5f * t2 / alpha, -alpha);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
kernel_tile(const float* __restrict__ xs, const float* __restrict__ zs,
            const float* __restrict__ params, float* __restrict__ out,
            long long n, long long m, int d, int zero_diag) {
  // +1 column of padding: a warp reads sz[tx + 32 c][k] at a stride of
  // kChunkD + 1 words, which hits 32 distinct banks.
  __shared__ float sx[kTileN][kChunkD + 1];
  __shared__ float sz[kTileM][kChunkD + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const long long row0 = static_cast<long long>(blockIdx.y) * kTileN;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTileM;

  float acc[kRegN][kRegM];
#pragma unroll
  for (int r = 0; r < kRegN; ++r)
#pragma unroll
    for (int c = 0; c < kRegM; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kChunkD) {
    // Out-of-range rows and dimensions are staged as 0: a padded dimension
    // adds (0 - 0)^2 = 0, and padded rows are never stored.
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
      sz[c][k] = (gc < m && gk < d) ? zs[gc * d + gk] : 0.0f;
    }
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

  const float sf2 = params[0];
  const float alpha = params[1];
#pragma unroll
  for (int r = 0; r < kRegN; ++r) {
    const long long gr = row0 + ty + kThreadsY * r;
    if (gr >= n) continue;
    float* out_row = out + gr * m;
#pragma unroll
    for (int c = 0; c < kRegM; ++c) {
      const long long gc = col0 + tx + kThreadsX * c;
      if (gc >= m) continue;
      float t2 = acc[r][c];
      if (zero_diag && gr == gc) t2 = 0.0f;
      t2 = fmaxf(t2, 0.0f);
      out_row[gc] = radial<P>(t2, sf2, alpha);
    }
  }
}

template <int P>
void launch(const float* xs, const float* zs, const float* params, float* out,
            long long n, long long m, int d, int zero_diag,
            cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid(static_cast<unsigned>((m + kTileM - 1) / kTileM),
                  static_cast<unsigned>((n + kTileN - 1) / kTileN));
  kernel_tile<P><<<grid, block, 0, stream>>>(xs, zs, params, out, n, m, d,
                                              zero_diag);
}

}  // namespace

extern "C" {

// Largest row count one launch covers (grid.y is at most 65535 blocks).
long long kernel_tile_max_rows() { return 65535LL * kTileN; }

// Launches K = sf2 * profile(|xs_i - zs_j|^2) on `stream`.  `params` is a
// device array [sf2, alpha]; all arrays are contiguous float32.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown profile.
int kernel_tile_launch(int profile, const float* xs, const float* zs,
                       const float* params, float* out, long long n,
                       long long m, int d, int zero_diag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (profile) {
    case kSE: launch<kSE>(xs, zs, params, out, n, m, d, zero_diag, s); break;
    case kM1: launch<kM1>(xs, zs, params, out, n, m, d, zero_diag, s); break;
    case kM3: launch<kM3>(xs, zs, params, out, n, m, d, zero_diag, s); break;
    case kM5: launch<kM5>(xs, zs, params, out, n, m, d, zero_diag, s); break;
    case kRQ: launch<kRQ>(xs, zs, params, out, n, m, d, zero_diag, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
