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
// float32, 0.32 ms at 3.35 TB/s, while the arithmetic is about 2D + 10
// FP32 operations per entry.  D (8-10 in the workloads) is far below any
// tensor-core MMA depth, and TF32 would bring back the truncation that the
// Pallas kernel avoids with a HIGHEST-precision dot, so the kernel stays on
// the FP32 pipes with direct differences (the self-distance diagonal is
// exactly 0, with no norm-expansion cancellation).  At D = 10 those
// operations take about as long as the store on this card, so the design
// overlaps the two and halves the operations where it can:
//
// - a persistent grid, two blocks of 256 threads per SM, walks its work
//   items in a fixed order (tile_common.cuh): a 64 x 128 block of K (two
//   64 x 64 tiles side by side) for a cross-covariance, a pair of 64 x 64
//   tiles for a self-covariance.  Each thread computes 4 x 4 entries of a
//   tile; the two tiles of a cross item share one loop over the
//   dimensions;
// - the block writes its finished item into a shared-memory staging
//   buffer and hands it to a TMA store (cp.async.bulk.tensor, evict-first
//   L2 hint; the store clips the ragged edge itself), then goes on to the
//   next item's arithmetic while the store drains.  Staging is double
//   buffered (2 x 32 KB), so a buffer is rewritten only after the store
//   issued from it two items ago has read it;
// - the rows of Xs and Zs of the next-but-one item come in by cp.async
//   into a two-stage ring while the current item computes; each item
//   takes two block barriers;
// - a self-covariance (`zero_diag`) is folded by symmetry: only the tile
//   pairs I <= J are computed, and an off-diagonal pair stores its tile and
//   the transpose, which is staged through shared memory so that both
//   stores are coalesced.  t2_ij and t2_ji are the same float (the
//   difference is negated, then squared, and summed in the same order), so
//   K is bitwise symmetric either way, with K_ii = sf2 * profile(0);
// - exact D: dimensions are staged 16 at a time, and the unrolled loop over
//   a chunk skips the dimensions past D with a uniform branch; the
//   workloads' D = 8 and D = 10 have instantiations with compile-time
//   bounds, which the compiler schedules as straight-line code;
// - TMA needs a row stride that is a multiple of 16 bytes, M % 4 == 0.  For
//   other M the same items leave the staging buffer through plain stores:
//   16-byte vector stores where a row segment is 16-byte aligned, scalar
//   stores at its two ends, all with the streaming hint.  The wrapper picks
//   the path from M (a dispatch on shape) and counts it on its own key;
// - the profile is a template parameter, with full-precision expf, sqrtf
//   and powf (the library is not built with --use_fast_math).
//
// Changed from the first CUDA version of this kernel: that one launched one
// block per 64 x 128 tile, ran all 16 dimensions of its chunk whatever D
// was, computed both halves of a self-covariance, and wrote its register
// tile with 32 scalar stores after all of its arithmetic, so a block's
// loads, arithmetic and stores ran in sequence.
//
// Build (plain C interface, loaded with ctypes by ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "tile_common.cuh"

namespace {

using namespace tile;

enum Profile { kSE = 0, kM1 = 1, kM3 = 2, kM5 = 3, kRQ = 4 };

// Shared memory, in floats from a 1024-byte-aligned base: two staging
// stages of two tiles (the two halves of a 64 x 128 cross item, or a
// folded tile and its transpose), two ring stages of staged rows (64 rows
// of Xs, 128 rows of Zs) and one more such pair of chunk buffers for the
// dimensions past the first 16.
constexpr int kStageFloats = 2 * kTileFloats;
constexpr int kRowsI = kT;
constexpr int kRowsJ = 2 * kT;
constexpr int kRingFloats = kChunkD * (kRowsI + kRowsJ);
constexpr int kRingOffset = 2 * kStageFloats;
constexpr int kExtraOffset = kRingOffset + 2 * kRingFloats;
constexpr int kSmemFloats = kExtraOffset + kRingFloats;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float) + 1024;

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

// The staged rows of item (i, j): Xs rows of tile row i, and the Zs rows
// of its columns (Xs rows of tile j when folded).
__device__ __forceinline__ void issue_rows(float* ring, const Walker& w,
                                           const float* xs, const float* zs,
                                           int n, int m, int d, int kd,
                                           bool fold) {
  if (w.valid()) {
    stage_rows_async<kRowsI>(ring, xs, n, d, w.i * kT, 0, kd);
    if (fold)
      stage_rows_async<kRowsI>(ring + kChunkD * kRowsI, zs, m, d, w.j * kT,
                               0, kd);
    else
      stage_rows_async<kRowsJ>(ring + kChunkD * kRowsI, zs, m, d,
                               w.j * kRowsJ, 0, kd);
  }
  cp_async_commit();
}

// Plain stores of one staged tile to out[r0 .. r0 + kT, c0 .. c0 + kT),
// clipped to (rows, cols): one warp per row, 16-byte stores where the row
// segment is 16-byte aligned, scalar stores before and after.
__device__ __forceinline__ void store_plain(const float* s, float* out,
                                            int r0, int c0, int rows,
                                            int cols) {
  const int lane = threadIdx.x & 31;
  const int nc = min(kT, cols - c0);
  for (int r = threadIdx.x >> 5; r < kT && r0 + r < rows; r += kWarps) {
    float* row = out + static_cast<long long>(r0 + r) * cols + c0;
    const int head = min(
        nc, static_cast<int>((4 - (reinterpret_cast<uintptr_t>(row) >> 2)) & 3));
    const int nvec = (nc - head) >> 2;
    const int tail = head + 4 * nvec;
    if (lane < nvec) {
      const int c = head + 4 * lane;
      const float4 v = make_float4(s[swz(r, c)], s[swz(r, c + 1)],
                                   s[swz(r, c + 2)], s[swz(r, c + 3)]);
      __stcs(reinterpret_cast<float4*>(row + c), v);
    }
    if (lane < head) __stcs(row + lane, s[swz(r, lane)]);
    if (lane < nc - tail) __stcs(row + tail + lane, s[swz(r, tail + lane)]);
  }
}

// The first 4 x 4 block of a thread's two, as an array of one.
__device__ __forceinline__ float (&t2_first(float (&t2)[2][4][4]))[1][4][4] {
  return *reinterpret_cast<float(*)[1][4][4]>(&t2[0]);
}

template <int P, bool Tma, int KD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
kernel_tile(const __grid_constant__ CUtensorMap omap,
            const float* __restrict__ xs, const float* __restrict__ zs,
            const float* __restrict__ sf2p, const float* __restrict__ alphap,
            float* __restrict__ out, int n, int m, int d_arg, int fold) {
  const int d = KD ? KD : d_arg;
  extern __shared__ unsigned char smem_raw[];
  float* sm = align1024(smem_raw);
  float* extra = sm + kExtraOffset;

  const int tid = threadIdx.x;
  int a, b;
  quad_of(tid, a, b);
  const int kd = min(d, kChunkD);
  const float sf2 = *sf2p;
  const float alpha = *alphap;
  // A folded item is a tile pair (I, J), I <= J, stored with its mirror; a
  // cross item is the 64 x 128 block of tiles (I, 2J) and (I, 2J + 1).
  const int nti = (n + kT - 1) / kT;
  const int ntj = fold ? nti : (m + kRowsJ - 1) / kRowsJ;
  const int ldj = fold ? kRowsI : kRowsJ;
  const int halves = fold ? 1 : 2;
  const long long step = gridDim.x;
  uint64_t policy = 0;
  if (Tma) policy = evict_first_policy();

  Walker cur(nti, ntj, fold, blockIdx.x);
  Walker pre = cur;
  for (int s = 0; s < 2; ++s) {
    issue_rows(sm + kRingOffset + s * kRingFloats, pre, xs, zs, n, m, d, kd,
               fold);
    pre.advance(step);
  }

  for (int t = 0; cur.valid(); ++t, cur.advance(step)) {
    const int s = t & 1;
    float* ring = sm + kRingOffset + s * kRingFloats;
    float* s1 = sm + s * kStageFloats;
    float* s2 = s1 + kTileFloats;
    const int r0 = cur.i * kT;
    const int c0 = cur.j * ldj;
    const bool mirror = fold && cur.i != cur.j;

    // This item's rows have landed, and the store issued from this staging
    // stage two items ago has read it.
    if (Tma && tid == 0) bulk_wait_read<1>();
    cp_async_wait<1>();
    __syncthreads();

    float t2[2][4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) t2[h][r][c] = 0.0f;
    if (fold)
      add_sq_dist<1>(t2_first(t2), ring, kRowsI, ring + kChunkD * kRowsI,
                     ldj, a, b, kd);
    else
      add_sq_dist<2>(t2, ring, kRowsI, ring + kChunkD * kRowsI, ldj, a, b,
                     kd);
    for (int k0 = kChunkD; k0 < d; k0 += kChunkD) {
      const int kc = min(kChunkD, d - k0);
      float* ej = extra + kChunkD * kRowsI;
      stage_rows_sync<kRowsI>(extra, xs, n, d, r0, k0, kc);
      if (fold)
        stage_rows_sync<kRowsI>(ej, zs, m, d, c0, k0, kc);
      else
        stage_rows_sync<kRowsJ>(ej, zs, m, d, c0, k0, kc);
      __syncthreads();
      if (fold)
        add_sq_dist<1>(t2_first(t2), extra, kRowsI, ej, ldj, a, b, kc);
      else
        add_sq_dist<2>(t2, extra, kRowsI, ej, ldj, a, b, kc);
      __syncthreads();
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h < halves) {
        float v[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float q = t2[h][r][c];
            if (fold && r0 + 4 * a + r == c0 + 4 * b + c) q = 0.0f;
            v[r][c] = radial<P>(fmaxf(q, 0.0f), sf2, alpha);
          }
        float* st = h == 0 ? s1 : s2;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(st + swz(4 * a + r, 4 * b)) =
              make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
        if (mirror) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            *reinterpret_cast<float4*>(s2 + swz(4 * b + c, 4 * a)) =
                make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
        }
      }
    }
    if (Tma) fence_async_shared();
    // The staging stage is complete, and every thread is past its reads of
    // the ring stage.
    __syncthreads();

    if (Tma) {
      if (tid == 0) {
        for (int h = 0; h < halves * kT && c0 + h < m; h += kBoxCols)
          tma_store_box(&omap, s1 + (h / kBoxCols) * kBoxFloats, c0 + h, r0,
                        policy);
        if (mirror) {
          for (int h = 0; h < kT && r0 + h < m; h += kBoxCols)
            tma_store_box(&omap, s2 + (h / kBoxCols) * kBoxFloats, r0 + h,
                          c0, policy);
        }
        bulk_commit();
      }
    } else {
      store_plain(s1, out, r0, c0, n, m);
      if (!fold && c0 + kT < m) store_plain(s2, out, r0, c0 + kT, n, m);
      if (mirror) store_plain(s2, out, c0, r0, n, m);
    }

    issue_rows(ring, pre, xs, zs, n, m, d, kd, fold);
    pre.advance(step);
  }
  if (Tma && tid == 0) bulk_wait<0>();
}

template <int P>
int launch(int tma, const float* xs, const float* zs, const float* sf2,
           const float* alpha, float* out, int n, int m, int d, int fold,
           cudaStream_t stream) {
  CUtensorMap map{};
  if (tma) {
    const int rc = make_tile_map(&map, out, n, m);
    if (rc != 0) return rc;
  }
  auto pick = [d](auto k0, auto k8, auto k10) {
    return specialised_d(d) == 8 ? k8 : (specialised_d(d) == 10 ? k10 : k0);
  };
  auto kern = tma ? pick(kernel_tile<P, true, 0>, kernel_tile<P, true, 8>,
                         kernel_tile<P, true, 10>)
                  : pick(kernel_tile<P, false, 0>, kernel_tile<P, false, 8>,
                         kernel_tile<P, false, 10>);
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long nti = (n + kT - 1) / kT;
  const long long ntj = (m + kRowsJ - 1) / kRowsJ;
  const long long items = fold ? nti * (nti + 1) / 2 : nti * ntj;
  const long long grid = persistent_grid(items);
  kern<<<static_cast<unsigned>(grid), kThreads, kSmemBytes, stream>>>(
      map, xs, zs, sf2, alpha, out, n, m, d, fold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory a block takes, in bytes.
long long kernel_tile_smem_bytes() { return kSmemBytes; }

// Launches K = sf2 * profile(|xs_i - zs_j|^2) on `stream`.  `sf2` and
// `alpha` point to one float each on the device; all arrays are contiguous
// float32, `out` 16-byte aligned.  `tma` selects the TMA store (m % 4 ==
// 0) or the plain stores; `zero_diag` (then zs is xs and m == n) folds the
// build by symmetry.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not
// take.
int kernel_tile_launch(int profile, int tma, const float* xs, const float* zs,
                       const float* sf2, const float* alpha, float* out,
                       long long n, long long m, int d, int zero_diag,
                       void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || n >= (1LL << 31) || m >= (1LL << 31) ||
      (zero_diag && (zs != xs || m != n)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n);
  const int mi = static_cast<int>(m);
  switch (profile) {
    case kSE: return launch<kSE>(tma, xs, zs, sf2, alpha, out, ni, mi, d, zero_diag, s);
    case kM1: return launch<kM1>(tma, xs, zs, sf2, alpha, out, ni, mi, d, zero_diag, s);
    case kM3: return launch<kM3>(tma, xs, zs, sf2, alpha, out, ni, mi, d, zero_diag, s);
    case kM5: return launch<kM5>(tma, xs, zs, sf2, alpha, out, ni, mi, d, zero_diag, s);
    case kRQ: return launch<kRQ>(tma, xs, zs, sf2, alpha, out, ni, mi, d, zero_diag, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
