// Shared pieces of the two Hopper (sm_90a) tile kernels, kernel_tile.cu and
// kernel_vjp.cu: the square tile and its 128-byte-swizzled layout in shared
// memory, the thread-to-entry map, the static walk over tiles, and thin
// wrappers over cp.async, TMA (cp.async.bulk.tensor) and mbarrier PTX.
//
// The tile.  Both kernels cut the (N, M) plane into square kT x kT tiles.
// A tile lives in shared memory as two boxes of kT rows by kBoxCols = 32
// columns: one box row is 128 bytes, the span of TMA's 128-byte swizzle, in
// which the 16-byte chunk c of row r sits at chunk c ^ (r % 8).  A TMA copy
// writes (or reads) exactly that layout; the non-TMA paths write it by hand
// (swz), so the arithmetic is shared.
//
// The thread map.  256 threads; thread (a, b) owns the 4 x 4 entries
// rows 4a..4a+3, columns 4b..4b+3 of a tile (a, b in 0..15).  Each of its
// loads and stores is one 16-byte access: a tile row (4 columns of one row)
// or a transposed tile row (4 rows of one column, read from the mirror
// tile).  quad_of spreads the 8 threads of each quarter-warp (the unit of
// a 16-byte shared-memory access) over 8 distinct swizzled chunks in both
// orientations, so neither the tile nor its transpose has bank conflicts.
//
// The walk.  A launch runs kBlocksPerSM resident blocks per SM (a
// persistent grid).  The work items, cells (I, J) of a grid of tiles in
// row-major order (all of them, or only I <= J for a plane folded by
// symmetry), are dealt out statically: block b takes items b, b + G,
// b + 2G, ... for a grid of G blocks.  ops/tile_kernels.tile_pairs lists
// the folded order in Python.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tile {

constexpr int kT = 64;          // tile side (rows = columns)
constexpr int kBoxCols = 32;    // columns per TMA box: 128 bytes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkD = 16;     // input dimensions staged at a time
constexpr int kTileFloats = kT * kT;
constexpr int kBoxFloats = kT * kBoxCols;
constexpr int kXsFloats = kChunkD * kT;  // one staged chunk of kT rows
constexpr int kBlocksPerSM = 2;

// Float offset of entry (r, c) of a tile in the swizzled two-box layout.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 5) * kBoxFloats + r * kBoxCols +
         ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

// The 4 x 4 block (a, b) of thread `tid`.  Quarter-warp q = tid / 8 holds
// a = (t + q) % 8 (+ 8 by bit 3 of q), b = t (+ 8 by bit 4 of q) for
// t = tid % 8: in a tile row read, the chunk b ^ (row % 8) and in a
// transposed read the chunk a ^ (row % 8) both take 8 distinct values.
__device__ __forceinline__ void quad_of(int tid, int& a, int& b) {
  const int q = tid >> 3;
  const int t = tid & 7;
  a = ((t + q) & 7) | (((q >> 3) & 1) << 3);
  b = t | (((q >> 4) & 1) << 3);
}

// Row-major walk over the tiles (i, j) of an nrows x ncols grid of tiles,
// or over its upper triangle j >= i when `tri` (then nrows == ncols).
struct Walker {
  int i = 0, j = 0;
  int nrows, ncols;
  bool tri;

  __device__ Walker(int nr, int nc, bool upper, long long start)
      : nrows(nr), ncols(nc), tri(upper) {
    advance(start);
  }
  __device__ __forceinline__ bool valid() const { return i < nrows; }
  __device__ void advance(long long step) {
    long long off = static_cast<long long>(j - (tri ? i : 0)) + step;
    while (i < nrows) {
      const long long len = tri ? ncols - i : ncols;
      if (off < len) break;
      off -= len;
      ++i;
    }
    j = (tri ? i : 0) + static_cast<int>(off);
  }
};

__device__ __forceinline__ float* align1024(unsigned char* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return reinterpret_cast<float*>(p + ((1024u - (s & 1023u)) & 1023u));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async (4 bytes, zero-filled when !valid) ------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages rows row0 .. row0 + Rows - 1, dimensions k0 .. k0 + kd - 1 of
// the (n, d) matrix x into dst[k][r] (k-major with leading dimension Rows,
// so a thread reads 4 rows of one dimension as one float4); rows past n
// are 0.  Asynchronous (cp.async); neighbouring threads take neighbouring
// rows, so the shared-memory writes are free of bank conflicts.
template <int Rows>
__device__ __forceinline__ void stage_rows_async(float* dst, const float* x,
                                                 int n, int d, int row0,
                                                 int k0, int kd) {
  for (int e = threadIdx.x; e < Rows * kd; e += kThreads) {
    const int r = e % Rows;
    const int k = e / Rows;
    const int gr = row0 + r;
    const bool ok = gr < n;
    cp_async4(dst + k * Rows + r,
              ok ? x + static_cast<long long>(gr) * d + k0 + k : x, ok);
  }
}

// The same with plain loads; the caller synchronises.
template <int Rows>
__device__ __forceinline__ void stage_rows_sync(float* dst, const float* x,
                                                int n, int d, int row0,
                                                int k0, int kd) {
  for (int e = threadIdx.x; e < Rows * kd; e += kThreads) {
    const int r = e % Rows;
    const int k = e / Rows;
    const int gr = row0 + r;
    dst[k * Rows + r] =
        gr < n ? x[static_cast<long long>(gr) * d + k0 + k] : 0.0f;
  }
}

// Adds the squared differences of dimensions 0 .. kd - 1 of two staged
// chunks (leading dimensions ldi, ldj) to the thread's H blocks of 4 x 4:
// t2[h][r][c] += (xi[4a+r] - xj[64h+4b+c])^2, in dimension order.  The
// loop is unrolled to kChunkD; the loads are unconditional (a dimension
// past kd reads the chunk buffer and is not used), so they can be issued
// early, and the arithmetic of the dimensions past kd is skipped with a
// uniform branch.
template <int H>
__device__ __forceinline__ void add_sq_dist(float (&t2)[H][4][4],
                                            const float* si, int ldi,
                                            const float* sj, int ldj, int a,
                                            int b, int kd) {
#pragma unroll
  for (int k = 0; k < kChunkD; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(si + k * ldi + 4 * a);
    float4 z[H];
#pragma unroll
    for (int h = 0; h < H; ++h)
      z[h] = *reinterpret_cast<const float4*>(sj + k * ldj + kT * h + 4 * b);
    if (k < kd) {
      const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float zv[4] = {z[h].x, z[h].y, z[h].z, z[h].w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float diff = xv[r] - zv[c];
            t2[h][r][c] = fmaf(diff, diff, t2[h][r][c]);
          }
      }
    }
  }
}

// ---- mbarrier and TMA ---------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box (kT rows x kBoxCols columns at column c0, row r0) of the map's
// matrix into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_box(float* dst, const CUtensorMap* map,
                                             uint64_t* bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(r0)
      : "memory");
}

// One box from shared memory to the map's matrix at (column c0, row r0);
// TMA clips what lies outside the matrix.  `policy` is an L2 cache policy.
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map,
                                              const float* src, int c0,
                                              int r0, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(r0), "l"(policy)
      : "memory");
}
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// At most N bulk groups still reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// At most N bulk groups not yet complete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared-memory writes before later TMA reads of them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- host ---------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda); nullptr if the driver does not have it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A TMA descriptor of the row-major float32 (rows, cols) matrix at `base`,
// in boxes of kT rows by kBoxCols columns, 128-byte swizzle, zero fill out
// of bounds.  It needs a 16-byte-aligned base and cols % 4 == 0 (a row
// stride that is a multiple of 16 bytes).  Returns a cudaError_t.
inline int make_tile_map(CUtensorMap* map, const float* base, long long rows,
                         long long cols) {
  if (cols % 4 != 0 || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {kBoxCols, kT};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The D a kernel is instantiated for: the workloads' D = 8 and D = 10 get
// instantiations whose loops over the dimensions have compile-time bounds;
// 0 stands for every other D (bounds read at run time).
inline int specialised_d(int d) { return d == 8 || d == 10 ? d : 0; }

// Blocks of a persistent launch over `items` work items: kBlocksPerSM per
// SM of the current device, at most one per item.
inline long long persistent_grid(long long items) {
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long g = static_cast<long long>(sms) * kBlocksPerSM;
  return items < g ? items : g;
}

}  // namespace tile
