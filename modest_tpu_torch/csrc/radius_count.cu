// Windowed radius count over x-sorted traversal pools, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel modest_tpu/ops/pallas_radius_count.py
// (radius_count_sorted -> _count_kernel_wrapped). For every traversal t and
// every tile of BN = 256 x-sorted queries, count the pool points of t with
// d^2 <= r^2 (inclusive) inside the window of BM = 2048-point tiles
// [lo, hi) that compute_tile_windows found for the tile.
//
// Layout: queries (3, Nq) float32 SoA, x-sorted, padded at 1e9; pool
// (T, 3, M) float32 SoA, each traversal x-sorted, padded at 1e9 (the TPU
// kernel's 8 coordinate rows existed only for DMA sublane alignment);
// windows (T, Nq / BN, 2) int32; counts (T, Nq) int32, zeroed by the caller.
//
// What bounds it: ~13 instructions per pair test (3 sub, 3 mul, 2 add,
// compare, add, and the shared loads), so operations, not bytes: each pool
// tile is read from device memory once per query tile that overlaps it and
// stays in L2 between neighbouring tiles.
//
// Design: windows differ wildly in length. The last real query tile of a
// scan also holds pad queries at 1e9, so its window runs from its real start
// through every pad point to the end of the pool; one block per window would
// leave a few blocks walking hundreds of tiles after the rest of the grid
// has finished. So every window w = t * (Nq / BN) + tile is cut into chunks
// of at most kChunkTiles pool tiles, and each chunk is one work item:
// starts (T * Nq / BN + 1) is the exclusive prefix sum of the chunk counts
// (ops/radius_count.py::split_windows, made on the device), item i belongs
// to the last window w with starts[w] <= i and is its chunk i - starts[w].
// A persistent grid (as many blocks as fit on the card, found once per
// device) strides over the items; a block adds its partial counts with
// integer atomicAdd, which is exact in any order. Within an item, one thread per query; the pool is
// staged in pieces of 1024 points (12 KB) with cp.async into two shared
// buffers, so piece i + 1 loads while piece i is tested, and every thread
// then reads the same staged point at the same time (a broadcast, no bank
// conflicts). 24 KB of shared memory lets 8 blocks share an SM.
//
// Exactness: d^2 = ((dx*dx + dy*dy) + dz*dz) with dx = p - q, each step
// rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn, and -fmad=false),
// which is the order of the plain PyTorch twin in ops/radius_count.py and of
// the Pallas kernel, so counts agree exactly on the same inputs.
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int BN = 256;   // queries per tile = threads per block
constexpr int BM = 2048;  // pool points per window tile
// Pool tiles per work item, by measurement on an H100 (1, 2, 4, 8 and 16
// swept; PERF.md): equal one-tile items balance the persistent grid best.
constexpr int kChunkTiles = 1;
constexpr int kStage = 1024;  // pool points per staged piece (half a tile)
constexpr int kPieces = 3 * kStage / 4;  // 16-byte copies per staged piece
constexpr int kMaxDevices = 64;  // devices whose grid size is remembered

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start copying piece i (kStage points: x, y and z rows) of one traversal's
// pool into dst.
__device__ __forceinline__ void stage_piece(float (*dst)[kStage], const float* px, int m, int i) {
  for (int v = threadIdx.x; v < kPieces; v += BN) {
    const int c = v / (kStage / 4);
    const int off = (v % (kStage / 4)) * 4;
    const size_t src = static_cast<size_t>(c) * m + static_cast<size_t>(i) * kStage + off;
    cp_async16(&dst[c][off], px + src);
  }
}

__device__ __forceinline__ int within(float px, float py, float pz, float qx, float qy, float qz,
                                      float r2) {
  const float dx = __fsub_rn(px, qx);
  const float dy = __fsub_rn(py, qy);
  const float dz = __fsub_rn(pz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)) <= r2;
}

__global__ void __launch_bounds__(BN)
radius_count_kernel(const float* __restrict__ q, const float* __restrict__ pool,
                    const int* __restrict__ lohi, const int* __restrict__ starts,
                    int* __restrict__ counts, int n_windows, int nq_total, int m, float r2) {
  __shared__ __align__(16) float pieces[2][3][kStage];

  const int n_tiles = nq_total / BN;
  const int total = starts[n_windows];
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    // the window of the item: starts[w] <= item < starts[w + 1]
    int w = 0, above = n_windows;
    while (above - w > 1) {
      const int mid = (w + above) >> 1;
      if (starts[mid] <= item) {
        w = mid;
      } else {
        above = mid;
      }
    }
    const int t = w / n_tiles;
    const int lo = lohi[2 * w] + (item - starts[w]) * kChunkTiles;
    const int hi = min(lohi[2 * w + 1], lo + kChunkTiles);
    const int qi = (w - t * n_tiles) * BN + threadIdx.x;
    const float qx = q[qi];
    const float qy = q[nq_total + qi];
    const float qz = q[2 * static_cast<size_t>(nq_total) + qi];
    const float* px = pool + static_cast<size_t>(t) * 3 * m;

    int cnt = 0;
    const int first = lo * (BM / kStage), last = hi * (BM / kStage);
    stage_piece(pieces[0], px, m, first);
    cp_async_commit();
    for (int i = first; i < last; ++i) {
      const int cur = (i - first) & 1;
      if (i + 1 < last) stage_piece(pieces[cur ^ 1], px, m, i + 1);
      cp_async_commit();  // an empty group on the last piece keeps the wait below right
      cp_async_wait_all_but_one();  // this thread's copies of piece i have landed
      __syncthreads();              // and every other thread's
      const float4* sx = reinterpret_cast<const float4*>(pieces[cur][0]);
      const float4* sy = reinterpret_cast<const float4*>(pieces[cur][1]);
      const float4* sz = reinterpret_cast<const float4*>(pieces[cur][2]);
#pragma unroll 4
      for (int j = 0; j < kStage / 4; ++j) {
        const float4 x = sx[j], y = sy[j], z = sz[j];
        cnt += within(x.x, y.x, z.x, qx, qy, qz, r2) + within(x.y, y.y, z.y, qx, qy, qz, r2) +
               within(x.z, y.z, z.z, qx, qy, qz, r2) + within(x.w, y.w, z.w, qx, qy, qz, r2);
      }
      __syncthreads();  // piece i is read before piece i + 2 is staged into its buffer
    }
    if (cnt != 0) atomicAdd(&counts[static_cast<size_t>(t) * nq_total + qi], cnt);
  }
}

// The persistent grid's size on the current device: as many blocks as are
// resident at once. Found on the first launch on a device, then remembered.
cudaError_t grid_blocks(int* blocks) {
  static std::atomic<int> known[kMaxDevices];  // per device; 0 until found
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  *blocks = dev < kMaxDevices ? known[dev].load(std::memory_order_relaxed) : 0;
  if (*blocks > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, radius_count_kernel, BN, 0);
  }
  *blocks = sms * per_sm;
  if (e == cudaSuccess && dev < kMaxDevices) known[dev].store(*blocks);
  return e;
}

}  // namespace

extern "C" {

int radius_count_tile_queries() { return BN; }
int radius_count_tile_points() { return BM; }
int radius_count_chunk_tiles() { return kChunkTiles; }

// q (3, nq_total), pool (t_count, 3, m), lohi (t_count, nq_total / BN, 2),
// starts (t_count * nq_total / BN + 1) from split_windows with
// radius_count_chunk_tiles() tiles per item, counts (t_count, nq_total)
// zeroed; nq_total % BN == 0, m % BM == 0 and 16-byte aligned pool rows
// (checked by the caller). Returns the CUDA error code of the launch (0 on
// success).
int radius_count_launch(const void* q, const void* pool, const void* lohi, const void* starts,
                        void* counts, int t_count, int nq_total, int m, float r2, void* stream) {
  if (t_count <= 0 || nq_total <= 0) return 0;
  int blocks = 0;
  const cudaError_t e = grid_blocks(&blocks);
  if (e == cudaSuccess) {
    radius_count_kernel<<<blocks, BN, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(pool),
        static_cast<const int*>(lohi), static_cast<const int*>(starts),
        static_cast<int*>(counts), t_count * (nq_total / BN), nq_total, m, r2);
  }
  const cudaError_t last = cudaGetLastError();  // also clears a refused call's error
  return static_cast<int>(e != cudaSuccess ? e : last);
}

const char* radius_count_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
