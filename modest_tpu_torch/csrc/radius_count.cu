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
// windows (T, Nq / BN, 2) int32; counts (T, Nq) int32.
//
// Design: one block per (query tile, traversal), one thread per query. The
// block walks its window one 2048-point tile at a time, staging x, y, z
// (24 KB) in shared memory; every thread then reads the same point at the
// same time (a broadcast, no bank conflicts) and tests it against its own
// query. The work is ~13 instructions per pair test (3 shared loads, 3 sub,
// 3 mul, 2 add, compare, add), so the kernel is bound by operations, not by
// bytes: each pool tile is read from device memory once per query tile
// that overlaps it, and stays in L2 between neighbouring tiles.
//
// Exactness: d^2 = ((dx*dx + dy*dy) + dz*dz) with dx = p - q, each step
// rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn, and -fmad=false),
// which is the order of the plain PyTorch twin in ops/radius_count.py and of
// the Pallas kernel, so counts agree exactly on the same inputs.
#include <cuda_runtime.h>

namespace {

constexpr int BN = 256;   // queries per tile = threads per block
constexpr int BM = 2048;  // pool points per window tile

__global__ void __launch_bounds__(BN)
radius_count_kernel(const float* __restrict__ q, const float* __restrict__ pool,
                    const int* __restrict__ lohi, int* __restrict__ counts,
                    int nq_total, int m, float r2) {
  __shared__ float sx[BM];
  __shared__ float sy[BM];
  __shared__ float sz[BM];

  const int tile = blockIdx.x;
  const int t = blockIdx.y;
  const int n_tiles = nq_total / BN;
  const int qi = tile * BN + threadIdx.x;
  const float qx = q[qi];
  const float qy = q[nq_total + qi];
  const float qz = q[2 * (size_t)nq_total + qi];

  const int* w = lohi + ((size_t)t * n_tiles + tile) * 2;
  const int lo = w[0];
  const int hi = w[1];
  const float* px = pool + (size_t)t * 3 * m;
  const float* py = px + m;
  const float* pz = py + m;

  int cnt = 0;
  for (int mt = lo; mt < hi; ++mt) {
    const size_t base = (size_t)mt * BM;
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < BM; j += BN) {
      sx[j] = px[base + j];
      sy[j] = py[base + j];
      sz[j] = pz[base + j];
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < BM; ++j) {
      const float dx = __fsub_rn(sx[j], qx);
      const float dy = __fsub_rn(sy[j], qy);
      const float dz = __fsub_rn(sz[j], qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      cnt += d2 <= r2 ? 1 : 0;
    }
  }
  counts[(size_t)t * nq_total + qi] = cnt;
}

}  // namespace

extern "C" {

int radius_count_tile_queries() { return BN; }
int radius_count_tile_points() { return BM; }

// q (3, nq_total), pool (t_count, 3, m), lohi (t_count, nq_total / BN, 2),
// counts (t_count, nq_total); nq_total % BN == 0 and m % BM == 0 (checked by
// the caller). Returns the CUDA error code of the launch (0 on success).
int radius_count_launch(const void* q, const void* pool, const void* lohi, void* counts,
                        int t_count, int nq_total, int m, float r2, void* stream) {
  if (t_count <= 0 || nq_total <= 0) return 0;
  dim3 grid(nq_total / BN, t_count);
  radius_count_kernel<<<grid, BN, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)pool, (const int*)lohi, (int*)counts, nq_total, m, r2);
  return (int)cudaGetLastError();
}

const char* radius_count_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
