// Label-table gathers, for NVIDIA Hopper (sm_90a).
//
// Replace the Pallas TPU probe kernels of scripts_dev/gather_probe.py:
//   take_launch              <- pallas_take -> _probe_kernel:  out[i] = table[idx[i]],
//                               table (n,) int32, idx / out (total,) int32;
//   take_along_axis_launch   <- pallas_taa -> _probe_kernel2: out[r, j] = tab[r, idx[r, j]],
//                               tab (rows, w) int32, idx / out (rows, m) int32.
// The TPU probes asked whether Mosaic could gather inside VMEM at all (the
// TPU has no general gather unit); Hopper loads any address from global
// memory.
//
// take: bound by bytes. A call must read idx, write out and read the table
// sectors the indices touch once: at the probe's full size (table 131,072,
// idx 131,072 x 70) ~73.9 MB, ~22 us at 3.35 TB/s. One thread per index
// with a dependent scattered table load (the first design) turns every index
// into its own L1 lookup and 32-byte L2 sector request, ~294 MB of sector
// traffic, and ran at ~2.5x the bound. So a block of TAKE_THREADS owns a
// whole tile of 8,192 consecutive indices, streams them into registers with
// 16-byte loads that bypass L1 and are evicted first from L2, takes the
// tile's min and max index, and, when that span is shorter than the tile
// and fits TAKE_WINDOW entries, copies table[min..max] into shared memory
// with coalesced loads and gathers from there. DBSCAN's x-sorted neighbour
// rows are banded, so a tile of ~117 rows of 70 spans ~4,200 entries of the
// probe's table. A tile whose span does not fit gathers through the
// read-only path instead, with 8 loads in flight a thread: the same results.
// Stores are 16-byte streaming stores, so idx and out do not evict the table
// from L2. Two such blocks an SM (29 registers, 32 KB of window each) leave
// most of the SM's L1 to the read-only path. A call too small to give every
// SM a whole tile runs on 128-thread blocks of one int4 a thread that never
// stage, so it spreads over the SMs. A head of up to 3 indices before idx's
// first 16-byte boundary and a tail of up to 3 are taken one by one by
// block 0; out is written with scalar stores when it is not aligned as idx.
//
// take_along_axis: one thread per output element. At the probe's shapes
// (at most 256 x 70 indices) its device time is within 1.25x of its launch
// floor, the time of one element.
//
// An index outside its table sets errors[0] = 1 and writes 0; the wrapper
// raises at its first host read of the flag. Nothing is clamped.
#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

constexpr int TAKE_THREADS = 1024;       // a whole tile: 1,024 threads ...
constexpr int TAKE_VECS = 2;            // ... of 2 int4 of idx each, 8,192 indices
constexpr int TAKE_WINDOW = 8192;       // table entries a block can stage (32 KB)
constexpr int TAKE_SMALL_THREADS = 128;  // a small call's blocks, one int4 a thread
constexpr int TAKE_WARPS = TAKE_THREADS / 32;

__device__ __forceinline__ int take_one(int j, int n, const int* __restrict__ table,
                                        const int* win, int lo, bool staged,
                                        int* __restrict__ errors) {
  if (j < 0 || j >= n) {
    errors[0] = 1;
    return 0;
  }
  return staged ? win[j - lo] : __ldg(table + j);
}

// idx + head is 16-byte aligned; nvec int4 follow it, then total - head -
// 4 * nvec < 4 scalars. A block takes blockDim.x * vpt int4, vpt <=
// TAKE_VECS; only whole tiles (TAKE_THREADS threads, TAKE_VECS int4 each)
// may stage.
__global__ void __launch_bounds__(TAKE_THREADS, 2)
take_kernel(const int* __restrict__ table, int n, const int* __restrict__ idx,
            int* __restrict__ out, long long total, int head, long long nvec, int vpt,
            int* __restrict__ errors) {
  extern __shared__ int win[];  // TAKE_WINDOW entries in whole tiles, none otherwise
  __shared__ int warp_lo[TAKE_WARPS], warp_hi[TAKE_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (blockIdx.x == 0) {  // the unaligned head and the ragged tail, one index a thread
    const long long rest = total - head - 4 * nvec;
    long long i = -1;
    if (threadIdx.x < head) i = threadIdx.x;
    else if (threadIdx.x < head + rest) i = 4 * nvec + threadIdx.x;
    if (i >= 0) out[i] = take_one(__ldg(idx + i), n, table, nullptr, 0, false, errors);
  }

  const int4* idx4 = reinterpret_cast<const int4*>(idx + head);
  const long long v0 = (long long)blockIdx.x * blockDim.x * vpt;
  int4 v[TAKE_VECS];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int u = 0; u < TAKE_VECS; ++u) {
    const long long p = v0 + u * blockDim.x + threadIdx.x;
    if (u < vpt && p < nvec) {
      v[u] = __ldcs(idx4 + p);
      lo = min(lo, min(min(v[u].x, v[u].y), min(v[u].z, v[u].w)));
      hi = max(hi, max(max(v[u].x, v[u].y), max(v[u].z, v[u].w)));
    }
  }
  bool staged = false;
  if (vpt == TAKE_VECS) {  // whole tiles (uniform over the launch)
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      warp_lo[warp] = lo;
      warp_hi[warp] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < TAKE_WARPS; ++w) {
      lo = min(lo, warp_lo[w]);
      hi = max(hi, warp_hi[w]);
    }
    // only indices inside the table are staged, and only when the window is
    // smaller than the tile: each staged entry is then read more than once
    // on average
    lo = max(lo, 0);
    hi = min(hi, n - 1);
    const long long span = (long long)hi - lo + 1;  // <= 0 when no index is inside
    const long long count = 4 * min((long long)TAKE_THREADS * TAKE_VECS, nvec - v0);
    staged = span <= TAKE_WINDOW && span < count;
    if (staged) {
      for (int t = threadIdx.x; t < span; t += TAKE_THREADS) win[t] = __ldg(table + lo + t);
    }
    __syncthreads();
  }

  int* out_body = out + head;
  const bool out_vec = (reinterpret_cast<uintptr_t>(out_body) & 15) == 0;
#pragma unroll
  for (int u = 0; u < TAKE_VECS; ++u) {
    const long long p = v0 + u * blockDim.x + threadIdx.x;
    if (u < vpt && p < nvec) {
      int4 r;
      r.x = take_one(v[u].x, n, table, win, lo, staged, errors);
      r.y = take_one(v[u].y, n, table, win, lo, staged, errors);
      r.z = take_one(v[u].z, n, table, win, lo, staged, errors);
      r.w = take_one(v[u].w, n, table, win, lo, staged, errors);
      if (out_vec) {
        __stcs(reinterpret_cast<int4*>(out_body) + p, r);
      } else {  // idx and out are not aligned alike
        int* o = out_body + 4 * p;
        __stcs(o, r.x);
        __stcs(o + 1, r.y);
        __stcs(o + 2, r.z);
        __stcs(o + 3, r.w);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
take_along_axis_kernel(const int* __restrict__ tab, int w, const int* __restrict__ idx,
                       int* __restrict__ out, int m, long long total,
                       int* __restrict__ errors) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int j = idx[i];
  if (j < 0 || j >= w) {
    errors[0] = 1;
    out[i] = 0;
    return;
  }
  out[i] = __ldg(tab + (i / m) * w + j);
}

inline unsigned blocks(long long total) { return (unsigned)((total + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// table (n,), idx and out (total,), errors (1,) int32 set to 1 on a bad
// index (the caller zeroes it). Returns the CUDA error code of the launch.
int take_launch(const void* table, int n, const void* idx, void* out, long long total,
                void* errors, void* stream) {
  if (total <= 0) return 0;
  // indices before idx's first 16-byte boundary (int32 data is 4-byte aligned)
  const long long head = std::min<long long>(
      ((16 - (reinterpret_cast<uintptr_t>(idx) & 15)) & 15) / 4, total);
  const long long nvec = (total - head) / 4;
  // whole tiles when they give every SM one; a smaller call spreads over as
  // many SMs as it can fill with small blocks of one int4 a thread
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long whole = (long long)TAKE_THREADS * TAKE_VECS;
  const bool tiles = nvec >= sms * whole;
  const int threads = tiles ? TAKE_THREADS : TAKE_SMALL_THREADS;
  const long long per_block = tiles ? whole : TAKE_SMALL_THREADS;
  const long long grid = std::max<long long>((nvec + per_block - 1) / per_block, 1);
  const size_t window_bytes = tiles ? TAKE_WINDOW * sizeof(int) : 0;
  take_kernel<<<(unsigned)grid, threads, window_bytes, (cudaStream_t)stream>>>(
      (const int*)table, n, (const int*)idx, (int*)out, total, (int)head, nvec,
      tiles ? TAKE_VECS : 1, (int*)errors);
  return (int)cudaGetLastError();
}

// tab (rows, w), idx and out (rows, m), errors as above.
int take_along_axis_launch(const void* tab, int w, const void* idx, void* out, int rows, int m,
                           void* errors, void* stream) {
  const long long total = (long long)rows * m;
  if (total <= 0) return 0;
  take_along_axis_kernel<<<blocks(total), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)tab, w, (const int*)idx, (int*)out, m, total, (int*)errors);
  return (int)cudaGetLastError();
}

const char* gather_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
