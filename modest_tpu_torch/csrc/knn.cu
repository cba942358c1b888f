// Windowed k nearest neighbours over x-sorted candidates, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel modest_tpu/ops/pallas_knn.py
// (_knn_windows -> _knn_kernel). Every chunk of QC = 32 x-sorted queries
// shares one window of W consecutive x-sorted candidates that starts at the
// 128-candidate row lo[chunk]. For each query, rank the window by the int32
// key (d2_bits & ~(W - 1)) | j, j the window-local index, and write the k
// smallest keys in ascending order. The bits of a non-negative float32
// order like its value, and the low bits make every key of a row unique,
// so any exact selection writes the same bits.
//
// Layout: queries qx, qy, qz (B*M,) float32, x-sorted per frame; candidates
// xs, ys, zs (B*N,) float32 SoA, x-sorted per frame, frames stacked; lo
// (B*M / QC,) int32, each chunk's window start row;
// out (B*M, k) int32. A window that leaves its chunk's frame (frames of
// rows_per_frame rows and chunks_per_frame chunks) is not read: the block
// sets errors[0] = 1 and writes -1 into its rows, and the wrapper raises.
//
// Two kernels, chosen by k:
//
// knn_select_kernel<W> (k <= 32, the path's k = 32 and 3). One block per
// chunk stages the chunk's window once as planar x, y, z in shared memory
// (24 KB at W = 2048); each of its 32 warps then serves one of the chunk's
// queries, and 2 blocks per SM (64 warps, <= 32 registers a thread) keep
// staging and selection overlapped. For each query the warp keeps the 32 smallest
// keys seen so far sorted across its lanes (lane l holds the l-th) and the
// k-th of them, lane k-1's, as the threshold, in the manner of WarpSelect
// (Johnson, Douze & Jegou, "Billion-scale similarity search with GPUs"). It
// scans 32-candidate tiles outward from the query's x position: the tile
// that holds it, then right and left in turn. Each lane computes one key
// per tile; a ballot of key < threshold says who gets in: a few keys are
// inserted one by one (ballot for the position, shfl_up), many by a bitonic
// sort of the tile and a bitonic merge with the list. A direction ends when
// its next tile's nearest candidate has (dx*dx bits & ~(W - 1)) above the
// threshold's: its d2 and every later one in that direction (x-sorted, so
// |dx| only grows) give a key above the threshold, so the selection stays
// exact. Per query this costs ~13 instructions per candidate of the slab
// that the k-th distance spans in x, plus ~10 per insertion (~k ln(slab/k)
// of them) or ~100 per merge, not k rounds over all W keys.
//
// knn_rounds_kernel<W> (k > 32, e.g. k = W / 4). The earlier design: a
// block serves 8 queries of one chunk, one warp each; every lane builds
// W / 32 keys in registers and keeps the smallest; each of k rounds takes
// the warp's minimum with shuffles and the lane that held it rescans, ~k *
// (15 + 2 * W / 32) warp instructions per query.
//
// Bound: operations. The function needs one d2 per window candidate that
// can enter the top k, ~10 float32 operations each (3 sub, 3 mul, 2 add,
// the key's and/or); an x-sorted scan must reach every candidate whose
// dx*dx key lies at or below the k-th key, so chip_smoke.py counts those
// pairs for this run's data, at 67 TFLOP/s.
//
// Exactness: d2 = ((dx*dx + dy*dy) + dz*dz) with dx = q - c, each step
// rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn, and -fmad=false),
// the order of the plain twin in ops/knn.py, so keys agree bit for bit.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int QC = 32;                // queries per chunk, one window each
constexpr int ROW = 128;              // window starts are in rows of 128 candidates
constexpr unsigned FULL = 0xffffffffu;
constexpr int SELECT_MAX_K = 32;      // the select kernel keeps one key per lane
constexpr int SELECT_WARPS = QC;      // the select kernel: a block per chunk, a warp per query
constexpr int SELECT_THREADS = 32 * SELECT_WARPS;
constexpr int SELECT_MIN_BLOCKS = 2;  // resident blocks per SM: one stages while the other selects
constexpr int MERGE_AT = 8;           // tile keys under the threshold that take the merge
constexpr int ROUNDS_WARPS = 8;       // the rounds kernel: queries per block, one warp each
constexpr int ROUNDS_THREADS = 32 * ROUNDS_WARPS;
constexpr int REMOVED = INT_MAX;      // above the key of every finite d2
constexpr int ERR_BAD_WINDOW = -1;    // w is not 512, 1024 or 2048
constexpr int ERR_BAD_SHAPE = -2;     // B*M % QC != 0, k outside (0, w] or no frame rows

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <int W>
__device__ __forceinline__ int pack_key(float px, float py, float pz, float cx, float cy,
                                        float cz, int j) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return (__float_as_int(d2) & ~(W - 1)) | j;
}

// Ascending bitonic sort of one value per lane.
__device__ __forceinline__ int warp_sort(int v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int o = __shfl_xor_sync(FULL, v, stride);
      const bool ascending = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      v = low == ascending ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// Ascending bitonic merge of a bitonic sequence, one value per lane.
__device__ __forceinline__ int warp_merge(int v, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const int o = __shfl_xor_sync(FULL, v, stride);
    v = (lane & stride) == 0 ? min(v, o) : max(v, o);
  }
  return v;
}

// True when no candidate at or beyond x = cx (in the scan's direction) can
// enter: its dx*dx alone keys above the threshold.
template <int W>
__device__ __forceinline__ bool beyond(float px, float cx, int thresh) {
  const float dx = __fsub_rn(px, cx);
  return (__float_as_int(__fmul_rn(dx, dx)) & ~(W - 1)) > (thresh & ~(W - 1));
}

// The k smallest keys of one query over the staged window, by one warp.
template <int W>
__device__ __forceinline__ void select_one(float px, float py, float pz, const float* sx,
                                           const float* sy, const float* sz, int* row, int k,
                                           int lane) {
  constexpr int TILES = W / 32;
  int lo_j = 0, hi_j = W;  // the first candidate with x >= px
  while (lo_j < hi_j) {
    const int mid = (lo_j + hi_j) >> 1;
    if (sx[mid] < px) lo_j = mid + 1;
    else hi_j = mid;
  }
  const int centre = min(lo_j, W - 1) >> 5;

  int list = REMOVED;    // lane l: the l-th smallest key so far
  int thresh = REMOVED;  // the k-th smallest key so far
  auto take_tile = [&](int t) {
    const int j = t * 32 + lane;
    int key = pack_key<W>(px, py, pz, sx[j], sy[j], sz[j], j);
    unsigned in = __ballot_sync(FULL, key < thresh);
    if (__popc(in) >= MERGE_AT) {
      key = warp_sort(key < thresh ? key : REMOVED, lane);
      list = warp_merge(min(list, __shfl_sync(FULL, key, 31 - lane)), lane);
    } else {
      while (in) {
        const int kc = __shfl_sync(FULL, key, __ffs(in) - 1);
        in &= in - 1;
        if (kc < thresh) {  // uniform: the threshold may have fallen meanwhile
          const int pos = __popc(__ballot_sync(FULL, list < kc));
          const int up = __shfl_up_sync(FULL, list, 1);
          if (lane > pos) list = up;
          else if (lane == pos) list = kc;
          thresh = __shfl_sync(FULL, list, k - 1);
        }
      }
    }
    thresh = __shfl_sync(FULL, list, k - 1);
  };

  take_tile(centre);
  int right = centre + 1, left = centre - 1;
  bool to_right = true;
  while (right < TILES || left >= 0) {  // uniform per warp
    if (right < TILES && (to_right || left < 0)) {
      if (beyond<W>(px, sx[right * 32], thresh)) {
        right = TILES;
      } else {
        take_tile(right++);
        to_right = false;
      }
    } else {
      if (beyond<W>(px, sx[left * 32 + 31], thresh)) {
        left = -1;
      } else {
        take_tile(left--);
        to_right = true;
      }
    }
  }
  if (lane < k) row[lane] = list;
}

template <int W>
__global__ void __launch_bounds__(SELECT_THREADS, SELECT_MIN_BLOCKS)
knn_select_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                  const float* __restrict__ qz, const float* __restrict__ xs,
                  const float* __restrict__ ys, const float* __restrict__ zs,
                  const int* __restrict__ lo, int* __restrict__ out, int k,
                  int rows_per_frame, int chunks_per_frame, int* __restrict__ errors) {
  __shared__ __align__(16) float sx[W];
  __shared__ __align__(16) float sy[W];
  __shared__ __align__(16) float sz[W];

  const int chunk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int start = lo[chunk];
  const int first = (chunk / chunks_per_frame) * rows_per_frame;
  if (start < first || start + W / ROW > first + rows_per_frame) {  // uniform per block
    if (threadIdx.x == 0) errors[0] = 1;
    for (int e = threadIdx.x; e < QC * k; e += SELECT_THREADS)
      out[(size_t)chunk * QC * k + e] = -1;
    return;
  }
  const size_t base = (size_t)start * ROW;  // a multiple of 128 floats: 16-byte aligned
  for (int j = threadIdx.x; j < W / 4; j += SELECT_THREADS) {
    reinterpret_cast<float4*>(sx)[j] = reinterpret_cast<const float4*>(xs + base)[j];
    reinterpret_cast<float4*>(sy)[j] = reinterpret_cast<const float4*>(ys + base)[j];
    reinterpret_cast<float4*>(sz)[j] = reinterpret_cast<const float4*>(zs + base)[j];
  }
  __syncthreads();

  for (int q = chunk * QC + (threadIdx.x >> 5); q < (chunk + 1) * QC; q += SELECT_WARPS)
    select_one<W>(qx[q], qy[q], qz[q], sx, sy, sz, out + (size_t)q * k, k, lane);
}

template <int W>
__global__ void __launch_bounds__(ROUNDS_THREADS)
knn_rounds_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                  const float* __restrict__ qz, const float* __restrict__ xs,
                  const float* __restrict__ ys, const float* __restrict__ zs,
                  const int* __restrict__ lo, int* __restrict__ out, int k,
                  int rows_per_frame, int chunks_per_frame, int* __restrict__ errors) {
  constexpr int PER_LANE = W / 32;
  __shared__ float sx[W];
  __shared__ float sy[W];
  __shared__ float sz[W];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * ROUNDS_WARPS + warp;  // QC / ROUNDS_WARPS blocks per chunk
  const int chunk = q / QC;
  const int start = lo[chunk];
  const int first = (chunk / chunks_per_frame) * rows_per_frame;
  if (start < first || start + W / ROW > first + rows_per_frame) {  // uniform per block
    errors[0] = 1;
    for (int r = lane; r < k; r += 32) out[(size_t)q * k + r] = -1;
    return;
  }
  const size_t base = (size_t)start * ROW;
  for (int j = threadIdx.x; j < W; j += ROUNDS_THREADS) {
    sx[j] = xs[base + j];
    sy[j] = ys[base + j];
    sz[j] = zs[base + j];
  }
  __syncthreads();

  const float px = qx[q];
  const float py = qy[q];
  const float pz = qz[q];
  int key[PER_LANE];
  int lmin = REMOVED;
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) {
    const int j = t * 32 + lane;  // neighbouring lanes, neighbouring banks
    key[t] = pack_key<W>(px, py, pz, sx[j], sy[j], sz[j], j);
    lmin = min(lmin, key[t]);
  }

  int* row = out + (size_t)q * k;
  for (int r = 0; r < k; ++r) {
    const int win = warp_min(lmin);
    if (lane == 0) row[r] = win;
    if (lmin == win) {  // the one lane that holds it: keys are unique
      lmin = REMOVED;
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) {
        if (key[t] == win) key[t] = REMOVED;
        lmin = min(lmin, key[t]);
      }
    }
  }
}

template <int W>
int launch(const float* const* a, const void* lo, void* out, int bm, int k, int rows_per_frame,
           int chunks_per_frame, void* errors, const char** kernel, cudaStream_t stream) {
  if (k <= SELECT_MAX_K) {
    *kernel = "knn_select_kernel";
    knn_select_kernel<W><<<bm / QC, SELECT_THREADS, 0, stream>>>(
        a[0], a[1], a[2], a[3], a[4], a[5], (const int*)lo, (int*)out, k, rows_per_frame,
        chunks_per_frame, (int*)errors);
  } else {
    *kernel = "knn_rounds_kernel";
    knn_rounds_kernel<W><<<bm / ROUNDS_WARPS, ROUNDS_THREADS, 0, stream>>>(
        a[0], a[1], a[2], a[3], a[4], a[5], (const int*)lo, (int*)out, k, rows_per_frame,
        chunks_per_frame, (int*)errors);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int knn_queries_per_chunk() { return QC; }
int knn_select_max_k() { return SELECT_MAX_K; }

// qx, qy, qz (bm,), xs, ys, zs (frames * rows_per_frame * ROW,), lo
// (bm / QC,), out (bm, k), errors (1,) int32 (the caller zeroes it; set to 1
// when a window leaves its frame). *kernel gets the name of the kernel
// launched. Returns the CUDA error code of the launch (0 on success) or a
// negative ERR_*.
int knn_launch(const void* qx, const void* qy, const void* qz, const void* xs, const void* ys,
               const void* zs, const void* lo, void* out, int bm, int w, int k,
               int rows_per_frame, int chunks_per_frame, void* errors, const char** kernel,
               void* stream) {
  *kernel = "";
  if (bm == 0) return 0;
  if (bm % QC != 0 || k <= 0 || k > w || rows_per_frame <= 0 || chunks_per_frame <= 0)
    return ERR_BAD_SHAPE;
  const float* a[6] = {(const float*)qx, (const float*)qy, (const float*)qz,
                       (const float*)xs, (const float*)ys, (const float*)zs};
  cudaStream_t s = (cudaStream_t)stream;
  switch (w) {
    case 512: return launch<512>(a, lo, out, bm, k, rows_per_frame, chunks_per_frame, errors,
                                 kernel, s);
    case 1024: return launch<1024>(a, lo, out, bm, k, rows_per_frame, chunks_per_frame, errors,
                                   kernel, s);
    case 2048: return launch<2048>(a, lo, out, bm, k, rows_per_frame, chunks_per_frame, errors,
                                   kernel, s);
    default: return ERR_BAD_WINDOW;
  }
}

const char* knn_error_string(int err) {
  if (err == ERR_BAD_WINDOW) return "the window width must be 512, 1024 or 2048";
  if (err == ERR_BAD_SHAPE) return "B*M must be a multiple of 32, 0 < k <= w and every frame must hold rows";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
