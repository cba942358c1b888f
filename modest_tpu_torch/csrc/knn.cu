// Windowed k nearest neighbours over x-sorted candidates, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel modest_tpu/ops/pallas_knn.py
// (_knn_windows -> _knn_kernel). Every chunk of QC = 32 x-sorted queries
// shares one window of W consecutive x-sorted candidates that starts at the
// 128-candidate row lo[chunk]. For each query, rank the window by the int32
// key (d2_bits & ~(W - 1)) | j, j the window-local index, and write the k
// smallest keys in ascending order. The bits of a non-negative float32
// order like its value, and the low bits make every key of a row unique.
//
// Layout: queries qx, qy, qz (B*M,) float32, x-sorted per frame; candidates
// xs, ys, zs (B*N,) float32 SoA, x-sorted per frame, frames stacked; lo
// (B*M / QC,) int32, each chunk's window start row;
// out (B*M, k) int32. A window that leaves its chunk's frame (frames of
// rows_per_frame rows and chunks_per_frame chunks) is not read: the block
// sets errors[0] = 1 and writes -1 into its rows, and the wrapper raises.
//
// Design: the Pallas kernel holds a (QC, W) key buffer in VMEM (256 KB at
// W = 2048) and sweeps it k times; no Hopper block holds that. Here a block
// serves WARPS = 8 queries of one chunk, one warp each: it stages the
// chunk's window as planar x, y, z in shared memory (24 KB at W = 2048),
// then every lane builds W / 32 keys in registers (W is a template
// parameter, so the key array is fully unrolled and never spills to local
// memory) and keeps the smallest of them. Each of the k rounds takes the
// warp's minimum with shuffles, writes it, and the one lane that held it
// drops that key and finds its next smallest.
//
// Bound: the function needs B*M*W pair distances at ~10 float32 operations
// each (3 sub, 3 mul, 2 add, the key's and/or), which bounds it by
// operations (SA1 of the flagship backbone, 3.36e7 pairs: ~5 us at
// 67 TFLOP/s). This design adds the selection: k rounds of 5 shuffles and a
// rescan of W / 32 keys by one lane, ~k * (10 + 3 * W / 32) warp
// instructions per query, which is more than the distances for k = 32 and is
// the algorithm's cost, not the function's. A later version can select with
// a per-lane sorted prefix or a radix pass over the key bits.
//
// Exactness: d2 = ((dx*dx + dy*dy) + dz*dz) with dx = q - c, each step
// rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn, and -fmad=false),
// the order of the plain twin in ops/knn.py, so keys agree bit for bit.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int QC = 32;                // queries per chunk, one window each
constexpr int WARPS = 8;              // queries per block, one warp each
constexpr int THREADS = 32 * WARPS;
constexpr int ROW = 128;              // window starts are in rows of 128 candidates
constexpr int REMOVED = INT_MAX;      // above the key of every finite d2
constexpr int ERR_BAD_WINDOW = -1;    // w is not 512, 1024 or 2048
constexpr int ERR_BAD_SHAPE = -2;     // B*M % QC != 0, k outside (0, w] or no frame rows

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int W>
__global__ void __launch_bounds__(THREADS)
knn_window_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
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
  const int q = blockIdx.x * WARPS + warp;  // QC / WARPS consecutive blocks per chunk
  const int chunk = q / QC;
  const int start = lo[chunk];
  const int first = (chunk / chunks_per_frame) * rows_per_frame;
  if (start < first || start + W / ROW > first + rows_per_frame) {  // uniform per block
    errors[0] = 1;
    for (int r = lane; r < k; r += 32) out[(size_t)q * k + r] = -1;
    return;
  }
  const size_t base = (size_t)start * ROW;
  for (int j = threadIdx.x; j < W; j += THREADS) {
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
    const float dx = __fsub_rn(px, sx[j]);
    const float dy = __fsub_rn(py, sy[j]);
    const float dz = __fsub_rn(pz, sz[j]);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    key[t] = (__float_as_int(d2) & ~(W - 1)) | j;
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
           int chunks_per_frame, void* errors, void* stream) {
  knn_window_kernel<W><<<bm / WARPS, THREADS, 0, (cudaStream_t)stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], (const int*)lo, (int*)out, k, rows_per_frame,
      chunks_per_frame, (int*)errors);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int knn_queries_per_chunk() { return QC; }

// qx, qy, qz (bm,), xs, ys, zs (frames * rows_per_frame * ROW,), lo
// (bm / QC,), out (bm, k), errors (1,) int32 (the caller zeroes it; set to 1
// when a window leaves its frame). Returns the CUDA error code of the launch
// (0 on success) or a negative ERR_*.
int knn_launch(const void* qx, const void* qy, const void* qz, const void* xs, const void* ys,
               const void* zs, const void* lo, void* out, int bm, int w, int k,
               int rows_per_frame, int chunks_per_frame, void* errors, void* stream) {
  if (bm == 0) return 0;
  if (bm % QC != 0 || k <= 0 || k > w || rows_per_frame <= 0 || chunks_per_frame <= 0)
    return ERR_BAD_SHAPE;
  const float* a[6] = {(const float*)qx, (const float*)qy, (const float*)qz,
                       (const float*)xs, (const float*)ys, (const float*)zs};
  switch (w) {
    case 512: return launch<512>(a, lo, out, bm, k, rows_per_frame, chunks_per_frame, errors,
                                 stream);
    case 1024: return launch<1024>(a, lo, out, bm, k, rows_per_frame, chunks_per_frame, errors,
                                   stream);
    case 2048: return launch<2048>(a, lo, out, bm, k, rows_per_frame, chunks_per_frame, errors,
                                   stream);
    default: return ERR_BAD_WINDOW;
  }
}

const char* knn_error_string(int err) {
  if (err == ERR_BAD_WINDOW) return "the window width must be 512, 1024 or 2048";
  if (err == ERR_BAD_SHAPE) return "B*M must be a multiple of 32, 0 < k <= w and every frame must hold rows";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
