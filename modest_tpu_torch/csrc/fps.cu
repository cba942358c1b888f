// Furthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel modest_tpu/ops/pallas_fps.py::furthest_point_sample_pallas
// (_fps_kernel3d for N % 1024 == 0, _fps_kernel otherwise) and computes what
// modest_tpu/ops/pointnet2.py::_furthest_point_sample_xla computes, index for
// index: slot 0 is point 0, the running min squared distance starts at 1e10,
// and each step takes the argmax of that distance with ties going to the
// lowest index. d2 is ((dx*dx + dy*dy) + dz*dz) with every operation rounded
// on its own (no FMA contraction), which is the plain version's arithmetic.
//
// What bounds it: a chain of npoint dependent argmax reductions over the
// cloud. Every step needs the previous step's winner, so the kernel is bound
// by the latency of one block-wide (or warp-wide) reduction per step, not by
// bandwidth (the inputs are read from device memory once) nor by the ~10 flops
// per point and step.
//
// What the design does about it: one launch runs every step. The cloud's
// coordinates and running distances live in shared memory for the whole
// launch, so a step touches no device memory except one 4-byte index store.
//   * Large clouds (N >= 1024, the backbone): one 1024-thread block per cloud.
//     A step is a thread-local scan over N/1024 points, a warp shuffle argmax,
//     one __syncthreads through a double-buffered table of the 32 warp
//     winners, and a second shuffle argmax that every warp does redundantly,
//     so the winner needs no second barrier to be broadcast.
//   * Small clouds (N < 1024, the RoI tower's 512- and 128-point sub-clouds):
//     one warp per cloud and several clouds per block, so a step needs only
//     warp shuffles and no barrier at all.
// Spreading one cloud over several SMs (thread block clusters) is left to a
// later change.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kBlockThreads = 1024;   // large clouds: one block per cloud
constexpr int kSmallWarps = 4;        // small clouds: clouds (warps) per block
constexpr int kLargeCloud = 1024;     // N at and above which a cloud gets a block
constexpr size_t kMaxSmem = 232448;   // per-block dynamic shared memory on sm_90

__device__ __forceinline__ float dist2(float x, float y, float z,
                                       float lx, float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// argmax order: the larger value wins, equal values go to the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Butterfly reduction: every lane ends with the warp's (max, lowest index).
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// One step over the points j = first, first + stride, ... < n: update the
// running min distance and return this thread's (max, lowest index). j rises
// within a thread, so a strict > keeps the lowest index among equal values.
__device__ __forceinline__ void scan_points(float* sx, float* sy, float* sz, float* sd,
                                            int n, int first, int stride,
                                            float lx, float ly, float lz,
                                            float& bv, int& bi) {
  bv = -1.0f;  // every distance is >= 0, so an empty thread never wins
  bi = INT_MAX;
  for (int j = first; j < n; j += stride) {
    const float d = fminf(sd[j], dist2(sx[j], sy[j], sz[j], lx, ly, lz));
    sd[j] = d;
    if (d > bv) {
      bv = d;
      bi = j;
    }
  }
}

__device__ __forceinline__ void load_cloud(const float* __restrict__ p, float* sx, float* sy,
                                           float* sz, float* sd, int n, int first, int stride) {
  for (int j = first; j < n; j += stride) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
    sd[j] = 1e10f;
  }
}

__global__ void __launch_bounds__(kBlockThreads)
fps_block_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n, int npoint) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* sd = sz + n;
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;

  load_cloud(xyz + static_cast<size_t>(blockIdx.x) * n * 3, sx, sy, sz, sd, n,
             threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int s = 1; s < npoint; ++s) {
    float bv;
    int bi;
    scan_points(sx, sy, sz, sd, n, threadIdx.x, blockDim.x, sx[last], sy[last], sz[last], bv, bi);
    warp_argmax(bv, bi);
    // Double buffer: the table written at step s is next written at step
    // s + 2, after the barrier of step s + 1, by which point every warp has
    // read it.
    const int buf = s & 1;
    if (lane == 0) {
      red_v[buf][warp] = bv;
      red_i[buf][warp] = bi;
    }
    __syncthreads();
    bv = lane < nwarps ? red_v[buf][lane] : -1.0f;
    bi = lane < nwarps ? red_i[buf][lane] : INT_MAX;
    warp_argmax(bv, bi);
    last = bi;
    if (threadIdx.x == 0) o[s] = bi;
  }
}

__global__ void __launch_bounds__(kSmallWarps * 32)
fps_warp_kernel(const float* __restrict__ xyz, int* __restrict__ out, int batch, int n,
                int npoint) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kSmallWarps + warp;
  if (b >= batch) return;  // the whole warp leaves; no block barrier follows

  float* sx = smem + static_cast<size_t>(warp) * 4 * n;
  float* sy = sx + n;
  float* sz = sy + n;
  float* sd = sz + n;
  int* o = out + static_cast<size_t>(b) * npoint;

  load_cloud(xyz + static_cast<size_t>(b) * n * 3, sx, sy, sz, sd, n, lane, 32);
  if (lane == 0) o[0] = 0;
  __syncwarp();

  int last = 0;
  for (int s = 1; s < npoint; ++s) {
    float bv;
    int bi;
    scan_points(sx, sy, sz, sd, n, lane, 32, sx[last], sy[last], sz[last], bv, bi);
    warp_argmax(bv, bi);
    last = bi;
    if (lane == 0) o[s] = bi;
  }
}

}  // namespace

extern "C" {

// Largest N one launch takes: coordinates and distances of a cloud must fit
// one block's shared memory, beside the 512-byte reduction table.
int fps_max_points() { return static_cast<int>((kMaxSmem - 1024) / (4 * sizeof(float))); }

// xyz: (batch, n, 3) float32, contiguous, on the device; out: (batch, npoint)
// int32. Launches on `stream` and returns cudaGetLastError() (0 on success);
// *kernel (host memory) gets the name of the kernel it launched.
int fps_launch(const float* xyz, int* out, int batch, int n, int npoint, const char** kernel,
               void* stream) {
  if (batch <= 0 || n <= 0 || npoint <= 0 || n > fps_max_points()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n >= kLargeCloud) {
    *kernel = "fps_block_kernel";
    const size_t smem = 4 * sizeof(float) * static_cast<size_t>(n);
    cudaError_t e = cudaFuncSetAttribute(fps_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    fps_block_kernel<<<batch, kBlockThreads, smem, st>>>(xyz, out, n, npoint);
  } else {
    *kernel = "fps_warp_kernel";
    const size_t smem = kSmallWarps * 4 * sizeof(float) * static_cast<size_t>(n);
    cudaError_t e = cudaFuncSetAttribute(fps_warp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = (batch + kSmallWarps - 1) / kSmallWarps;
    fps_warp_kernel<<<blocks, kSmallWarps * 32, smem, st>>>(xyz, out, batch, n, npoint);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
