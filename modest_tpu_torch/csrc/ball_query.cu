// The masked ball query of PV-RCNN's voxel set abstraction and RoI-grid pool,
// for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's ball query
// (modest_tpu/ops/pointnet2_stack.py::ball_query_masked) is plain jnp that
// XLA compiles. The kernel exists because the port's plain version
// (modest_tpu_torch/ops/pointnet2_stack.py::ball_query_masked_plain, kept as
// its plain twin) wrote a (B, M, N) squared-distance matrix per call, masked
// it, rewrote it as -index or -inf and ran a sorted radix top-k over it: for
// the raw points 4 x 2048 x 65536 entries, 2.1 GB a matrix, twice a batch.
//
// idx[b, m, :] holds the first nsample sources n (by index) of cloud b whose
// squared distance to centre m is strictly below r2 and whose mask is set;
// unfilled slots repeat the first hit; a centre with no hit gets index 0 in
// every slot and empty[b, m] = 1. When nsample > N, slot s takes hit s % N,
// or the first hit where there is none, as the plain twin's wrap-fill does.
//
// What bounds it: operations. A pair test is 10 float operations (an FMA
// counted as two), and every source is read once a block of kWarps centres
// from L2 (the whole cloud, 65536 x 12 B on Lyft and 131072 x 12 B on Waymo,
// stays in the 50 MB L2), so device memory sees the inputs once and the int64
// indices written. At full scan the cell's 2.48e9 pair tests a batch need
// ~0.37 ms at 67 TFLOP/s.
//
// Design: a block holds kWarps centres of one cloud, a warp a centre. The
// block stages the sources kTile at a time in shared memory as float4
// (x, y, z, |s|^2) with one word of mask bits per 32 sources, so |s|^2 is
// computed once a source per block, not once a pair. A warp's lanes test 32
// consecutive sources at once; __ballot_sync gives the warp its hits as a
// word, and __popc of the bits below a lane gives that lane's hit its slot in
// index order, so the slots fill in index order with no sort. A warp stops
// once nsample hits are found, and the block stops loading tiles once each of
// its warps has stopped: a centre reads only as far as its nsample-th hit,
// and only a sparse or empty ball scans all N. No (B, M, N) matrix exists.
// Any N is taken: the cloud is never held whole in shared memory.
//
// Exactness: membership is decided on the plain twin's d2, bit for bit. The
// plain twin takes ops/pointnet2.py::pairwise_dist2: |c|^2 + |s|^2 - 2 * cross,
// with |v|^2 = (v0 * v0 + v1 * v1) + v2 * v2 every operation rounded on its
// own (-fmad=false), cross from cuBLAS's float32 product with K = 3, which on
// the H100 at every shape the benchmark's cell and Waymo run is the FMA chain
// fma(c2, s2, fma(c1, s1, c0 * s0)) (established on the card against
// torch.matmul, bit for bit; ball_query_cross_launch writes the chain alone,
// so a check can tell a change of cuBLAS's order from a fault here), then
// clamped at 0, and d2 < r2 with r2 the float32 of the host's double
// radius * radius. The twin sets a masked source's d2 to 1e9; the caller
// refuses r2 >= 1e9, so a masked source is out of every ball in both.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // centres a block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;            // sources a block stages at a time
constexpr int kWords = kTile / 32;     // mask words a tile
constexpr int kMaxSample = 64;
constexpr int kMaxBatch = 65535;       // gridDim.y
constexpr float kBig = 1e9f;           // a masked source's d2 in the plain twin
constexpr int kCrossThreads = 256;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return (x * x + y * y) + z * z;
}

// cuBLAS's float32 K = 3 product of a centre and a source, in its order
__device__ __forceinline__ float cross3(float cx, float cy, float cz, float sx, float sy,
                                       float sz) {
  return __fmaf_rn(cz, sz, __fmaf_rn(cy, sy, cx * sx));
}

__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz, const bool* __restrict__ mask,
                  const float* __restrict__ centres, int n, int m, float r2, int nsample,
                  long long* __restrict__ idx, bool* __restrict__ empty) {
  __shared__ float4 tile[kTile];
  __shared__ unsigned valid_bits[kWords];  // in range and mask set
  __shared__ int slots[kWarps][kMaxSample];

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int centre = blockIdx.x * kWarps + warp;
  const unsigned below = (1u << lane) - 1u;
  const float* src = xyz + (long long)b * n * 3;
  const bool* src_mask = mask + (long long)b * n;

  float cx = 0.f, cy = 0.f, cz = 0.f, cn = 0.f;
  bool done = centre >= m;
  if (!done) {
    const float* c = centres + ((long long)b * m + centre) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
    cn = sq_norm(cx, cy, cz);
  }
  int count = 0;

  for (int base = 0; base < n; base += kTile) {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int j = base + i;
      const bool in_range = j < n;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      bool valid = false;
      if (in_range) {
        s.x = src[(long long)j * 3];
        s.y = src[(long long)j * 3 + 1];
        s.z = src[(long long)j * 3 + 2];
        s.w = sq_norm(s.x, s.y, s.z);
        valid = src_mask[j];
      }
      tile[i] = s;
      const unsigned v = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) valid_bits[i / 32] = v;
    }
    __syncthreads();
    if (!done) {
      const int words = min(kWords, (n - base + 31) / 32);
      for (int w = 0; w < words; ++w) {
        const float4 s = tile[w * 32 + lane];
        float d2 = (cn + s.w) - 2.0f * cross3(cx, cy, cz, s.x, s.y, s.z);
        d2 = d2 < 0.f ? 0.f : d2;  // clamp_min(0), a NaN kept
        const unsigned hits = __ballot_sync(0xffffffffu, d2 < r2) & valid_bits[w];
        if (hits) {
          const int slot = count + __popc(hits & below);
          if (((hits >> lane) & 1u) && slot < nsample) slots[warp][slot] = base + w * 32 + lane;
          count += __popc(hits);
          if (count >= nsample) {
            done = true;
            break;
          }
        }
      }
    }
    // every warp done: no further tile; else the barrier before the next load
    if (__syncthreads_and(done)) break;
  }

  __syncwarp();
  if (centre >= m) return;
  const int found = min(count, nsample);
  const int first = found > 0 ? slots[warp][0] : 0;
  long long* out = idx + ((long long)b * m + centre) * nsample;
  for (int s = lane; s < nsample; s += 32) {
    const int k = s % n;  // s itself unless nsample > n: the wrap-fill
    out[s] = k < found ? slots[warp][k] : first;
  }
  if (lane == 0) empty[(long long)b * m + centre] = found == 0;
}

// out[b, i, j] = the cross term of centre i and source j of cloud b
__global__ void __launch_bounds__(kCrossThreads)
ball_query_cross_kernel(const float* __restrict__ xyz, const float* __restrict__ centres, int n,
                        int m, float* __restrict__ out) {
  const int j = blockIdx.x * kCrossThreads + threadIdx.x;
  const int i = blockIdx.y, b = blockIdx.z;
  if (j >= n) return;
  const float* c = centres + ((long long)b * m + i) * 3;
  const float* s = xyz + ((long long)b * n + j) * 3;
  out[((long long)b * m + i) * n + j] = cross3(c[0], c[1], c[2], s[0], s[1], s[2]);
}

}  // namespace

extern "C" {

// xyz (batch, n, 3) float32, mask (batch, n) bool, centres (batch, m, 3)
// float32, all contiguous on the device; idx (batch, m, nsample) int64 and
// empty (batch, m) bool, contiguous, written whole. 1 <= nsample <=
// kMaxSample, n >= 1, batch <= kMaxBatch, r2 < kBig (checked by the caller,
// and refused here with cudaErrorInvalidValue). Launches on `stream` and
// returns the CUDA error code of the launch (0 on success; no launch when
// batch or m is 0).
int ball_query_launch(const void* xyz, const void* mask, const void* centres, int batch, int n,
                      int m, float r2, int nsample, void* idx, void* empty, void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  if (n <= 0 || nsample <= 0 || nsample > kMaxSample || batch > kMaxBatch || !(r2 < kBig))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((m + kWarps - 1) / kWarps);
  ball_query_kernel<<<dim3(blocks, static_cast<unsigned>(batch)), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const bool*>(mask),
      static_cast<const float*>(centres), n, m, r2, nsample, static_cast<long long*>(idx),
      static_cast<bool*>(empty));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's cross term alone: out (batch, m, n) float32, contiguous, from
// xyz (batch, n, 3) and centres (batch, m, 3) as above; m and batch at most
// kMaxBatch. Launches on `stream` and returns the launch's CUDA error code.
int ball_query_cross_launch(const void* xyz, const void* centres, int batch, int n, int m,
                            void* out, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (batch > kMaxBatch || m > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kCrossThreads - 1) / kCrossThreads),
                  static_cast<unsigned>(m), static_cast<unsigned>(batch));
  ball_query_cross_kernel<<<grid, kCrossThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(centres), n, m,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* ball_query_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
