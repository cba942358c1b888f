// Rotated BEV box overlap, the Sutherland–Hodgman clip, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's clip
// (modest_tpu/ops/iou3d.py::_overlap_sh) is plain jnp that XLA fuses. The
// kernel exists because the port's eager clip
// (modest_tpu_torch/ops/iou3d.py::_overlap_sh, kept as its plain twin) was the
// port's longest device operation: four int64 compaction scans over
// (..., 16) candidate masks and ~100 small launches a call, under every NMS
// (boxes_iou_bev) and the RoI sampler (boxes_iou3d).
//
// out[l, n, m] is the area of box b[l, m]'s BEV rectangle clipped by the four
// half-planes of box a[l, n]. Boxes are (x, y, z, dx, dy, dz, heading); the
// kernel reads x, y, dx and dy of rows whose seven values are consecutive,
// at a row stride and a batch stride of the caller's (a batch stride of 0
// broadcasts one set of boxes over the batch with no copy), and the cosine
// and sine of each heading from the caller: ops/iou3d.py takes them with
// torch.cos and torch.sin, the plain twin's own functions, so the corners are
// the twin's bit for bit whatever libdevice the toolkit brings, and the
// kernel holds no trigonometric slow path (libdevice's cosf and sinf reduce
// a large argument in a local array, a 32-byte stack frame).
//
// What bounds it: operations. About 4 edges x 16 candidates x ~12 float
// operations a pair, ~768, at 67 TFLOP/s of float32; the output's 4 bytes a
// pair (8 in float64) and the boxes, read once a tile, are far below that.
//
// Design: a block owns a 16 x 16 tile of pairs, one thread a pair. Its first
// 16 threads compute the corners of the tile's 16 clip boxes once, with their
// four edge vectors and tolerances, and 16 threads of the next warp the
// corners of its 16 subject boxes, into shared memory: once a box, not once
// a pair. Each thread then clips its pair in registers: the polygon is eight
// fixed slots of x and of y, the four edges and every slot loop are
// unrolled, and a kept candidate goes to its slot by predicated selects over
// the slots (the slot index is never a run-time array index), so nothing
// goes to local memory; the -Xptxas -v log reports no stack frame and no
// spill. The subject box is the block's column, so neighbouring threads
// write neighbouring outputs.
//
// Exactness: every float operation is the eager clip's, in its order and
// rounded on its own (-fmad=false, IEEE division and sqrt, no fast math):
// the corners as _bev_corners computes them (lx = sx * dx, (lx * c - ly * s)
// + cx from the heading's c and s), the tolerance 1e-3 * sqrt(ex * ex +
// ey * ey), d = ex * (py - a0y) - ey * (px - a0x), t = d / (|denom| > 1e-8 ?
// denom : 1), the crossing px + t * (nx - px), the compaction rule (the k-th
// kept of the candidates [vertex j, crossing j], j = 0..7, goes to slot k,
// those past slot 7 are dropped), the successor rule (slot j + 1 if valid,
// else slot 0) and the shoelace summed left to right over the eight slots.
// So on the card the areas equal the plain twin's bit for bit, and every NMS
// keep set and RoI sample with them.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                // boxes a side of a block's tile
constexpr int kMaxV = 8;                 // vertices of a quad ∩ quad, at most
constexpr int kMaxBatch = 65535;         // gridDim.y

__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }
__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }

// The CCW BEV corners of one box, from (-dx/2, -dy/2), as _bev_corners; c
// and s are the cosine and sine of its heading.
template <typename T>
__device__ __forceinline__ void corners(const T* __restrict__ box, T c, T s, T* x, T* y) {
  const T cx = box[0], cy = box[1], dx = box[3], dy = box[4];
  const T sx[4] = {T(-0.5), T(0.5), T(0.5), T(-0.5)};
  const T sy[4] = {T(-0.5), T(-0.5), T(0.5), T(0.5)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T lx = sx[k] * dx, ly = sy[k] * dy;
    x[k] = (lx * c - ly * s) + cx;
    y[k] = (lx * s + ly * c) + cy;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile * kTile)
overlap_kernel(const T* __restrict__ a, long long a_batch, long long a_row,
               const T* __restrict__ a_cos, const T* __restrict__ a_sin, long long a_trig, int n,
               const T* __restrict__ b, long long b_batch, long long b_row,
               const T* __restrict__ b_cos, const T* __restrict__ b_sin, long long b_trig, int m,
               int tiles_m, T* __restrict__ out) {
  // the tile's clip boxes: corners, edge vectors, tolerances; its subject boxes: corners
  __shared__ T ax[kTile][4], ay[kTile][4], aex[kTile][4], aey[kTile][4], atol[kTile][4];
  __shared__ T bx[kTile][4], by[kTile][4];
  const int l = blockIdx.y;
  const int n0 = (blockIdx.x / tiles_m) * kTile, m0 = (blockIdx.x % tiles_m) * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  if (tid < kTile) {
    if (n0 + tid < n) {
      T x[4], y[4];
      const long long t = l * a_trig + n0 + tid;
      corners(a + l * a_batch + (long long)(n0 + tid) * a_row, a_cos[t], a_sin[t], x, y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T ex = x[(e + 1) % 4] - x[e], ey = y[(e + 1) % 4] - y[e];
        ax[tid][e] = x[e];
        ay[tid][e] = y[e];
        aex[tid][e] = ex;
        aey[tid][e] = ey;
        // ~1 mm distance tolerance: coincident-edge vertices stay inside
        atol[tid][e] = static_cast<T>(1e-3) * sqrt_(ex * ex + ey * ey);
      }
    }
  } else if (tid >= 32 && tid < 32 + kTile) {
    const int j = tid - 32;
    if (m0 + j < m) {
      const long long t = l * b_trig + m0 + j;
      corners(b + l * b_batch + (long long)(m0 + j) * b_row, b_cos[t], b_sin[t], bx[j], by[j]);
    }
  }
  __syncthreads();

  const int r = threadIdx.y, q = threadIdx.x;
  if (n0 + r >= n || m0 + q >= m) return;

  T px[kMaxV], py[kMaxV];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = bx[q][k];
    py[k] = by[q][k];
    px[k + 4] = T(0);
    py[k + 4] = T(0);
  }
  int count = 4;  // the valid slots are always 0 .. count - 1

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const T a0x = ax[r][e], a0y = ay[r][e], ex = aex[r][e], ey = aey[r][e];
    const T ntol = -atol[r][e];
    T d[kMaxV];
#pragma unroll
    for (int j = 0; j < kMaxV; ++j) d[j] = ex * (py[j] - a0y) - ey * (px[j] - a0x);

    T qx[kMaxV], qy[kMaxV];
#pragma unroll
    for (int k = 0; k < kMaxV; ++k) {
      qx[k] = T(0);
      qy[k] = T(0);
    }
    int kept = 0;
#pragma unroll
    for (int j = 0; j < kMaxV; ++j) {
      const bool valid = j < count;
      // slot j's successor: slot j + 1 if valid, else slot 0; its d is the
      // same expression of the same coordinates, so it is taken, not redone
      const bool succ = j + 1 < kMaxV && j + 1 < count;
      const int sj = (j + 1) % kMaxV;
      const T nx = succ ? px[sj] : px[0];
      const T ny = succ ? py[sj] : py[0];
      const T nd = succ ? d[sj] : d[0];
      const bool inside = d[j] >= ntol;
      const bool n_in = nd >= ntol;
      const T denom = d[j] - nd;
      const bool ok_den = abs_(denom) > static_cast<T>(1e-8);
      const T t = d[j] / (ok_den ? denom : T(1));
      const T ix = px[j] + t * (nx - px[j]);
      const T iy = py[j] + t * (ny - py[j]);
      // candidates [vertex j, crossing j]: the k-th kept goes to slot k,
      // those past slot 7 are dropped
      const bool keep_v = inside && valid;
#pragma unroll
      for (int s = 0; s < kMaxV; ++s) {
        const bool hit = keep_v && kept == s;
        qx[s] = hit ? px[j] : qx[s];
        qy[s] = hit ? py[j] : qy[s];
      }
      kept += keep_v;
      const bool keep_c = inside != n_in && valid && ok_den;
#pragma unroll
      for (int s = 0; s < kMaxV; ++s) {
        const bool hit = keep_c && kept == s;
        qx[s] = hit ? ix : qx[s];
        qy[s] = hit ? iy : qy[s];
      }
      kept += keep_c;
    }
#pragma unroll
    for (int k = 0; k < kMaxV; ++k) {
      px[k] = qx[k];
      py[k] = qy[k];
    }
    count = kept < kMaxV ? kept : kMaxV;
  }

  // shoelace over the compact polygon (wrap to slot 0), left to right
  T area = T(0);
#pragma unroll
  for (int j = 0; j < kMaxV; ++j) {
    const bool succ = j + 1 < kMaxV && j + 1 < count;
    const int sj = (j + 1) % kMaxV;
    const T nx = succ ? px[sj] : px[0];
    const T ny = succ ? py[sj] : py[0];
    const T term = j < count ? px[j] * ny - nx * py[j] : T(0);
    area = j == 0 ? term : area + term;
  }
  out[((long long)l * n + n0 + r) * m + m0 + q] =
      count >= 3 ? static_cast<T>(0.5) * abs_(area) : T(0);
}

template <typename T>
int launch(const void* a, long long a_batch, long long a_row, const void* a_cos,
           const void* a_sin, long long a_trig, int n, const void* b, long long b_batch,
           long long b_row, const void* b_cos, const void* b_sin, long long b_trig, int m, int l,
           void* out, void* stream) {
  if (l <= 0 || n <= 0 || m <= 0) return 0;
  const long long tiles_m = (m + kTile - 1) / kTile;
  const long long tiles = (n + kTile - 1) / kTile * tiles_m;
  if (l > kMaxBatch || tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  overlap_kernel<T><<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(l)),
                      dim3(kTile, kTile), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), a_batch, a_row, static_cast<const T*>(a_cos),
      static_cast<const T*>(a_sin), a_trig, n, static_cast<const T*>(b), b_batch, b_row,
      static_cast<const T*>(b_cos), static_cast<const T*>(b_sin), b_trig, m,
      static_cast<int>(tiles_m), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int iou3d_tile() { return kTile; }
int iou3d_max_batch() { return kMaxBatch; }

// a (l, n, 7) and b (l, m, 7) at the given batch and row strides (elements;
// a row's seven values consecutive); a_cos and a_sin (l, n), the cosine and
// sine of a's headings, at batch stride a_trig and row stride 1, b_cos and
// b_sin (l, m) likewise; out (l, n, m) contiguous; all float32, or all
// float64 when is_double. l <= iou3d_max_batch() and at most INT_MAX tiles
// of iou3d_tile()^2 pairs (checked by the caller). Returns the CUDA error
// code of the launch (0 on success; no launch for an empty output).
int iou3d_overlap_launch(const void* a, long long a_batch, long long a_row, const void* a_cos,
                         const void* a_sin, long long a_trig, int n, const void* b,
                         long long b_batch, long long b_row, const void* b_cos,
                         const void* b_sin, long long b_trig, int m, int l, int is_double,
                         void* out, void* stream) {
  return is_double ? launch<double>(a, a_batch, a_row, a_cos, a_sin, a_trig, n, b, b_batch,
                                    b_row, b_cos, b_sin, b_trig, m, l, out, stream)
                   : launch<float>(a, a_batch, a_row, a_cos, a_sin, a_trig, n, b, b_batch,
                                   b_row, b_cos, b_sin, b_trig, m, l, out, stream);
}

const char* iou3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
