// PP-gated DBSCAN over a batched kNN graph, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of modest_tpu/ops/pallas_dbscan.py
// (dbscan_device_impl -> _edge_kernel and _prop_kernel). The TPU kernels
// move neighbour labels with banded lane shuffles (slot stacks, x-sorted
// windows, i16 local indices) because the TPU has no fast gather; Hopper
// gathers from global memory directly, so none of that layout is kept and
// any N, k and window width is taken.
//
// Inputs for B frames of N points, flattened to total = B * N rows:
//   idx (total, k) int32 frame-local neighbour indices, d2 (total, k) float32
//   squared distances (inf on empty slots), pp (total,) float32, valid
//   (total,) uint8.
//
// Edge (dbscan_edge_launch): kth[i] = the largest finite d2 of row i (-1
// when none or when i is invalid); then slot s of point i is an edge to
// j = idx[i, s] when d2 is finite, d2 <= r2, d2 <= kth[j] (i lies within
// j's k-th neighbour distance) and |pp[i] - pp[j]| <= eps, all in float32.
// Writes nbr (total, k) int32 global neighbour rows (-1 where no edge),
// core = valid & (degree + 1 >= min_samples), and the initial labels:
// own global index for core points, SENT otherwise.
//
// Propagation (dbscan_prop_launch): a sweep kernel gives each core point
// the smallest label among its edge neighbours (non-core neighbours carry
// SENT) and raises a per-sweep `changed` flag; a pointer-jump kernel sets
// lab = min(lab, lab[lab]). Sweeps repeat until one changes nothing: then
// every core label equals the smallest core index reachable from it over
// edges, the fixpoint of modest_tpu/pipeline/clustering.py::
// _cluster_from_knn_impl, whatever order the updates ran in. The host reads
// the flags once per ROUNDS_PER_SYNC sweeps. A border kernel then writes
// the frame-local labels of every point into a separate output: core points
// their label, non-core valid points the smallest label of a core edge
// neighbour (from the converged table), else -1.
//
// Edge, sweep and border kernels run one warp per point: its lanes read the
// point's k slots as one coalesced row and reduce with shuffles. Every
// kernel is bound by bytes: the (total, k) rows are read once per sweep,
// and the label gathers hit a table of 4 * total bytes that stays in L2.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SENT = 0x3FFFFFFF;     // label of non-core points (above any index)
constexpr int ROUNDS_PER_SYNC = 4;   // sweeps launched between two host reads of the flags
constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = 32 * WARPS_PER_BLOCK;
constexpr int ERR_BAD_INDEX = -1;    // a neighbour index outside [0, N)
constexpr int ERR_NO_FIXPOINT = -2;  // max_sweeps sweeps and still changing

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void kth_kernel(const float* __restrict__ d2, const unsigned char* __restrict__ valid,
                           float* __restrict__ kth, int total, int k) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= total) return;
  const float* row = d2 + (size_t)i * k;
  float m = -1.0f;
  for (int s = lane; s < k; s += 32) {
    const float v = row[s];
    if (isfinite(v)) m = fmaxf(m, v);
  }
  m = warp_max(m);
  if (lane == 0) kth[i] = valid[i] ? m : -1.0f;
}

__global__ void edge_kernel(const int* __restrict__ idx, const float* __restrict__ d2,
                            const float* __restrict__ pp, const float* __restrict__ kth,
                            int* __restrict__ nbr, unsigned char* __restrict__ core,
                            int* __restrict__ lab, int* __restrict__ flags, int total, int n,
                            int k, float r2, float eps, int min_samples,
                            const unsigned char* __restrict__ valid) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= total) return;
  const int off = (i / n) * n;
  const float pp_i = pp[i];
  int deg = 0;
  for (int s = lane; s < k; s += 32) {
    const size_t e = (size_t)i * k + s;
    const float d = d2[e];
    int out = -1;
    if (isfinite(d) && d <= r2) {
      const int jl = idx[e];
      if (jl < 0 || jl >= n) {
        atomicExch(flags, 1);
      } else {
        const int j = off + jl;
        if (d <= kth[j] && fabsf(__fsub_rn(pp_i, pp[j])) <= eps) out = j;
      }
    }
    nbr[e] = out;
    deg += out >= 0;
  }
  deg = warp_sum(deg);
  if (lane == 0) {
    const bool c = valid[i] && deg + 1 >= min_samples;
    core[i] = c;
    lab[i] = c ? i : SENT;
  }
}

__global__ void sweep_kernel(const int* __restrict__ nbr, int* lab, int* changed, int total,
                             int k) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= total) return;
  const int own = lab[i];
  if (own >= SENT) return;  // non-core: never relabelled here (uniform per warp)
  int m = own;
  for (int s = lane; s < k; s += 32) {
    const int j = nbr[(size_t)i * k + s];
    if (j >= 0) m = min(m, lab[j]);
  }
  m = warp_min(m);
  if (lane == 0 && m < own) {
    lab[i] = m;
    *changed = 1;
  }
}

__global__ void jump_kernel(int* lab, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int l = lab[i];
  if (l >= SENT) return;
  const int ll = lab[l];
  if (ll < l) lab[i] = ll;
}

__global__ void border_kernel(const int* __restrict__ nbr, const int* __restrict__ lab,
                              const unsigned char* __restrict__ core,
                              const unsigned char* __restrict__ valid, int* __restrict__ out,
                              int total, int n, int k) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= total) return;
  int m = SENT;
  if (core[i]) {
    m = lab[i];
  } else if (valid[i]) {
    for (int s = lane; s < k; s += 32) {
      const int j = nbr[(size_t)i * k + s];
      if (j >= 0) m = min(m, lab[j]);  // lab[j] < SENT exactly when j is core
    }
    m = warp_min(m);
  }
  if (lane == 0) out[i] = m < SENT ? m - (i / n) * n : -1;
}

inline int warp_blocks(int total) { return (total + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK; }

}  // namespace

extern "C" {

int dbscan_sentinel() { return SENT; }
int dbscan_rounds_per_sync() { return ROUNDS_PER_SYNC; }

// flags: 1 + ROUNDS_PER_SYNC int32 of scratch shared with dbscan_prop_launch
// (flags[0] = a bad neighbour index was seen). kth: total float32 of scratch.
// *kernels gets the kernels launched (2).
int dbscan_edge_launch(const void* idx, const void* d2, const void* pp, const void* valid,
                       void* kth, void* nbr, void* core, void* lab, void* flags, int total,
                       int n, int k, float r2, float eps, int min_samples, void* stream,
                       int* kernels) {
  cudaStream_t s = (cudaStream_t)stream;
  *kernels = 0;
  if (total <= 0) return 0;
  cudaMemsetAsync(flags, 0, sizeof(int) * (1 + ROUNDS_PER_SYNC), s);
  kth_kernel<<<warp_blocks(total), THREADS, 0, s>>>((const float*)d2,
                                                    (const unsigned char*)valid, (float*)kth,
                                                    total, k);
  edge_kernel<<<warp_blocks(total), THREADS, 0, s>>>(
      (const int*)idx, (const float*)d2, (const float*)pp, (const float*)kth, (int*)nbr,
      (unsigned char*)core, (int*)lab, (int*)flags, total, n, k, r2, eps, min_samples,
      (const unsigned char*)valid);
  *kernels = 2;
  return (int)cudaGetLastError();
}

// Runs sweeps + pointer jumps to the fixpoint, then the border kernel into
// out (total,) int32 frame-local labels (-1 noise). Synchronises the stream
// once per ROUNDS_PER_SYNC sweeps. *sweeps gets the sweeps launched,
// *kernels the kernels launched (2 per sweep + the border kernel) and
// *host_reads the host reads of the flags.
int dbscan_prop_launch(const void* nbr, void* lab, const void* core, const void* valid,
                       void* out, void* flags, int total, int n, int k, int max_sweeps,
                       int* sweeps, int* kernels, int* host_reads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *sweeps = *kernels = *host_reads = 0;
  if (total <= 0) return 0;
  int* f = (int*)flags;
  int host[1 + ROUNDS_PER_SYNC];
  const int point_blocks = (total + THREADS - 1) / THREADS;
  for (;;) {
    cudaMemsetAsync(f + 1, 0, sizeof(int) * ROUNDS_PER_SYNC, s);
    for (int r = 0; r < ROUNDS_PER_SYNC; ++r) {
      sweep_kernel<<<warp_blocks(total), THREADS, 0, s>>>((const int*)nbr, (int*)lab, f + 1 + r,
                                                          total, k);
      jump_kernel<<<point_blocks, THREADS, 0, s>>>((int*)lab, total);
      *kernels += 2;
    }
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    err = (int)cudaMemcpyAsync(host, f, sizeof(host), cudaMemcpyDeviceToHost, s);
    if (err != 0) return err;
    err = (int)cudaStreamSynchronize(s);
    if (err != 0) return err;
    ++*host_reads;
    if (host[0]) return ERR_BAD_INDEX;
    *sweeps += ROUNDS_PER_SYNC;
    bool fixpoint = false;
    for (int r = 0; r < ROUNDS_PER_SYNC; ++r) fixpoint |= host[1 + r] == 0;
    if (fixpoint) break;
    if (*sweeps >= max_sweeps) return ERR_NO_FIXPOINT;
  }
  border_kernel<<<warp_blocks(total), THREADS, 0, s>>>(
      (const int*)nbr, (const int*)lab, (const unsigned char*)core, (const unsigned char*)valid,
      (int*)out, total, n, k);
  ++*kernels;
  return (int)cudaGetLastError();
}

const char* dbscan_error_string(int err) {
  if (err == ERR_BAD_INDEX) return "a neighbour index lies outside its frame";
  if (err == ERR_NO_FIXPOINT) return "label propagation reached max_sweeps without a fixpoint";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
