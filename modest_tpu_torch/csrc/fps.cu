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
// by the latency of one reduction over the cloud per step, not by bandwidth
// (the inputs are read from device memory once) nor by the ~10 flops per
// point and step.
//
// What the design does about it: one launch runs every step.
//   * Large clouds (N >= 1024, the backbone): fps_cluster_kernel, one thread
//     block cluster of C CTAs per cloud (C from table_cluster_size(), by
//     measurement). Each CTA owns a contiguous range of ceil(N / C) points,
//     and each thread keeps x, y, z and the running distance of its P <= 8
//     points in registers, so a step touches no memory per point. Clouds
//     past 32768 points (PV-RCNN's keypoints: 65536) take P = 16 in the same
//     8 CTAs of at most 512 threads: the table of 128 winner slots and the
//     per-step exchange stay as they are, and the scan a thread runs per
//     step doubles; its 64 point registers fit the 128 that one 512-thread
//     CTA per SM leaves a thread. (1024-thread CTAs at P = 8 would double
//     the 128 slots that every warp scans per step and cap a thread at 64
//     registers.) Clouds past 65536 points (Waymo's PV-RCNN: 131072) take
//     P = 32 in the same 8 CTAs: 32 points' x, y, z would spill past those
//     128 registers, so the CTA's points sit in dynamic shared memory
//     (three float arrays, up to 16384 points = 196,608 bytes, read
//     conflict-free since thread i reads word i + k * threads) and only the
//     32 running distances stay in registers. A step is
//     a branch-free register scan, a warp argmax by redux.sync (max of the
//     distance's bits, then min of the indices that hold it), each warp's
//     winner (distance, index, x, y, z) stored into its slot of every CTA's
//     table in distributed shared memory (st.async, each store counted on
//     the target CTA's mbarrier), a wait on the CTA's own mbarrier, and an
//     argmax over the table's C * warps slots in every warp, which also
//     hands every thread the winner's coordinates for the next step. No
//     block or cluster barrier runs per step.
//   * Small clouds (N < 1024, the RoI tower's 512- and 128-point sub-clouds
//     and SA4's 256): fps_warp_kernel<P>, one block of one warp per cloud,
//     so that the RoI tower's 400 clouds spread over every SM. Each lane
//     keeps x, y, z and the running distance of its P = ceil(N / 32) points
//     in registers (P a power of two up to 32), so the scan touches no
//     memory per point; a copy of the cloud as float4 in shared memory
//     serves only the one broadcast load of the winner's coordinates per
//     step. The argmax is two redux.sync (warp_argmax), with no barrier.
//     Splitting a cloud over 2 or 4 warps (a table of winners and a block
//     barrier per step) was slower at all three path shapes (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kLargeCloud = 1024;     // N at and above which a cloud gets a cluster
constexpr int kTargetThreads = 128;   // cluster kernel: threads per CTA it aims at
constexpr int kMaxThreads = 512;      // per CTA: at most 4096 points with P = 8
constexpr int kMaxPerThread = 8;      // P: points a thread keeps in registers (clusters)
constexpr int kWidePerThread = 16;    // P past kMaxThreads * kMaxPerThread points a CTA
constexpr int kSharedPerThread = 32;  // P past kMaxThreads * kWidePerThread: points in smem
constexpr int kSmallMaxPerThread = 32;  // P of the small-cloud kernel: N < 1024
constexpr int kMaxCluster = 8;        // the largest portable cluster size
constexpr int kMaxSlots = kMaxCluster * kMaxThreads / 32;  // one per warp of a cluster

__device__ __forceinline__ float dist2(float x, float y, float z,
                                       float lx, float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// A candidate: the distance's bits as an int (d >= 0, so the float order is
// the int order; a masked point holds d = -1, whose bits are negative), its
// point index and coordinates. 32 bytes, moved as two 16-byte words. The
// empty candidate (INT_MIN, INT_MAX) loses to every point.
struct __align__(16) Candidate {
  int key;
  int idx;
  float x, y, z;
  float pad[3];
};

__device__ __forceinline__ uint4 word0(int key, int idx, float x, float y) {
  return make_uint4(static_cast<unsigned>(key), static_cast<unsigned>(idx), __float_as_uint(x),
                    __float_as_uint(y));
}

__device__ __forceinline__ uint4 word1(float z) {
  return make_uint4(__float_as_uint(z), 0u, 0u, 0u);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// This CTA's shared-memory address `addr` in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store 16 bytes into another CTA's shared memory; the store completes 16
// bytes of the transaction count of that CTA's mbarrier `bar`.
__device__ __forceinline__ void store_async(unsigned addr, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbarrier_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` more of transactions in this phase.
__device__ __forceinline__ void mbarrier_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed; what the
// cluster stored before completing it is then visible.
__device__ __forceinline__ void mbarrier_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Warp argmax without a butterfly: the max of the keys, then the min of the
// indices of the lanes that hold it. Every lane gets the winner's (key, idx).
__device__ __forceinline__ void warp_argmax(int& key, int& idx) {
  const int kmax = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == kmax ? idx : INT_MAX);
  key = kmax;
}

// warp_argmax that also returns the lowest lane holding the winner.
__device__ __forceinline__ int warp_argmax_redux(int& key, int& idx) {
  const int own_key = key, own_idx = idx;
  warp_argmax(key, idx);
  return __ffs(__ballot_sync(0xffffffffu, own_key == key && own_idx == idx)) - 1;
}

// ---- small clouds -------------------------------------------------------

// Grid: one warp per cloud; lane t keeps the points t + 32k, k < P. A point
// past N is masked with distance -1, as in the cluster kernel.
template <int P>
__global__ void __launch_bounds__(32)
fps_warp_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n, int npoint) {
  __shared__ float4 cloud[32 * P];
  const int t = threadIdx.x;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * npoint;

  float px[P], py[P], pz[P], pd[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = t + 32 * k;
    const bool mine = j < n;
    const int jj = mine ? j : 0;
    px[k] = p[3 * jj];
    py[k] = p[3 * jj + 1];
    pz[k] = p[3 * jj + 2];
    pd[k] = mine ? 1e10f : -1.0f;
    if (mine) cloud[j] = make_float4(px[k], py[k], pz[k], 0.0f);
  }
  if (t == 0) o[0] = 0;
  __syncwarp();

  float4 last = cloud[0];
  for (int s = 1; s < npoint; ++s) {
    int key = INT_MIN, best = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float d = fminf(pd[k], dist2(px[k], py[k], pz[k], last.x, last.y, last.z));
      pd[k] = d;
      const int kd = __float_as_int(d);
      if (kd > key) {  // indices rise with k: strict > keeps the lowest among equals
        key = kd;
        best = k;
      }
    }
    int idx = key >= 0 ? t + 32 * best : INT_MAX;  // a masked point never wins
    warp_argmax(key, idx);
    if (t == 0) o[s] = idx;
    last = cloud[idx];
  }
}

// ---- large clouds -------------------------------------------------------

// Grid: batch * C CTAs of `threads` threads in clusters of C along x; CTA
// rank r of cloud b owns points [r * chunk, min(N, (r + 1) * chunk)), and
// thread i of it the points r * chunk + i + k * threads, k < P.
//
// The exchange of step s: every warp of every CTA stores its winner into
// slot rank * warps + warp of buffer s & 1 of every CTA's table (st.async
// into distributed shared memory, lane r to CTA r), and each store completes
// bytes on the target CTA's mbarrier of that buffer, which thread 0 of the
// target armed for all C * warps slots. A CTA waits on its own mbarrier
// only: no block or cluster barrier runs per step. Reuse is safe by
// causality: a warp stores into buffer s & 1 again at step s + 2, which
// needs the winner of step s + 1, which needs every warp's candidate of step
// s + 1, which a warp sends only after it has read step s's table.
// (One CTA per SM is enough: the 1 lets a thread take up to 128 registers,
// which P = 8 needs to hold its points without spilling.) With kShared the
// points' x, y, z live in dynamic shared memory, 3 * threads * P floats:
// thread i's point k at word i + k * threads of each array.
template <int P, bool kShared>
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n, int npoint,
                   int chunk) {
  __shared__ Candidate table[2][kMaxSlots];
  __shared__ unsigned long long full[2];
  extern __shared__ float cta_points[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / csize;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int slots = csize * nwarps;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  int* o = out + static_cast<size_t>(b) * npoint;

  const int first = rank * chunk + threadIdx.x;  // this thread's point k is first + k * stride
  const int stride = blockDim.x;
  const int end = min(n, (rank + 1) * chunk);
  // Points past the range are masked: distance -1 (fminf keeps it there), so
  // they never win, and the scan below needs no branch.
  constexpr int R = kShared ? 1 : P;  // coordinates a thread keeps in registers
  float px[R], py[R], pz[R], pd[P];
  float* sx = cta_points;
  float* sy = cta_points + stride * P;
  float* sz = cta_points + 2 * stride * P;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const bool mine = first + k * stride < end;
    const int j = mine ? first + k * stride : 0;
    if constexpr (kShared) {
      const int l = threadIdx.x + k * stride;  // only this thread reads word l
      sx[l] = p[3 * j];
      sy[l] = p[3 * j + 1];
      sz[l] = p[3 * j + 2];
    } else {
      px[k] = p[3 * j];
      py[k] = p[3 * j + 1];
      pz[k] = p[3 * j + 2];
    }
    pd[k] = mine ? 1e10f : -1.0f;
  }
  float lx = p[0], ly = p[1], lz = p[2];
  if (rank == 0 && threadIdx.x == 0) o[0] = 0;
  if (threadIdx.x == 0) {
    mbarrier_init(&full[0], 1);
    mbarrier_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every CTA of the cluster runs, with its mbarriers set up, before another
  // stores into its shared memory.
  cluster.sync();

  const unsigned table_bytes = slots * sizeof(Candidate);
  const int my_slot = rank * nwarps + warp;
  for (int s = 1; s < npoint; ++s) {
    const int buf = s & 1;
    // buffer buf's phases: steps 1, 3, 5, ... and 2, 4, 6, ...
    const unsigned parity = ((s - 1) >> 1) & 1;
    if (threadIdx.x == 0) mbarrier_expect(&full[buf], table_bytes);

    int key = INT_MIN, best = 0;
    float bx = 0.0f, by = 0.0f, bz = 0.0f;
    if constexpr (kShared) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int l = threadIdx.x + k * stride;
        const float d = fminf(pd[k], dist2(sx[l], sy[l], sz[l], lx, ly, lz));
        pd[k] = d;
        const int kd = __float_as_int(d);
        if (kd > key) {  // indices rise with k: strict > keeps the lowest among equals
          key = kd;
          best = k;
        }
      }
      const int l = threadIdx.x + best * stride;
      bx = sx[l];
      by = sy[l];
      bz = sz[l];
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float d = fminf(pd[k], dist2(px[k], py[k], pz[k], lx, ly, lz));
        pd[k] = d;
        const int kd = __float_as_int(d);
        if (kd > key) {  // indices rise with k: strict > keeps the lowest among equals
          key = kd;
          best = k;
          bx = px[k];
          by = py[k];
          bz = pz[k];
        }
      }
    }
    int idx = key >= 0 ? first + best * stride : INT_MAX;  // a masked point never wins
    const int wl = warp_argmax_redux(key, idx);
    bx = __shfl_sync(0xffffffffu, bx, wl);
    by = __shfl_sync(0xffffffffu, by, wl);
    bz = __shfl_sync(0xffffffffu, bz, wl);
    if (lane < csize) {  // lane r sends this warp's winner to CTA r
      const unsigned slot = cluster_addr(smem_addr(&table[buf][my_slot]), lane);
      const unsigned bar = cluster_addr(smem_addr(&full[buf]), lane);
      store_async(slot, word0(key, idx, bx, by), bar);
      store_async(slot + 16, word1(bz), bar);
    }
    mbarrier_wait(&full[buf], parity);  // every warp's slot has landed

    key = INT_MIN;
    idx = INT_MAX;
    for (int j = lane; j < slots; j += 32) {
      const Candidate c = table[buf][j];
      if (c.key > key || (c.key == key && c.idx < idx)) {
        key = c.key;
        idx = c.idx;
        lx = c.x;
        ly = c.y;
        lz = c.z;
      }
    }
    const int gl = warp_argmax_redux(key, idx);
    lx = __shfl_sync(0xffffffffu, lx, gl);
    ly = __shfl_sync(0xffffffffu, ly, gl);
    lz = __shfl_sync(0xffffffffu, lz, gl);
    if (rank == 0 && threadIdx.x == 0) o[s] = idx;
  }
  // Every store into this CTA's shared memory landed before its last wait;
  // the barrier keeps each CTA's shared memory alive until all have finished.
  cluster.sync();
}

// The table of cluster sizes per N, by measurement: a sweep of C = 1 to 16
// at the backbone's 12288, 4096 and 1024 points on an H100 (PERF.md). At
// 4096 points C = 8 is as fast as 4 on the median but spreads by 12% across
// runs; C = 4 by 6%. C = 16 (a non-portable size) was slower at every N.
int table_cluster_size(int n) {
  if (n >= 8192) return 8;
  if (n >= 2048) return 4;
  return 2;
}

// Points per thread and threads per CTA for a range of `chunk` points: the
// fewest points per thread (1, 2, 4, 8) that keep a CTA at or under
// kTargetThreads, else 8 points and more threads, up to kMaxThreads (every
// N <= 32768), else 16 points (N <= 65536 at the table's 8 CTAs), else 32
// points in shared memory (N <= 131072).
void cta_shape(int chunk, int* per_thread, int* threads) {
  for (int p = 1; p <= kMaxPerThread; p *= 2) {
    *per_thread = p;
    *threads = ((chunk + p - 1) / p + 31) / 32 * 32;
    if (*threads <= kTargetThreads) return;
  }
  for (int p = kWidePerThread; p <= kSharedPerThread && *threads > kMaxThreads; p *= 2) {
    *per_thread = p;
    *threads = ((chunk + p - 1) / p + 31) / 32 * 32;
  }
}

template <int P, bool kShared = false>
cudaError_t launch_cluster(const float* xyz, int* out, int batch, int n, int npoint, int csize,
                           int threads, int chunk, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * csize);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = kShared ? 3 * threads * P * sizeof(float) : 0;
  if (kShared) {
    const cudaError_t e = cudaFuncSetAttribute(fps_cluster_kernel<P, kShared>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(cfg.dynamicSmemBytes));
    if (e != cudaSuccess) return e;
  }
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fps_cluster_kernel<P, kShared>, xyz, out, n, npoint,
                            chunk);
}

}  // namespace

extern "C" {

// Largest N one launch takes: the table's cluster of 8 CTAs of 512 threads
// with 32 points each.
int fps_max_points() { return kMaxCluster * kMaxThreads * kSharedPerThread; }

// The cluster size fps_launch takes for N; 0 below kLargeCloud (the warp
// kernel).
int fps_cluster_size(int n) {
  return n < kLargeCloud ? 0 : table_cluster_size(n);
}

// The points a thread keeps (P) in the launch fps_launch makes for N: the
// cluster kernel's cta_shape, or the warp kernel's ceil(N / 32) rounded up
// to a power of two.
int fps_per_thread(int n) {
  int per_thread = 1, threads = 0;
  if (n >= kLargeCloud) {
    const int csize = table_cluster_size(n);
    cta_shape((n + csize - 1) / csize, &per_thread, &threads);
  } else {
    while (per_thread < (n + 31) / 32) per_thread *= 2;
  }
  return per_thread;
}

// xyz: (batch, n, 3) float32, contiguous, on the device; out: (batch, npoint)
// int32. Launches on `stream` and returns a CUDA error code (0 on success);
// *kernel (host memory) gets the name of the kernel it launched.
int fps_launch(const float* xyz, int* out, int batch, int n, int npoint, const char** kernel,
               void* stream) {
  if (batch <= 0 || n <= 0 || npoint <= 0 || n > fps_max_points()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (n >= kLargeCloud) {
    *kernel = "fps_cluster_kernel";
    const int csize = table_cluster_size(n);
    const int chunk = (n + csize - 1) / csize;
    int per_thread = 0, threads = 0;
    cta_shape(chunk, &per_thread, &threads);
    switch (per_thread) {
      case 1: e = launch_cluster<1>(xyz, out, batch, n, npoint, csize, threads, chunk, st); break;
      case 2: e = launch_cluster<2>(xyz, out, batch, n, npoint, csize, threads, chunk, st); break;
      case 4: e = launch_cluster<4>(xyz, out, batch, n, npoint, csize, threads, chunk, st); break;
      case 8: e = launch_cluster<8>(xyz, out, batch, n, npoint, csize, threads, chunk, st); break;
      case kWidePerThread:
        e = launch_cluster<kWidePerThread>(xyz, out, batch, n, npoint, csize, threads, chunk,
                                           st);
        break;
      default:
        e = launch_cluster<kSharedPerThread, true>(xyz, out, batch, n, npoint, csize, threads,
                                                   chunk, st);
    }
  } else {
    *kernel = "fps_warp_kernel";
    // P: the points a lane keeps, ceil(N / 32) rounded up to a power of two
    const int per = (n + 31) / 32;
    if (per <= 1) fps_warp_kernel<1><<<batch, 32, 0, st>>>(xyz, out, n, npoint);
    else if (per <= 2) fps_warp_kernel<2><<<batch, 32, 0, st>>>(xyz, out, n, npoint);
    else if (per <= 4) fps_warp_kernel<4><<<batch, 32, 0, st>>>(xyz, out, n, npoint);
    else if (per <= 8) fps_warp_kernel<8><<<batch, 32, 0, st>>>(xyz, out, n, npoint);
    else if (per <= 16) fps_warp_kernel<16><<<batch, 32, 0, st>>>(xyz, out, n, npoint);
    else fps_warp_kernel<kSmallMaxPerThread><<<batch, 32, 0, st>>>(xyz, out, n, npoint);
    e = cudaSuccess;
  }
  // cudaGetLastError also clears the error a refused call left behind, so a
  // refused launch does not fail the next one.
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

const char* fps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
