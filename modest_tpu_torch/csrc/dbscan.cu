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
// core = valid & (degree + 1 >= min_samples), the initial labels (own
// global index for core points, SENT otherwise) and the edge classes: bit s
// of tie[i] (total, ceil(k / 32)) uint32 is set when the edge i -> j has
// d2 == kth[j], a tie edge. An edge with d2 < kth[j] is two-way: i lies
// strictly inside j's k-th neighbour distance, so when the rows are an
// exact top-k under one symmetric d2 (the kNN of pipeline/clustering.py:
// ties to the lower index, q^2 + c^2 - 2q.c in one order for both
// directions), i is in j's row, and the reverse edge passes the same gate
// (d2 <= r2, d2 <= kth[i] as j is in i's row, the same |dpp|). A tie edge
// may be one-way: i sat on j's k-th distance and lost the tie.
//
// Propagation (dbscan_prop_launch) computes the fixpoint of
// modest_tpu/pipeline/clustering.py::_cluster_from_knn_impl: every core
// point's label is the smallest core index reachable from it over directed
// core-core row edges; a non-core valid point takes the smallest label of a
// core edge neighbour, else -1. Six kernels, no host loop:
//   1. init: a core point's parent is its smallest two-way core neighbour
//      when that is smaller than itself (ECL-CC's initialisation);
//   2. compress: parent[i] = root(i) in that forest. Without these two the
//      seed path's graphs (one large ground component per frame, indices
//      x-sorted) grow deep trees during the union, and its ~10^7 finds walk
//      them;
//   3. union: one warp per core row hooks every two-way core-core edge into
//      the parent table (ECL-CC: atomicCAS hooks the larger root under the
//      smaller, path halving on the way), and appends the core-core tie
//      edges (i, j) to a pair list with one atomicAdd per warp;
//   4. flatten: parent[i] = root(i), the smallest index of i's two-way
//      component, val[i] = parent[i], and each tie pair (i, j) becomes the
//      component pair (root(i), root(j));
//   5. fix-up: one persistent block repeats val[ri] = min(val[ri], val[rj])
//      over the component pairs (ri != rj) until a round changes nothing
//      (__syncthreads_or), then stores the rounds;
//   6. border: core points take val[root(i)], non-core valid points the
//      smallest val[root(j)] over their core edge neighbours.
// Why this is the directed fixpoint: members of a two-way component reach
// each other, so they reach the same set and share one label; the
// components with the tie edges between them form a directed graph whose
// min-reachable fixpoint is what step 3 converges to (labels only fall, and
// each value is a reachable core index), and a two-way edge never crosses
// components. One-way edges are therefore handled exactly, whichever way
// they point.
//
// Bound: bytes. What the function needs: the nbr rows of valid points once
// (core rows to propagate, the others for their border labels), one 4-byte
// label gather per edge, the initial label table and the core and valid
// flags read once, the labels written once (chip_smoke.py's prop_bound).
// The union kernel reads each core row once plus its tie words; the parent
// table (4 * total bytes, 0.8 MB at 4 x 49152 points) stays in L2, as do
// the pair list (~1% of the edges) and val that the fix-up loops over. The
// old sweep loop re-read all rows once per sweep, ~28 times per group.
//
// Edge stage, two kernels over tiles of R rows (R a multiple of 4 with
// R * k near TILE_SLOTS, so a tile starts on a 16-byte boundary for any k):
//   1. kth_kernel: the block reads the tile's d2 as 16-byte vectors with
//      every lane busy into shared memory (non-finite as -1), then a warp
//      per row takes the row's max; it writes kp[i] = (kth[i], pp[i]), one
//      8-byte table, so the edge kernel gathers both with one load. Block 0
//      zeroes the flags.
//   2. edge_kernel: the block reads the tile's idx and d2 as 16-byte vectors,
//      gates each slot (one kp gather for the slots within the radius) and
//      writes nbr as vectors, the slot's edge and tie bits as a byte into
//      shared memory; then a warp per row turns the bytes into the degree
//      (popc of a ballot) and the ceil(k / 32) tie words, and core and the
//      labels follow from the degree. Tiles run in reverse order, so the
//      first tiles it reads are the kth kernel's last, whose d2 is still in
//      L2.
// Bound: bytes. idx and d2 rows, pp and valid read once; nbr rows, tie
// words, core and labels written once (chip_smoke.py's edge_bound_ms). The
// stage reads d2 twice (55 MB at 4 x 49152 points, k = 70, against 50 MB
// of L2) and gathers kp (1.6 MB, in L2) once per slot within the radius.
//
// Union and border kernels run one warp per point: its lanes read the
// point's k slots as one coalesced row.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SENT = 0x3FFFFFFF;     // label of non-core points (above any index)
constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = 32 * WARPS_PER_BLOCK;
constexpr int TILE_SLOTS = 2048;     // edge stage: slots a tile aims at
constexpr int MAX_TILE_ROWS = 256;   // edge stage: rows a tile holds at most (k = 1..8)
constexpr int MAX_K = 3072;          // edge stage: a 4-row tile of d2 fills 48 KB
constexpr int FIXUP_THREADS = 1024;  // the fix-up's one block
constexpr int FIXUP_BATCH = 4;       // pairs a fix-up thread loads at once
constexpr int ERR_BAD_INDEX = -1;    // a neighbour index outside [0, N)
// flags: [bad neighbour index seen, tie pairs appended, fix-up rounds]
constexpr int F_BAD = 0, F_TIES = 1, F_ROUNDS = 2, N_FLAGS = 3;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Rows of an edge-stage tile for k slots per row: TILE_SLOTS / k rounded
// down to a multiple of 4, at least 4, at most MAX_TILE_ROWS.
__host__ __device__ inline int tile_rows(int k) {
  const int r = (TILE_SLOTS / k) & ~3;
  return r < 4 ? 4 : r > MAX_TILE_ROWS ? MAX_TILE_ROWS : r;
}

__device__ __forceinline__ float finite_or(float v, float other) {
  return isfinite(v) ? v : other;
}

// vec: d2 is 16-byte aligned (then every tile is). Dynamic shared memory:
// rows * k floats.
__global__ void __launch_bounds__(THREADS)
kth_kernel(const float* __restrict__ d2, const float* __restrict__ pp,
           const unsigned char* __restrict__ valid, float2* __restrict__ kp,
           int* __restrict__ flags, int total, int k, bool vec) {
  extern __shared__ float4 tile_d2[];
  float* sd = reinterpret_cast<float*>(tile_d2);
  __shared__ float row_pp[MAX_TILE_ROWS];
  __shared__ unsigned char row_valid[MAX_TILE_ROWS];
  const int rows_per_tile = tile_rows(k);
  const int row0 = blockIdx.x * rows_per_tile;
  const int rows = min(rows_per_tile, total - row0);
  const int cnt = rows * k;
  const float* src = d2 + (size_t)row0 * k;
  if (blockIdx.x == 0 && threadIdx.x < N_FLAGS) flags[threadIdx.x] = 0;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {  // in flight with the rows
    row_pp[r] = pp[row0 + r];
    row_valid[r] = valid[row0 + r];
  }
  const int nvec = vec ? cnt >> 2 : 0;
  for (int q = threadIdx.x; q < nvec; q += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    tile_d2[q] = make_float4(finite_or(v.x, -1.0f), finite_or(v.y, -1.0f),
                             finite_or(v.z, -1.0f), finite_or(v.w, -1.0f));
  }
  for (int e = 4 * nvec + threadIdx.x; e < cnt; e += blockDim.x) sd[e] = finite_or(src[e], -1.0f);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    float m = -1.0f;
    for (int s = lane; s < k; s += 32) m = fmaxf(m, sd[r * k + s]);
    m = warp_max(m);
    if (lane == 0) kp[row0 + r] = make_float2(row_valid[r] ? m : -1.0f, row_pp[r]);
  }
}

// Slot gate: the global neighbour index of an edge, else -1; *flag gets 1
// for an edge and 3 for a tie edge (d2 == kth[j]), *bad is set by an
// index outside the frame.
__device__ __forceinline__ int gate(float d, int jl, float pp_i, int off, int n, float r2,
                                    float eps, const float2* __restrict__ kp, unsigned* flag,
                                    bool* bad) {
  if (!(isfinite(d) && d <= r2)) return -1;
  if (jl < 0 || jl >= n) {
    *bad = true;
    return -1;
  }
  const int j = off + jl;
  const float2 q = kp[j];
  if (!(d <= q.x && fabsf(__fsub_rn(pp_i, q.y)) <= eps)) return -1;
  *flag = d < q.x ? 1u : 3u;
  return j;
}

// vec: idx, d2 and nbr are 16-byte aligned. Dynamic shared memory: rows * k
// bytes, rounded up to 4.
__global__ void __launch_bounds__(THREADS)
edge_kernel(const int* __restrict__ idx, const float* __restrict__ d2,
            const float2* __restrict__ kp, const unsigned char* __restrict__ valid,
            int* __restrict__ nbr, unsigned* __restrict__ tie, unsigned char* __restrict__ core,
            int* __restrict__ lab, int* __restrict__ flags, int total, int n, int k, float r2,
            float eps, int min_samples, bool vec) {
  extern __shared__ unsigned tile_flag_words[];
  unsigned char* tile_flag = reinterpret_cast<unsigned char*>(tile_flag_words);
  __shared__ float row_pp[MAX_TILE_ROWS];
  __shared__ int row_off[MAX_TILE_ROWS];
  __shared__ unsigned char row_valid[MAX_TILE_ROWS];
  const int rows_per_tile = tile_rows(k);
  const int row0 = (gridDim.x - 1 - blockIdx.x) * rows_per_tile;  // reverse order, for L2
  const int rows = min(rows_per_tile, total - row0);
  const int cnt = rows * k;
  const size_t g0 = (size_t)row0 * k;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    row_pp[r] = kp[row0 + r].y;
    row_off[r] = (row0 + r) / n * n;
    row_valid[r] = valid[row0 + r];
  }
  __syncthreads();

  bool bad = false;
  const int nvec = vec ? cnt >> 2 : 0;
  for (int q = threadIdx.x; q < nvec; q += blockDim.x) {
    const int4 iv = __ldcs(reinterpret_cast<const int4*>(idx + g0) + q);
    const float4 dv = __ldcs(reinterpret_cast<const float4*>(d2 + g0) + q);
    const int jl[4] = {iv.x, iv.y, iv.z, iv.w};
    const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
    int out[4];
    unsigned bytes = 0;
    int r = 4 * q / k, s = 4 * q - r * k;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      unsigned f = 0;
      out[c] = gate(dd[c], jl[c], row_pp[r], row_off[r], n, r2, eps, kp, &f, &bad);
      bytes |= f << (8 * c);
      if (++s == k) {
        s = 0;
        ++r;
      }
    }
    __stcs(reinterpret_cast<int4*>(nbr + g0) + q, make_int4(out[0], out[1], out[2], out[3]));
    tile_flag_words[q] = bytes;
  }
  for (int e = 4 * nvec + threadIdx.x; e < cnt; e += blockDim.x) {
    const int r = e / k;
    unsigned f = 0;
    nbr[g0 + e] = gate(d2[g0 + e], idx[g0 + e], row_pp[r], row_off[r], n, r2, eps, kp, &f, &bad);
    tile_flag[e] = static_cast<unsigned char>(f);
  }
  if (bad) flags[F_BAD] = 1;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int words = (k + 31) >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    const int i = row0 + r;
    int deg = 0;
    for (int base = 0; base < k; base += 32) {
      const unsigned f = base + lane < k ? tile_flag[r * k + base + lane] : 0u;
      const unsigned edges = __ballot_sync(FULL, f & 1u);
      const unsigned ties = __ballot_sync(FULL, f & 2u);
      deg += __popc(edges);
      if (lane == 0) tie[(size_t)i * words + (base >> 5)] = ties;
    }
    if (lane == 0) {
      const bool c = row_valid[r] && deg + 1 >= min_samples;
      core[i] = c;
      lab[i] = c ? i : SENT;
    }
  }
}

// Root of x in the parent table (parent[x] <= x always), halving the path.
// Loads go through L1 and may be stale: a parent only ever moves up to an
// ancestor, so a stale value is still an ancestor, and hook()'s atomicCAS
// sees the true value. Cached loads keep the many finds that end at one
// large component's root off a single L2 line.
__device__ __forceinline__ int find_root(int* parent, int x) {
  int cur = __ldca(parent + x);
  if (cur != x) {
    int next, prev = x;
    while (cur > (next = __ldca(parent + cur))) {
      parent[prev] = next;  // an ancestor of prev: other threads may race, any ancestor is right
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// ECL-CC's hook: the larger root goes under the smaller one. After the
// compress pass most points hang right under their root, so one load of
// each parent settles most edges: a common parent means one tree.
__device__ __forceinline__ void hook(int* parent, int a, int b) {
  int ra = __ldca(parent + a), rb = __ldca(parent + b);
  if (ra == rb) return;
  ra = find_root(parent, ra);
  rb = find_root(parent, rb);
  while (ra != rb) {
    if (ra < rb) {
      const int old = atomicCAS(parent + rb, rb, ra);
      if (old == rb) break;
      rb = old;  // rb was hooked meanwhile: climb from its new parent
    } else {
      const int old = atomicCAS(parent + ra, ra, rb);
      if (old == ra) break;
      ra = old;
    }
  }
}

// ECL-CC's initialisation: each core point's parent is its smallest
// two-way core neighbour, if smaller than itself.
__global__ void init_kernel(const int* __restrict__ nbr, const unsigned* __restrict__ tie,
                            const unsigned char* __restrict__ core, int* __restrict__ parent,
                            int total, int k) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= total || !core[i]) return;  // uniform per warp
  const int words = (k + 31) >> 5;
  int m = i;
  for (int base = 0; base < k; base += 32) {
    const int s = base + lane;
    if (s < k) {
      const int j = nbr[(size_t)i * k + s];
      if (j >= 0 && j < m && core[j] && !((tie[(size_t)i * words + (base >> 5)] >> lane) & 1u))
        m = j;
    }
  }
  m = warp_min(m);
  if (lane == 0) parent[i] = m;
}

// parent[i] = root(i) over the forest built so far.
__global__ void compress_kernel(int* parent, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total && parent[i] < SENT) parent[i] = find_root(parent, i);
}

__global__ void union_kernel(const int* __restrict__ nbr, const unsigned* __restrict__ tie,
                             const unsigned char* __restrict__ core, int* parent,
                             int2* __restrict__ pairs, int* __restrict__ flags, int total, int k) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= total || !core[i]) return;  // uniform per warp
  const int words = (k + 31) >> 5;
  for (int base = 0; base < k; base += 32) {
    const int s = base + lane;
    int j = -1;
    bool tie_pair = false;
    if (s < k) {
      j = nbr[(size_t)i * k + s];
      if (j >= 0 && core[j]) {
        if ((tie[(size_t)i * words + (base >> 5)] >> lane) & 1u) {
          tie_pair = true;
        } else {
          hook(parent, i, j);
        }
      }
    }
    const unsigned m = __ballot_sync(FULL, tie_pair);
    if (m) {
      int first = 0;
      if (lane == 0) first = atomicAdd(flags + F_TIES, __popc(m));
      first = __shfl_sync(FULL, first, 0);
      if (tie_pair) pairs[first + __popc(m & ((1u << lane) - 1u))] = make_int2(i, j);
    }
  }
}

// parent[i] = root(i) and val[i] = parent[i]; the tie pairs become
// component pairs (roots are final here: only paths are written).
__global__ void flatten_kernel(int* parent, int* __restrict__ val, int2* __restrict__ pairs,
                               const int* __restrict__ flags, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int count = flags[F_TIES];
  for (int p = i; p < count; p += stride) {
    const int2 e = pairs[p];
    pairs[p] = make_int2(find_root(parent, e.x), find_root(parent, e.y));
  }
  if (i >= total) return;
  int r = parent[i];
  if (r < SENT) {
    r = find_root(parent, i);
    parent[i] = r;
  }
  val[i] = r;
}

// Directed fix-up over the component pairs, one block, FIXUP_BATCH pairs
// in flight per thread. Pairs inside one component are skipped.
__global__ void __launch_bounds__(FIXUP_THREADS)
fixup_kernel(const int2* __restrict__ pairs, int* val, int* flags) {
  const int count = flags[F_TIES];
  volatile int* vv = val;
  int rounds = 0;
  for (;;) {
    int changed = 0;
    for (int p0 = threadIdx.x; p0 < count; p0 += FIXUP_THREADS * FIXUP_BATCH) {
      int2 c[FIXUP_BATCH];
#pragma unroll
      for (int t = 0; t < FIXUP_BATCH; ++t) {
        const int p = p0 + t * FIXUP_THREADS;
        c[t] = p < count ? pairs[p] : make_int2(0, 0);
      }
#pragma unroll
      for (int t = 0; t < FIXUP_BATCH; ++t) {
        if (c[t].x == c[t].y) continue;
        const int vj = vv[c[t].y];
        if (vj < vv[c[t].x]) {
          atomicMin(val + c[t].x, vj);
          changed = 1;
        }
      }
    }
    ++rounds;
    if (!__syncthreads_or(changed)) break;
  }
  if (threadIdx.x == 0) flags[F_ROUNDS] = rounds;
}

__global__ void border_kernel(const int* __restrict__ nbr, const int* __restrict__ comp,
                              const int* __restrict__ val, const unsigned char* __restrict__ core,
                              const unsigned char* __restrict__ valid, int* __restrict__ out,
                              int total, int n, int k) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= total) return;
  int m = SENT;
  if (core[i]) {
    m = val[comp[i]];
  } else if (valid[i]) {
    for (int s = lane; s < k; s += 32) {
      const int j = nbr[(size_t)i * k + s];
      if (j >= 0) {
        const int c = comp[j];  // SENT exactly when j is not core
        if (c < SENT) m = min(m, val[c]);
      }
    }
    m = warp_min(m);
  }
  if (lane == 0) out[i] = m < SENT ? m - (i / n) * n : -1;
}

inline int warp_blocks(int total) { return (total + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK; }

}  // namespace

extern "C" {

int dbscan_sentinel() { return SENT; }
int dbscan_flag_count() { return N_FLAGS; }

int dbscan_max_k() { return MAX_K; }

// flags: N_FLAGS int32 of scratch shared with dbscan_prop_launch
// (flags[0] = a bad neighbour index was seen), zeroed here. kp: total
// float2 of scratch. tie: (total, ceil(k / 32)) uint32. *kernels gets the
// kernels launched (2).
int dbscan_edge_launch(const void* idx, const void* d2, const void* pp, const void* valid,
                       void* kp, void* nbr, void* tie, void* core, void* lab, void* flags,
                       int total, int n, int k, float r2, float eps, int min_samples,
                       void* stream, int* kernels) {
  cudaStream_t s = (cudaStream_t)stream;
  *kernels = 0;
  if (total <= 0) return 0;
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const int rows = tile_rows(k);
  const int tiles = (total + rows - 1) / rows;
  auto aligned = [](const void* p) { return ((size_t)p & 15) == 0; };
  kth_kernel<<<tiles, THREADS, sizeof(float) * rows * k, s>>>(
      (const float*)d2, (const float*)pp, (const unsigned char*)valid, (float2*)kp, (int*)flags,
      total, k, aligned(d2));
  edge_kernel<<<tiles, THREADS, (rows * k + 3) & ~3, s>>>(
      (const int*)idx, (const float*)d2, (const float2*)kp, (const unsigned char*)valid,
      (int*)nbr, (unsigned*)tie, (unsigned char*)core, (int*)lab, (int*)flags, total, n, k, r2,
      eps, min_samples, aligned(idx) && aligned(d2) && aligned(nbr));
  *kernels = 2;
  return (int)cudaGetLastError();
}

// Init, compress, union, flatten, fix-up and border kernels, then one host
// read of the flags. parent: the edge stage's labels, relabelled in place; val: total
// int32 of scratch; pairs: room for every slot, (total * k) int2; out:
// (total,) int32 frame-local labels (-1 noise). *kernels gets the kernels
// launched (6), *rounds the fix-up's rounds, *ties the core-core tie edges,
// *host_reads the host reads (1).
int dbscan_prop_launch(const void* nbr, const void* tie, const void* core, const void* valid,
                       void* parent, void* val, void* pairs, void* out, void* flags, int total,
                       int n, int k, int* rounds, int* ties, int* kernels, int* host_reads,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  *rounds = *ties = *kernels = *host_reads = 0;
  if (total <= 0) return 0;
  int* f = (int*)flags;
  cudaMemsetAsync(f + F_TIES, 0, sizeof(int) * (N_FLAGS - F_TIES), s);
  init_kernel<<<warp_blocks(total), THREADS, 0, s>>>(
      (const int*)nbr, (const unsigned*)tie, (const unsigned char*)core, (int*)parent, total, k);
  compress_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0, s>>>((int*)parent, total);
  union_kernel<<<warp_blocks(total), THREADS, 0, s>>>(
      (const int*)nbr, (const unsigned*)tie, (const unsigned char*)core, (int*)parent,
      (int2*)pairs, f, total, k);
  flatten_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (int*)parent, (int*)val, (int2*)pairs, f, total);
  fixup_kernel<<<1, FIXUP_THREADS, 0, s>>>((const int2*)pairs, (int*)val, f);
  border_kernel<<<warp_blocks(total), THREADS, 0, s>>>(
      (const int*)nbr, (const int*)parent, (const int*)val, (const unsigned char*)core,
      (const unsigned char*)valid, (int*)out, total, n, k);
  *kernels = 6;
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  int host[N_FLAGS];
  err = (int)cudaMemcpyAsync(host, f, sizeof(host), cudaMemcpyDeviceToHost, s);
  if (err != 0) return err;
  err = (int)cudaStreamSynchronize(s);
  if (err != 0) return err;
  *host_reads = 1;
  if (host[F_BAD]) return ERR_BAD_INDEX;
  *rounds = host[F_ROUNDS];
  *ties = host[F_TIES];
  return 0;
}

const char* dbscan_error_string(int err) {
  if (err == ERR_BAD_INDEX) return "a neighbour index lies outside its frame";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
