// Label-table gathers, for NVIDIA Hopper (sm_90a).
//
// Replace the Pallas TPU probe kernels of scripts_dev/gather_probe.py:
//   take_launch              <- pallas_take -> _probe_kernel:  out[i] = table[idx[i]],
//                               table (n,) int32, idx / out (total,) int32;
//   take_along_axis_launch   <- pallas_taa -> _probe_kernel2: out[r, j] = tab[r, idx[r, j]],
//                               tab (rows, w) int32, idx / out (rows, m) int32.
// The TPU probes asked whether Mosaic could gather inside VMEM at all (the
// TPU has no general gather unit); Hopper loads any address from global
// memory, so each kernel is one thread per output element: coalesced reads
// of idx, coalesced writes of out, and table reads through the read-only
// path, which hit L2 (the probe's tables are 512 KB and 16 KB a row).
//
// Bound: bytes. Each call must read idx, write out and read the table once:
// at the probe's full take, 131,072 x 70 indices, ~73.9 MB, ~22 us at
// 3.35 TB/s.
//
// An index outside its table sets errors[0] = 1 and writes 0; the wrapper
// raises at its first host read of the flag. Nothing is clamped.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
take_kernel(const int* __restrict__ table, int n, const int* __restrict__ idx,
            int* __restrict__ out, long long total, int* __restrict__ errors) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int j = idx[i];
  if (j < 0 || j >= n) {
    errors[0] = 1;
    out[i] = 0;
    return;
  }
  out[i] = __ldg(table + j);
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
  take_kernel<<<blocks(total), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)table, n, (const int*)idx, (int*)out, total, (int*)errors);
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
