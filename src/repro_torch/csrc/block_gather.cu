// Migration payload copy of the Rainbow serving path: capacity -> hot pool.
//
// Replaces the TPU kernel repro/kernels/block_gather/block_gather.py:31
// `block_gather` (body `_kernel`, :20) and, on the serving path, the jnp copy
// of repro/memory/kvcache.py:406-415 in `end_interval_promote`.
//
//   hot[l, dst[k]] = cap[l, src[k]]   for every layer l and lane k with
//                                     0 <= src[k] < NB and 0 <= dst[k] < HOT
//
// for one or two (cap, hot) pool pairs (K and V) in one launch, in place:
// lanes outside those ranges (src = -1 marks a skip lane) copy nothing, and
// hot rows no lane names keep their contents, as the TPU kernel's
// input/output alias keeps them.  Valid lanes name distinct dst rows (the
// migration plan assigns each slot once); were two to share one, which copy
// lands would be unspecified, as in the reference's scatter.
//
// Bound on the H100: bytes.  Each valid lane reads one block row and writes
// it once (block * KVS * hd elements: 32 KB per layer and pool at the
// serving shapes in bf16).  Design: one CTA per (lane, layer, pool), copying
// the row in the widest unit (16, 8, 4, 2 or 1 bytes) that divides the row
// and every base pointer and stride, chosen by the caller; with 16 bytes
// every thread moves one 128-bit vector per step.  Bits are moved, never
// converted, so the copy is exact in every dtype.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename U>
__global__ void __launch_bounds__(kThreads) block_gather_kernel(
    const char* __restrict__ cap0, char* __restrict__ hot0,
    const char* __restrict__ cap1, char* __restrict__ hot1,
    const int* __restrict__ src, const int* __restrict__ dst, int lanes,
    int nb_cap, int n_hot, long long row_bytes, long long cap_layer_bytes,
    long long hot_layer_bytes) {
  const int k = blockIdx.x;
  if (k >= lanes) return;  // an empty plan still launches one block
  const int s = src[k];
  const int d = dst[k];
  if (s < 0 || s >= nb_cap || d < 0 || d >= n_hot) return;  // skip lane
  const int layer = blockIdx.y;
  const char* cap = blockIdx.z == 0 ? cap0 : cap1;
  char* hot = blockIdx.z == 0 ? hot0 : hot1;
  const U* from = reinterpret_cast<const U*>(cap + layer * cap_layer_bytes + s * row_bytes);
  U* to = reinterpret_cast<U*>(hot + layer * hot_layer_bytes + d * row_bytes);
  const long long n = row_bytes / (long long)sizeof(U);
  for (long long i = threadIdx.x; i < n; i += kThreads) to[i] = from[i];
}

template <typename U>
int launch(const void* cap0, void* hot0, const void* cap1, void* hot1,
           const int* src, const int* dst, int lanes, int layers, int pools,
           int nb_cap, int n_hot, long long row_bytes, cudaStream_t stream) {
  const dim3 grid(lanes > 0 ? lanes : 1, layers, pools);
  block_gather_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<const char*>(cap0), static_cast<char*>(hot0),
      static_cast<const char*>(cap1), static_cast<char*>(hot1), src, dst,
      lanes, nb_cap, n_hot, row_bytes, (long long)nb_cap * row_bytes,
      (long long)n_hot * row_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Pools are contiguous [layers, NB | HOT, row_bytes]; pools = 1 leaves
// cap1/hot1 unused.  `unit` (16, 8, 4, 2 or 1) must divide row_bytes and
// the four base addresses.  Returns cudaGetLastError() after the launch.
int block_gather_launch(const void* cap0, void* hot0, const void* cap1,
                        void* hot1, const int* src, const int* dst, int lanes,
                        int layers, int pools, int nb_cap, int n_hot,
                        long long row_bytes, int unit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pools < 1 || pools > 2 || layers < 1) return (int)cudaErrorInvalidValue;
  switch (unit) {
    case 16:
      return launch<uint4>(cap0, hot0, cap1, hot1, src, dst, lanes, layers,
                           pools, nb_cap, n_hot, row_bytes, s);
    case 8:
      return launch<uint2>(cap0, hot0, cap1, hot1, src, dst, lanes, layers,
                           pools, nb_cap, n_hot, row_bytes, s);
    case 4:
      return launch<uint32_t>(cap0, hot0, cap1, hot1, src, dst, lanes, layers,
                              pools, nb_cap, n_hot, row_bytes, s);
    case 2:
      return launch<uint16_t>(cap0, hot0, cap1, hot1, src, dst, lanes, layers,
                              pools, nb_cap, n_hot, row_bytes, s);
    case 1:
      return launch<uint8_t>(cap0, hot0, cap1, hot1, src, dst, lanes, layers,
                             pools, nb_cap, n_hot, row_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
