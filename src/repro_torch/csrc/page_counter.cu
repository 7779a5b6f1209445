// Fused observe counter: one pass over an interval's accesses producing the
// three histograms of Rainbow's two-stage counting (paper §III-B).
//
// Replaces the TPU kernel repro/kernels/page_counter/page_counter.py:209
// `fused_observe_count` (body `_fused_kernel`, :143), which builds the
// histograms as one-hot matmuls because the TPU has no atomic scatter.
//
//   s1[sp]           += write ? write_weight : 1       (sp >= 0)
//   s2r[row(sp), pg] += !write                         (sp monitored)
//   s2w[row(sp), pg] += write
//
// row(sp) is the FIRST monitored row holding sp, as in the reference oracle
// (ref.py argmax); rows of -1 match nothing.  Superpage ids and monitored ids
// lie below num_superpages.
//
// Bound on the H100: bytes.  The pass reads 9 bytes per access and writes
// the histograms once (about 2.7 MB at the main path's 260k accesses, under
// a microsecond at 3.35 TB/s), so launch latency and atomic contention on
// the hottest superpages set its time.  Design: grid-stride blocks; each
// block privatizes the stage-1 histogram and an sp -> row lookup table in
// shared memory (8 bytes per superpage) and flushes its nonzero stage-1 bins
// with one atomicAdd each; the two [N, P] stage-2 tables (400 KB at
// N=100, P=512, more than a block's shared memory) take global atomicAdds.
//
// Counts are int32 and integer adds commute, so the result is bitwise the
// same whatever order the atomics land in.  The TPU kernel accumulates in
// f32, which is exact only below 2^24; the integers here are exact
// everywhere.
//
// A second entry point, `two_stage_count`, replaces the unfused TPU kernel
// page_counter.py:78 `two_stage_count` (body `_kernel`, :24): one stage-1
// histogram and one stage-2 table, both weighted by a caller-given uint32
// weight per access (the TPU kernel widens it to f32).  It shares the
// shared-memory stage-1 histogram and sp -> row table above; the weights
// are summed as unsigned integers, wrapping modulo 2^32 as the reference's
// uint32 scatter-add does, so its output is bitwise too.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;

// Zero the block-private stage-1 histogram and fill the sp -> first
// monitored row table (INT_MAX: not monitored).
__device__ void init_tables(int* s1_sh, int* row_of, const int* monitored,
                            int n_mon, int nsp) {
  for (int i = threadIdx.x; i < nsp; i += blockDim.x) {
    s1_sh[i] = 0;
    row_of[i] = INT_MAX;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_mon; r += blockDim.x) {
    const int m = monitored[r];
    if (m >= 0 && m < nsp) atomicMin(&row_of[m], r);
  }
  __syncthreads();
}

// Add the block's nonzero stage-1 bins into the global histogram.
__device__ void flush_stage1(int* s1, const int* s1_sh, int nsp) {
  __syncthreads();
  for (int i = threadIdx.x; i < nsp; i += blockDim.x) {
    const int v = s1_sh[i];
    if (v != 0) atomicAdd(&s1[i], v);
  }
}

__global__ void fused_observe_count_kernel(
    const int* __restrict__ sp, const int* __restrict__ page,
    const unsigned char* __restrict__ is_write, int a,
    const int* __restrict__ monitored, int n_mon, int nsp, int pages,
    int write_weight, int* __restrict__ s1, int* __restrict__ s2r,
    int* __restrict__ s2w) {
  extern __shared__ int smem[];
  int* s1_sh = smem;         // [nsp] block-private stage-1 histogram
  int* row_of = smem + nsp;  // [nsp] first monitored row of each superpage
  init_tables(s1_sh, row_of, monitored, n_mon, nsp);

  const long long cells = (long long)n_mon * pages;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a; i += stride) {
    const int s = sp[i];
    if (s < 0 || s >= nsp) continue;
    const bool wr = is_write[i] != 0;
    atomicAdd(&s1_sh[s], wr ? write_weight : 1);
    const int row = row_of[s];
    if (row == INT_MAX) continue;
    const long long idx = (long long)row * pages + page[i];
    if (idx < 0 || idx >= cells) continue;
    atomicAdd(wr ? &s2w[idx] : &s2r[idx], 1);
  }
  flush_stage1(s1, s1_sh, nsp);
}

__global__ void two_stage_count_kernel(
    const int* __restrict__ sp, const int* __restrict__ page,
    const unsigned* __restrict__ weight, int a,
    const int* __restrict__ monitored, int n_mon, int nsp, int pages,
    int* __restrict__ s1, unsigned* __restrict__ s2) {
  extern __shared__ int smem[];
  int* s1_sh = smem;
  int* row_of = smem + nsp;
  init_tables(s1_sh, row_of, monitored, n_mon, nsp);

  const long long cells = (long long)n_mon * pages;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a; i += stride) {
    const int s = sp[i];
    if (s < 0 || s >= nsp) continue;
    const unsigned w = weight[i];
    atomicAdd(reinterpret_cast<unsigned*>(&s1_sh[s]), w);
    const int row = row_of[s];
    if (row == INT_MAX) continue;
    const long long idx = (long long)row * pages + page[i];
    if (idx < 0 || idx >= cells) continue;
    atomicAdd(&s2[idx], w);
  }
  flush_stage1(s1, s1_sh, nsp);
}

// Shared memory one block needs for `nsp` superpages.
int smem_bytes(int nsp) { return 2 * nsp * (int)sizeof(int); }

int grid_size(int a, int max_blocks) {
  long long want = ((long long)a + kThreads - 1) / kThreads;
  int blocks = (int)(want < max_blocks ? want : max_blocks);
  return blocks < 1 ? 1 : blocks;  // a zero-access batch still launches one block
}

template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory one block needs for `nsp` superpages.
int fused_observe_count_smem_bytes(int nsp) { return smem_bytes(nsp); }

// Outputs must be zero-filled by the caller.  Returns cudaGetLastError().
int fused_observe_count_launch(const int* sp, const int* page,
                               const unsigned char* is_write, int a,
                               const int* monitored, int n_mon, int nsp,
                               int pages, int write_weight, int* s1, int* s2r,
                               int* s2w, int max_blocks, void* stream) {
  const int smem = smem_bytes(nsp);
  const int e = allow_smem(fused_observe_count_kernel, smem);
  if (e != 0) return e;
  fused_observe_count_kernel<<<grid_size(a, max_blocks), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      sp, page, is_write, a, monitored, n_mon, nsp, pages, write_weight, s1,
      s2r, s2w);
  return (int)cudaGetLastError();
}

// s1 [nsp] and s2 [n_mon, pages] (uint32 counts) must be zero-filled by the
// caller.  Returns cudaGetLastError().
int two_stage_count_launch(const int* sp, const int* page, const unsigned* weight,
                           int a, const int* monitored, int n_mon, int nsp,
                           int pages, int* s1, unsigned* s2, int max_blocks,
                           void* stream) {
  const int smem = smem_bytes(nsp);
  const int e = allow_smem(two_stage_count_kernel, smem);
  if (e != 0) return e;
  two_stage_count_kernel<<<grid_size(a, max_blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      sp, page, weight, a, monitored, n_mon, nsp, pages, s1, s2);
  return (int)cudaGetLastError();
}

}  // extern "C"
