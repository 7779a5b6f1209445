// Causal (or full) flash attention over a whole sequence: the forward of the
// training path's self-attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py:70
// `flash_attention` (body `_kernel`, :24), which the training path reaches as
// the tiled form of repro/models/attention.py:129 `attend_chunked`.
//
// For batch b, query head h (kv head h / (HP / KVS), the consecutive repeat
// of the reference's _expand_kv) and query row i < S:
//
//   s_ij = (q_i . k_j) / sqrt(hd)          float32, masked to -2e38 where
//                                          j > i (causal) or j >= S
//   out_i = sum_j softmax(s_i)_j v_j       online softmax, P kept in float32
//   lse_i = m_i + log(l_i)                 for the backward recompute
//
// q, k and v are widened to float32 as they are read; out is written in q's
// dtype after the division by max(l, 1e-30), as in the TPU kernel.  The KV
// heads are never expanded in memory.  Any S works: a ragged last tile is
// masked (the TPU kernel asserts S % 128 == 0).
//
// Bound on the H100: operations.  At the training shape (B 8, S 1024, 16/8
// heads, hd 128, causal, bf16) a call does 4 * hd flops per unmasked (i, j)
// pair, 34.4 GFLOP (35 us even on the bf16 tensor cores at 989 TFLOP/s),
// against 101 MB of q, k, v, out and lse (30 us at 3.35 TB/s).  This first
// form runs on the CUDA cores in float32 (67 TFLOP/s, 0.51 ms for that
// work): one CTA per (64-row Q tile, head, batch), larger causal tiles
// launched first; four threads per query row, each holding a quarter of the
// row's q and of its accumulator in registers (float4 chunks interleaved, so
// the four lanes read neighbouring 16-byte words of a K or V row and the
// other rows of the warp share them as broadcasts); K and V tiles of 64
// keys staged in shared memory as float32 with 16-byte loads; the online
// softmax updated once per 16 keys; key chunks wholly above the diagonal of
// every row of a warp skipped.  Products are explicit fmaf (the build uses
// -fmad=false).  Tensor cores (wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kRows = 64;                  // query rows per CTA
constexpr int kParts = 4;                  // threads per query row
constexpr int kThreads = kRows * kParts;   // 256
constexpr int kKeys = 64;                  // keys per shared-memory tile
constexpr int kChunk = 16;                 // keys per online-softmax update
constexpr float kNegInf = -2.0e38f;        // the reference's mask value

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// 16 bytes of T from global memory -> 16 / sizeof(T) floats in shared memory.
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  store4(dst, load4(src));
}

__device__ __forceinline__ void widen16(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Keys [k0, k0 + kKeys) of one kv head into dst [kKeys][HD] as float32;
// keys at or beyond S are zero (they are masked, and 0 * p stays finite).
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride,
                                          int k0, int S) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = HD / E;        // loads per key row
  for (int i = threadIdx.x; i < kKeys * VPR; i += kThreads) {
    const int j = i / VPR;
    const int c = i - j * VPR;
    float* d = dst + j * HD + c * E;
    if (k0 + j < S) {
      widen16(src + (long long)(k0 + j) * stride + c * E, d);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = 0.f;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)  // two CTAs per SM
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int S, int HP, int KVS,
                       int causal, float scale) {
  constexpr int D4 = HD / 4 / kParts;  // float4 chunks per thread
  extern __shared__ float smem[];
  float* ks = smem;                // [kKeys][HD]
  float* vs = smem + kKeys * HD;   // [kKeys][HD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // largest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (HP / KVS);
  const int part = threadIdx.x % kParts;
  const int row = qt * kRows + threadIdx.x / kParts;
  const int rows_per_warp = 32 / kParts;
  const int warp_row_max = qt * kRows + (threadIdx.x / 32 + 1) * rows_per_warp - 1;

  const long long q_stride = (long long)HP * HD;   // between positions
  const long long kv_stride = (long long)KVS * HD;
  const T* qb = q + ((long long)b * S * HP + h) * HD;
  const T* kb = k + ((long long)b * S * KVS + kvh) * HD;
  const T* vb = v + ((long long)b * S * KVS + kvh) * HD;

  // this thread's dims: float4 chunk c = m * kParts + part, dims 4c .. 4c+3
  float4 qr[D4], acc[D4];
#pragma unroll
  for (int m = 0; m < D4; ++m) {
    const int d = 4 * (m * kParts + part);
    qr[m] = row < S ? load4(qb + row * q_stride + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m_i = kNegInf, l_i = 0.f;

  const int last_row = min(S, (qt + 1) * kRows) - 1;
  const int k_end = causal ? last_row + 1 : S;  // keys [0, k_end) are read

  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile has been consumed
    load_tile<T, HD>(ks, kb, kv_stride, k0, S);
    load_tile<T, HD>(vs, vb, kv_stride, k0, S);
    __syncthreads();
    for (int c0 = 0; c0 < kKeys; c0 += kChunk) {
      const int kc = k0 + c0;
      // warp-uniform: later chunks are masked for every row of this warp
      if (kc >= k_end || (causal && kc > warp_row_max)) break;
      float s[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = ks + (c0 + jj) * HD;
        float dot = 0.f;
#pragma unroll
        for (int m = 0; m < D4; ++m) {
          const float4 kv4 = *reinterpret_cast<const float4*>(kr + 4 * (m * kParts + part));
          dot = fmaf(qr[m].x, kv4.x, dot);
          dot = fmaf(qr[m].y, kv4.y, dot);
          dot = fmaf(qr[m].z, kv4.z, dot);
          dot = fmaf(qr[m].w, kv4.w, dot);
        }
        s[jj] = dot;
      }
      float mx = m_i;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float dot = s[jj];
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int key = kc + jj;
        const bool masked = key >= S || (causal && key > row);
        s[jj] = masked ? kNegInf : dot * scale;
        mx = fmaxf(mx, s[jj]);
      }
      const float alpha = expf(m_i - mx);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = expf(s[jj] - mx);
        psum += s[jj];
      }
      l_i = l_i * alpha + psum;
      m_i = mx;
#pragma unroll
      for (int m = 0; m < D4; ++m) {
        acc[m].x *= alpha;
        acc[m].y *= alpha;
        acc[m].z *= alpha;
        acc[m].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* vr = vs + (c0 + jj) * HD;
        const float p = s[jj];
#pragma unroll
        for (int m = 0; m < D4; ++m) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + 4 * (m * kParts + part));
          acc[m].x = fmaf(p, v4.x, acc[m].x);
          acc[m].y = fmaf(p, v4.y, acc[m].y);
          acc[m].z = fmaf(p, v4.z, acc[m].z);
          acc[m].w = fmaf(p, v4.w, acc[m].w);
        }
      }
    }
  }

  if (row >= S) return;
  const float inv = 1.f / fmaxf(l_i, 1e-30f);
  T* ob = out + ((long long)b * S * HP + h) * HD + row * q_stride;
#pragma unroll
  for (int m = 0; m < D4; ++m) {
    const int d = 4 * (m * kParts + part);
    store4(ob + d, make_float4(acc[m].x * inv, acc[m].y * inv, acc[m].z * inv,
                               acc[m].w * inv));
  }
  if (part == 0) lse[((long long)b * HP + h) * S + row] = m_i + logf(l_i);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int S, int HP, int KVS, int causal, float scale,
           cudaStream_t stream) {
  const int smem = 2 * kKeys * HD * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + kRows - 1) / kRows, HP, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, S, HP, KVS, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, float* lse,
              int B, int S, int HP, int KVS, int HD, int causal, float scale,
              cudaStream_t stream) {
  switch (HD) {
    case 16: return launch<T, 16>(q, k, v, out, lse, B, S, HP, KVS, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, B, S, HP, KVS, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, S, HP, KVS, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, S, HP, KVS, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, out [B, S, HP, HD]; k, v [B, S, KVS, HD], contiguous, in float32
// (dtype 0) or bfloat16 (dtype 1); lse float32 [B, HP, S].  HD is one of
// 16, 32, 64, 128 and HP % KVS == 0.  Returns cudaGetLastError().
int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                           void* out, float* lse, int B, int S, int HP, int KVS,
                           int HD, int causal, float scale, void* stream) {
  if (B < 1 || S < 1 || HP < 1 || KVS < 1 || HP % KVS != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, out, lse, B, S, HP, KVS, HD, causal, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, out, lse, B, S, HP, KVS, HD, causal, scale,
                                    st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
