// Paged single-token decode attention over the Rainbow two-tier KV pool.
//
// Replaces the TPU kernel repro/kernels/rainbow_attention/rainbow_attention.py:94
// `rainbow_attention` (body `_kernel`, :50) and, on the serving path, the jnp
// attention of repro/serving/rainbow_decode.py:47 `_attend_with_mass` (called
// at :213 over the pool the JAX path concatenates at :174-185).
//
// For query row b, query head h (kv head h / (HP / KVS)) and kv block i, the
// block's rows live in the capacity pool when v = vidx[b, i] < NB and in the
// hot pool at row v - NB otherwise.  The two pools are read through their
// own base pointers; the [capacity ++ hot] pool is never built.  Position
// p = i * block + t is readable when p < length.  Optionally (k_new, v_new)
// add one more position, the decode step's own token, which is always
// readable and lies outside every block.
//
//   s   = (q . k_p) / sqrt(hd)             float32 products and sums
//   out = sum_p softmax(s)_p * v_p          online softmax in float32
//   mass_h[b, h, i] = sum_{t} softmax(s)_{i*block+t}   (optional)
//   mass[b, i]      = sum_h mass_h[b, h, i]            (heads in order 0..HP-1)
//
// In bf16 the probabilities are rounded to bf16 before the PV product (as the
// reference rounds them, rainbow_decode.py:63) and the sum stays float32.
// The per-block mass is formed without atomics: each block's sum of
// exp(s - m_i) and its running max m_i are kept, rescaled by
// exp(m_i - m) / l once the final (m, l) are known, and a second kernel
// reduces the heads in a fixed order, so the mass -- which the controller
// quantizes (kvcache.quantize_mass) -- is the same from run to run.
//
// Bound on the H100: bytes.  A call must read the readable K/V rows once
// (at the serving shapes, B=8, KVS=8, hd=128, ~300 positions: about 10 MB in
// bf16, 3 us at 3.35 TB/s); the arithmetic is 4 flops per K/V element.
// Design (a simple, exact first form): one CTA per (kv head, row b), so each
// K/V row is loaded once for all the query heads that share it (GQA).  A
// loop over tiles of whole KV blocks (up to kTile positions) replaces the
// TPU's sequential block grid: all threads first copy the tile's K and V
// rows into shared memory as float32 (16-byte loads where the layout
// allows, several in flight per thread), then one thread per (head,
// position) forms each q.k dot, one warp per head updates (m, l) and the
// tile's per-block sums, and every thread owns head_dim columns of the
// accumulator for the PV product.  Tiles wholly
// beyond `length` are skipped: their probabilities are exactly zero in the
// reference.  Split-KV (more CTAs than B x KVS), tensor-core and TMA forms
// are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;   // query heads per kv head
constexpr int kMaxHd = 2 * kThreads;
constexpr int kTile = 64;      // positions per tile
constexpr int kMaxBlock = kTile;  // tokens per KV block
constexpr int kBatch = 4;         // loads in flight per thread and row kind

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// A probability as the PV product of dtype T sees it.
__device__ __forceinline__ float as_value(const float*, float x) { return x; }
__device__ __forceinline__ float as_value(const __nv_bfloat16*, float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// 16 raw bytes of T (4 floats or 8 bf16 values) -> float32 at dst.
__device__ __forceinline__ void unpack16(const float*, const uint4& v, float* dst) {
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = f[i];
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16*, const uint4& v, float* dst) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rainbow_attention_kernel(
    const T* __restrict__ q,                                   // [B, HP, hd]
    const T* __restrict__ cap_k, const T* __restrict__ cap_v,  // [NB, block, KVS, hd]
    const T* __restrict__ hot_k, const T* __restrict__ hot_v,  // [HOT, block, KVS, hd]
    const int* __restrict__ vidx,                              // [B, nblk]
    const T* __restrict__ k_new, const T* __restrict__ v_new,  // [B, KVS, hd] or null
    T* __restrict__ out,                                       // [B, HP, hd]
    float* __restrict__ mass_h,                                // [B, HP, nblk] or null
    float* __restrict__ blk_m,                                 // [B, HP, nblk] or null
    int length, int nblk, int nb_cap, int block, int kvs, int hp, int hd,
    float sqrt_hd, int vec16) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int group = hp / kvs;
  const int h0 = kvh * group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long pos_stride = (long long)kvs * hd;  // elements between positions
  const long long row = (long long)block * pos_stride;  // elements per KV block
  const int per_tile = kTile / block;  // whole KV blocks per tile (>= 1)

  extern __shared__ float kv_s[];  // K tile [kTile][hd + 1], then V tile [kTile][hd]
  const int kstride = hd + 1;
  float* k_s = kv_s;
  float* v_s = kv_s + kTile * kstride;
  __shared__ float q_s[kMaxGroup][kMaxHd];
  __shared__ float p_s[kMaxGroup][kTile];  // scores, then exp(s - m)
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];
  __shared__ const T* krow_s[kTile];  // where each position's K/V rows start
  __shared__ const T* vrow_s[kTile];

  const T* q_row = q + ((long long)b * hp + h0) * hd;
  for (int i = tid; i < group * hd; i += kThreads) q_s[i / hd][i % hd] = load(q_row + i);
  if (tid < group) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[kMaxGroup][2];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g][0] = acc[g][1] = 0.0f;

  const int hist_tiles = (nblk + per_tile - 1) / per_tile;
  const int n_tiles = hist_tiles + (k_new != nullptr ? 1 : 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool fresh = tile == hist_tiles;
    const int j0 = tile * per_tile;  // first KV block of the tile
    int cnt;                         // readable positions of the tile
    if (fresh) {
      cnt = 1;
    } else {
      const int blocks = min(per_tile, nblk - j0);
      cnt = min(length - j0 * block, blocks * block);
      if (cnt <= 0) continue;  // every position masked: probability exactly 0
    }
    __syncthreads();  // the previous tile's readers are done with the buffers
    if (tid < cnt) {
      const T* kr;
      const T* vr;
      if (fresh) {
        kr = k_new + (long long)b * pos_stride + (long long)kvh * hd;
        vr = v_new + (long long)b * pos_stride + (long long)kvh * hd;
      } else {
        const int j = j0 + tid / block;
        const int t = tid - (tid / block) * block;
        const int v = vidx[(long long)b * nblk + j];
        const long long off = (long long)t * pos_stride + (long long)kvh * hd;
        if (v < nb_cap) {
          kr = cap_k + (long long)v * row + off;
          vr = cap_v + (long long)v * row + off;
        } else {
          kr = hot_k + (long long)(v - nb_cap) * row + off;
          vr = hot_v + (long long)(v - nb_cap) * row + off;
        }
      }
      krow_s[tid] = kr;
      vrow_s[tid] = vr;
    }
    __syncthreads();

    // the tile's K and V rows -> shared memory, float32; each thread issues
    // kBatch loads per row kind before it stores any, so they overlap
    if (vec16) {
      const int per = 16 / (int)sizeof(T);  // elements per 16-byte load
      const int chunks = hd / per;
      const int total = cnt * chunks;
      for (int i0 = tid; i0 < total; i0 += kThreads * kBatch) {
        uint4 kr[kBatch], vr[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < total) {
            const int p = i / chunks;
            const int c = (i - p * chunks) * per;
            kr[u] = *reinterpret_cast<const uint4*>(krow_s[p] + c);
            vr[u] = *reinterpret_cast<const uint4*>(vrow_s[p] + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < total) {
            const int p = i / chunks;
            const int c = (i - p * chunks) * per;
            unpack16(q, kr[u], k_s + p * kstride + c);
            unpack16(q, vr[u], v_s + p * hd + c);
          }
        }
      }
    } else {
      const int total = cnt * hd;
      for (int i0 = tid; i0 < total; i0 += kThreads * kBatch) {
        float kr[kBatch], vr[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < total) {
            const int p = i / hd;
            kr[u] = load(krow_s[p] + (i - p * hd));
            vr[u] = load(vrow_s[p] + (i - p * hd));
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < total) {
            const int p = i / hd;
            k_s[p * kstride + (i - p * hd)] = kr[u];
            v_s[i] = vr[u];
          }
        }
      }
    }
    __syncthreads();

    // scores: one thread per (head, position) dot, d in order; K rows are
    // padded by one float so a warp's 32 positions hit 32 banks
    for (int i = tid; i < group * cnt; i += kThreads) {
      const int g = i / cnt;
      const int p = i - g * cnt;
      const float* kp = k_s + p * kstride;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < hd; ++d) dot += q_s[g][d] * kp[d];
      p_s[g][p] = dot / sqrt_hd;
    }
    __syncthreads();

    // online-softmax update and the tile's per-block sums, one warp per head
    for (int g = warp; g < group; g += kWarps) {
      float mx = -INFINITY;
      for (int p = lane; p < cnt; p += 32) mx = fmaxf(mx, p_s[g][p]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int p = lane; p < cnt; p += 32) {
        const float e = expf(p_s[g][p] - m_new);
        p_s[g][p] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (mass_h != nullptr && !fresh) {
        __syncwarp();
        for (int jb = lane; jb * block < cnt; jb += 32) {
          float bs = 0.0f;  // positions of the block in order
          for (int t = jb * block; t < min(cnt, (jb + 1) * block); ++t) bs += p_s[g][t];
          const long long at = ((long long)b * hp + h0 + g) * nblk + j0 + jb;
          mass_h[at] = bs;
          blk_m[at] = m_new;
        }
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: thread tid owns head_dim columns tid and tid + kThreads
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d = tid + c * kThreads;
      if (d >= hd) break;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) acc[g][c] *= alpha_s[g];
#pragma unroll 8
      for (int p = 0; p < cnt; ++p) {
        const float vd = v_s[p * hd + d];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < group) acc[g][c] += as_value(q, p_s[g][p]) * vd;
      }
    }
  }
  __syncthreads();  // the last tile's (m, l) are final

#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d = tid + c * kThreads;
    if (d >= hd) break;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group)
        store(out + ((long long)b * hp + h0 + g) * hd + d, acc[g][c] / l_s[g]);
  }
  if (mass_h != nullptr) {
    for (int i = tid; i < group * nblk; i += kThreads) {
      const int g = i / nblk;
      const int blk = i % nblk;
      const long long at = ((long long)b * hp + h0 + g) * nblk + blk;
      mass_h[at] = blk * block < length
                       ? mass_h[at] * expf(blk_m[at] - m_s[g]) / l_s[g]
                       : 0.0f;
    }
  }
}

// mass[b, i] = sum over heads h = 0..HP-1, in that order, of mass_h[b, h, i].
__global__ void mass_reduce_kernel(const float* __restrict__ mass_h,
                                   float* __restrict__ mass, int batch, int hp,
                                   int nblk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * nblk) return;
  const int b = i / nblk;
  const int blk = i % nblk;
  float s = 0.0f;
  for (int h = 0; h < hp; ++h) s += mass_h[((long long)b * hp + h) * nblk + blk];
  mass[i] = s;
}

template <typename T>
int launch(const void* q, const void* cap_k, const void* cap_v,
           const void* hot_k, const void* hot_v, const int* vidx,
           const void* k_new, const void* v_new, void* out, float* mass_h,
           float* blk_m, float* mass, int batch, int length, int nblk,
           int nb_cap, int block, int kvs, int hp, int hd, int vec16,
           cudaStream_t stream) {
  const int smem = kTile * (2 * hd + 1) * (int)sizeof(float);
  static int smem_set = 48 * 1024;  // the largest opt-in set so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        rainbow_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid(kvs, batch);
  rainbow_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cap_k),
      static_cast<const T*>(cap_v), static_cast<const T*>(hot_k),
      static_cast<const T*>(hot_v), vidx, static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(out), mass_h, blk_m,
      length, nblk, nb_cap, block, kvs, hp, hd, (float)sqrt((double)hd), vec16);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || mass == nullptr) return (int)e;
  const int n = batch * nblk;
  mass_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(mass_h, mass, batch,
                                                          hp, nblk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  k_new/v_new null: no fresh lane.
// mass null: no mass (mass_h and blk_m are then unused).  vec16: every K/V
// row start is 16-byte aligned and hd * sizeof(T) is a multiple of 16.
// Returns cudaGetLastError() after the launches.
int rainbow_attention_launch(int dtype, const void* q, const void* cap_k,
                             const void* cap_v, const void* hot_k,
                             const void* hot_v, const int* vidx,
                             const void* k_new, const void* v_new, void* out,
                             float* mass_h, float* blk_m, float* mass,
                             int batch, int length, int nblk, int nb_cap,
                             int block, int kvs, int hp, int hd, int vec16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mass == nullptr) mass_h = blk_m = nullptr;
  if (dtype == 0)
    return launch<float>(q, cap_k, cap_v, hot_k, hot_v, vidx, k_new, v_new,
                         out, mass_h, blk_m, mass, batch, length, nblk, nb_cap,
                         block, kvs, hp, hd, vec16, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, cap_k, cap_v, hot_k, hot_v, vidx, k_new,
                                 v_new, out, mass_h, blk_m, mass, batch, length,
                                 nblk, nb_cap, block, kvs, hp, hd, vec16, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
