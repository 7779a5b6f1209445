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
//   out = sum_p softmax(s)_p * v_p          float32 sums
//   mass_h[b, h, i] = sum_{t} softmax(s)_{i*block+t}   (optional)
//   mass[b, i]      = sum_h mass_h[b, h, i]            (heads in order 0..HP-1)
//
// In bf16 the probabilities are rounded to bf16 before the PV product (as the
// reference rounds them, rainbow_decode.py:63) and the sum stays float32.
//
// Bound on the H100: bytes.  A call must read the readable K/V rows once (at
// the serving shape, B 8, KVS 8, hd 128, ~320 positions: 10.6 MB in bf16,
// 3.2 us at 3.35 TB/s); the arithmetic is 4 flops per K/V element.  What
// limits a decode call is latency: too few CTAs, loads not in flight while
// the CTA computes, and serial chains of dependent loads.  So the walk over
// the KV blocks is split across CTAs, two launches per call:
//
// 1. `rainbow_attention_kernel`, grid (KVS, B, nsplit): each split covers as
//    many whole KV blocks as fit in kSplitPos = 64 positions (at least one),
//    so nsplit depends on nblk and block only, never on length (5 splits, 320
//    CTAs at the serving shape); the last split also takes the fresh lane.
//    One CTA per (kv head, row, split) loads each K/V row once for all the
//    query heads that share it (GQA): it resolves its rows' addresses from
//    vidx, then starts every row's cp.async at once (16 bytes a thread; K
//    and V as two groups, so the scores start while V is still in flight),
//    keeping K and V in their own dtype in shared memory.  The lanes that
//    share a row each hold their 16-byte chunks of every head's q and of
//    every head's PV sum in registers; one warp per head forms the split's
//    max m, normaliser l = sum exp(s - m) and each block's sum of
//    exp(s - m) in position order.  It writes (acc, m, l) per (row, head,
//    split); a split with no readable position writes m = -inf, l = 0.
// 2. `rainbow_attention_combine_kernel`, grid (HP + 1, B): CTA (h, b)
//    merges head h's splits in split order (a split with l = 0 adds exactly
//    0) into out; CTA (HP, b) forms each block's mass as
//    blk_sum * exp(m_split - m) / l, summed over the heads 0..HP-1 in order.
//
// No atomics anywhere: every sum has a fixed order, so the mass -- which the
// controller quantizes (kvcache.quantize_mass) -- is the same from run to run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;     // query heads per kv head
constexpr int kMaxHd = 2 * kThreads;
constexpr int kSplitPos = 64;    // positions per split at most (whole blocks)
constexpr int kMaxBlock = kSplitPos;  // tokens per KV block
constexpr int kMaxPos = kSplitPos + 1;  // positions of a split, the fresh lane included
constexpr int kUnroll = 4;       // positions per lane group in flight in the dot and PV passes
constexpr int kMassTerms = 2048;  // (block, head) mass terms staged per pass, at least

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

// 16 bytes global -> shared without passing through registers.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most N committed groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Elements per shared K/V row: head_dim rounded up to 16 bytes, plus 16
// bytes so that neighbouring rows start in other banks.
template <typename T>
__host__ __device__ __forceinline__ int row_pitch(int hd) {
  constexpr int E = 16 / sizeof(T);
  return ((hd + E - 1) / E + 1) * E;
}

// Lanes that share one K/V row in the dot and PV passes: the row's 16-byte
// chunks rounded up to a power of two, at most a warp (a lane then takes
// up to kMaxHd / E / 32 chunks: two in float32 at head_dim 256, else one).
template <typename T>
__host__ __device__ __forceinline__ int lanes_per_row(int hd) {
  const int nchunk = (hd + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T));
  int lpr = 1;
  while (lpr < nchunk && lpr < 32) lpr <<= 1;
  return lpr;
}

// The partial record of (row b, query head h, split s) in `part`:
// acc[hd], then m, then l; records [B][HP][nsplit] of hd + 2 floats.
// G is the query-head group rounded up to a power of two (registers).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) rainbow_attention_kernel(
    const T* __restrict__ q,                                   // [B, HP, hd]
    const T* __restrict__ cap_k, const T* __restrict__ cap_v,  // [NB, block, KVS, hd]
    const T* __restrict__ hot_k, const T* __restrict__ hot_v,  // [HOT, block, KVS, hd]
    const int* __restrict__ vidx,                              // [B, nblk]
    const T* __restrict__ k_new, const T* __restrict__ v_new,  // [B, KVS, hd] or null
    float* __restrict__ part,                                  // partial records
    float* __restrict__ blk_sum,                               // [B, HP, nblk] or null
    int length, int nblk, int nb_cap, int block, int kvs, int hp, int hd,
    int blocks_per_split, float sqrt_hd, int vec16) {
  constexpr int E = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int kCpl = kMaxHd / E / 32;        // 16-byte chunks per lane at most
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int group = hp / kvs;
  const int h0 = kvh * group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rec = hd + 2;
  const long long head_step = (long long)nsplit * rec;  // between heads' records
  float* part0 = part + ((long long)(b * hp + h0) * nsplit + split) * rec;
  const int j0 = split * blocks_per_split;  // first KV block of the split
  // block positions read, then the fresh lane (in the last split)
  const int nread = max(0, min(length - j0 * block, min(blocks_per_split, nblk - j0) * block));
  const bool fresh = k_new != nullptr && split == nsplit - 1;
  const int npos = nread + (fresh ? 1 : 0);
  if (npos == 0) {  // every position masked: the split adds exactly nothing
    if (tid < group) {
      part0[tid * head_step + hd] = -INFINITY;
      part0[tid * head_step + hd + 1] = 0.0f;
    }
    return;
  }

  const long long pos_stride = (long long)kvs * hd;     // elements between positions
  const long long row = (long long)block * pos_stride;  // elements per KV block
  const int nchunk = (hd + E - 1) / E;                  // 16-byte chunks per row
  const int pitch = row_pitch<T>(hd);
  // lanes [slot * lpr, slot * lpr + lpr) of the block share positions
  // slot, slot + rstep, ...; lane chunk c = cl + k * lpr of each
  const int lpr = lanes_per_row<T>(hd);
  const int rstep = kThreads / lpr;
  const int slot = tid / lpr;
  const int cl = tid % lpr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [kMaxPos][pitch]
  T* v_s = k_s + kMaxPos * pitch;           // [kMaxPos][pitch]
  float* red = reinterpret_cast<float*>(smem_raw);  // after PV: [rstep][group][nchunk * E]
  __shared__ float p_s[kMaxGroup][kMaxPos];  // scores, then probabilities
  __shared__ const T* krow_s[kMaxPos];       // where each position's K/V rows start
  __shared__ const T* vrow_s[kMaxPos];

  if (tid < npos) {
    if (tid < nread) {
      const int jb = tid / block;
      const int t = tid - jb * block;
      const int v = vidx[(long long)b * nblk + j0 + jb];
      const long long off = (long long)t * pos_stride + (long long)kvh * hd;
      if (v < nb_cap) {
        krow_s[tid] = cap_k + (long long)v * row + off;
        vrow_s[tid] = cap_v + (long long)v * row + off;
      } else {
        krow_s[tid] = hot_k + (long long)(v - nb_cap) * row + off;
        vrow_s[tid] = hot_v + (long long)(v - nb_cap) * row + off;
      }
    } else {
      krow_s[tid] = k_new + (long long)b * pos_stride + (long long)kvh * hd;
      vrow_s[tid] = v_new + (long long)b * pos_stride + (long long)kvh * hd;
    }
  }
  // this lane's part of each head's q, in registers (zero beyond hd)
  float qr[G][kCpl][E];
  const T* q_row = q + ((long long)b * hp + h0) * hd;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < kCpl; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = (cl + k * lpr) * E + e;
        qr[g][k][e] = g < group && d < hd ? load(q_row + g * hd + d) : 0.0f;
      }
  __syncthreads();

  // every K row's copy, then every V row's, all in flight at once
  if (vec16) {  // hd == nchunk * E and every row start is 16-byte aligned
    const int total = npos * nchunk;
    const int dp = kThreads / nchunk;
    const int dc = kThreads - dp * nchunk;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      T* dst = kv == 0 ? k_s : v_s;
      const T* const* src = kv == 0 ? krow_s : vrow_s;
      int p = tid / nchunk;
      int c = tid - p * nchunk;
      for (int i = tid; i < total; i += kThreads) {
        cp_async16(dst + p * pitch + c * E, src[p] + c * E);
        p += dp;
        c += dc;
        if (c >= nchunk) {
          c -= nchunk;
          ++p;
        }
      }
      cp_async_commit();
    }
    cp_async_wait<1>();  // K has landed
  } else {
    const int w = nchunk * E;
    for (int i = tid; i < npos * w; i += kThreads) {
      const int p = i / w;
      const int d = i - p * w;
      if (d < hd) {
        k_s[p * pitch + d] = krow_s[p][d];
        v_s[p * pitch + d] = vrow_s[p][d];
      } else {  // the last chunk's tail
        store(k_s + p * pitch + d, 0.0f);
        store(v_s + p * pitch + d, 0.0f);
      }
    }
  }
  __syncthreads();

  // scores: lpr lanes per position, each over its chunks, for every head,
  // kUnroll positions per lane group at once; the trip count is uniform
  // across the block for the shuffles
  for (int p0 = 0; p0 < npos; p0 += kUnroll * rstep) {
    float dot[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * rstep + slot;
      uint4 kc[kCpl];
#pragma unroll
      for (int k = 0; k < kCpl; ++k) {
        const int c = cl + k * lpr;
        kc[k] = p < npos && c < nchunk
                    ? *reinterpret_cast<const uint4*>(k_s + p * pitch + c * E)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) dot[u][g] = 0.0f;
#pragma unroll
      for (int k = 0; k < kCpl; ++k) {
        float kf[E];
        unpack16(q, kc[k], kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) dot[u][g] += qr[g][k][e] * kf[e];
      }
    }
    for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) dot[u][g] += __shfl_xor_sync(0xffffffffu, dot[u][g], o);
    if (cl == 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * rstep + slot;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (p < npos && g < group) p_s[g][p] = dot[u][g] / sqrt_hd;
      }
    }
  }
  __syncthreads();

  // the split's softmax statistics and per-block sums, one warp per head
  for (int g = warp; g < group; g += kWarps) {
    float mx = -INFINITY;
    for (int p = lane; p < npos; p += 32) mx = fmaxf(mx, p_s[g][p]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int p = lane; p < npos; p += 32) {
      const float e = expf(p_s[g][p] - mx);
      p_s[g][p] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part0[g * head_step + hd] = mx;
      part0[g * head_step + hd + 1] = sum;
    }
    __syncwarp();
    if (blk_sum != nullptr) {
      for (int jb = lane; jb * block < nread; jb += 32) {
        float bs = 0.0f;  // positions of the block in order
        for (int t = jb * block; t < min(nread, (jb + 1) * block); ++t) bs += p_s[g][t];
        blk_sum[((long long)b * hp + h0 + g) * nblk + j0 + jb] = bs;
      }
      __syncwarp();
    }
    for (int p = lane; p < npos; p += 32) p_s[g][p] = as_value(q, p_s[g][p]);
  }
  if (vec16) cp_async_wait<0>();  // V has landed
  __syncthreads();

  // PV: each lane accumulates its chunks of every head over its positions
  float acc[G][kCpl][E];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < kCpl; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][k][e] = 0.0f;
  for (int p0 = slot; p0 < npos; p0 += kUnroll * rstep) {
    float pg[kUnroll][G];
    uint4 vc[kUnroll][kCpl];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * rstep;
#pragma unroll
      for (int g = 0; g < G; ++g) pg[u][g] = p < npos && g < group ? p_s[g][p] : 0.0f;
#pragma unroll
      for (int k = 0; k < kCpl; ++k) {
        const int c = cl + k * lpr;
        vc[u][k] = p < npos && c < nchunk
                       ? *reinterpret_cast<const uint4*>(v_s + p * pitch + c * E)
                       : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int k = 0; k < kCpl; ++k) {
        float vf[E];
        unpack16(q, vc[u][k], vf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][k][e] += pg[u][g] * vf[e];
      }
  }
  __syncthreads();  // K and V are read: their memory takes the slots' sums

  const int w = nchunk * E;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < kCpl; ++k) {
      const int c = cl + k * lpr;
      if (g < group && c < nchunk)
#pragma unroll
        for (int e = 0; e < E; ++e) red[(slot * group + g) * w + c * E + e] = acc[g][k][e];
    }
  __syncthreads();
  for (int i = tid; i < group * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i - g * hd;
    float s = 0.0f;  // the slots in order
    for (int r = 0; r < rstep; ++r) s += red[(r * group + g) * w + d];
    part0[g * head_step + d] = s;
  }
}

// A head's final max M and normaliser L from its splits' maxima m and sums
// l, in split order; a split with l = 0 adds exactly 0 (no -inf - -inf).
__device__ __forceinline__ void head_stats(const float* m, const float* l, int nsplit,
                                           float& m_out, float& l_out) {
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s)
    if (l[s] > 0.0f) mx = fmaxf(mx, m[s]);
  float sum = 0.0f;
  for (int s = 0; s < nsplit; ++s)
    if (l[s] > 0.0f) sum += l[s] * expf(m[s] - mx);
  m_out = mx;
  l_out = sum;
}

// Shared floats of the combine kernel: the mass CTA's per-head M and L, and
// a stage for the split statistics or the mass terms.
__host__ __device__ __forceinline__ int combine_stage(int hp, int nsplit) {
  int n = kMassTerms;
  if (2 * nsplit > n) n = 2 * nsplit;
  return hp > n ? hp : n;
}

// Merges the splits: CTA (h, b) for h < HP writes out[b, h]; CTA (HP, b)
// forms row b's block mass, summed over heads 0..HP-1 in order.  Both stage
// the split statistics in shared memory and take each head's M and L from
// head_stats, so they agree to the bit.
template <typename T>
__global__ void __launch_bounds__(kThreads) rainbow_attention_combine_kernel(
    const float* __restrict__ part, const float* __restrict__ blk_sum,
    T* __restrict__ out,                                       // [B, HP, hd]
    float* __restrict__ mass,                                  // [B, nblk] or null
    int length, int nblk, int block, int hp, int hd, int nsplit,
    int blocks_per_split) {
  extern __shared__ float cs[];
  const int b = blockIdx.y;
  const int rec = hd + 2;
  const float* rec_b = part + (long long)b * hp * nsplit * rec;  // row b's records
  if (blockIdx.x < hp) {
    const int h = blockIdx.x;
    const float* rec_h = rec_b + (long long)h * nsplit * rec;
    float* w_s = cs;            // [nsplit]: m, then exp(m - M), 0 for empty splits
    float* l_s = cs + nsplit;   // [nsplit]: l, then L at [nsplit]
    for (int s = threadIdx.x; s < nsplit; s += kThreads) {
      w_s[s] = rec_h[(long long)s * rec + hd];
      l_s[s] = rec_h[(long long)s * rec + hd + 1];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float mx, sum;
      head_stats(w_s, l_s, nsplit, mx, sum);
      for (int s = 0; s < nsplit; ++s) w_s[s] = l_s[s] > 0.0f ? expf(w_s[s] - mx) : 0.0f;
      l_s[nsplit] = sum;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < hd; d += kThreads) {
      float acc = 0.0f;
      for (int s = 0; s < nsplit; ++s)
        if (w_s[s] > 0.0f) acc += rec_h[(long long)s * rec + d] * w_s[s];
      store(out + ((long long)b * hp + h) * hd + d, acc / l_s[nsplit]);
    }
    return;
  }
  float* m_h = cs;            // [hp]
  float* l_h = cs + hp;       // [hp]
  float* stage = cs + 2 * hp;
  const int n_stage = combine_stage(hp, nsplit);
  const int heads_per_pass = n_stage / (2 * nsplit);
  for (int h0 = 0; h0 < hp; h0 += heads_per_pass) {
    const int n = min(heads_per_pass, hp - h0) * nsplit;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float* r = rec_b + ((long long)h0 * nsplit + i) * rec;
      stage[i] = r[hd];
      stage[n + i] = r[hd + 1];
    }
    __syncthreads();
    for (int i = threadIdx.x; i * nsplit < n; i += kThreads)
      head_stats(stage + i * nsplit, stage + n + i * nsplit, nsplit, m_h[h0 + i], l_h[h0 + i]);
    __syncthreads();
  }
  const int per_pass = n_stage / hp;  // blocks whose terms fit the stage
  for (int blk0 = 0; blk0 < nblk; blk0 += per_pass) {
    const int nb = min(per_pass, nblk - blk0);
    for (int i = threadIdx.x; i < nb * hp; i += kThreads) {
      const int blk = blk0 + i / hp;
      const int h = i % hp;
      float t = 0.0f;  // exactly 0 for blocks at or beyond length
      if (blk * block < length) {
        const float m_split =
            rec_b[((long long)h * nsplit + blk / blocks_per_split) * rec + hd];
        t = blk_sum[((long long)b * hp + h) * nblk + blk] * expf(m_split - m_h[h]) / l_h[h];
      }
      stage[i] = t;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += kThreads) {
      float sm = 0.0f;  // heads in order
      for (int h = 0; h < hp; ++h) sm += stage[i * hp + h];
      mass[(long long)b * nblk + blk0 + i] = sm;
    }
    __syncthreads();
  }
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

template <typename T, int G>
int launch(const void* q, const void* cap_k, const void* cap_v,
           const void* hot_k, const void* hot_v, const int* vidx,
           const void* k_new, const void* v_new, void* out, float* part,
           float* blk_sum, float* mass, int batch, int length, int nblk,
           int nb_cap, int block, int kvs, int hp, int hd, int vec16,
           cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int nchunk = (hd + E - 1) / E;
  const int kv_bytes = 2 * kMaxPos * row_pitch<T>(hd) * (int)sizeof(T);
  const int red_bytes =
      kThreads / lanes_per_row<T>(hd) * (hp / kvs) * nchunk * E * (int)sizeof(float);
  const int smem = kv_bytes > red_bytes ? kv_bytes : red_bytes;
  static int split_smem = 48 * 1024, combine_smem = 48 * 1024;  // opted in so far
  cudaError_t e = allow_smem(rainbow_attention_kernel<T, G>, smem, split_smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks_per_split = kSplitPos / block > 1 ? kSplitPos / block : 1;
  const int nsplit = (nblk + blocks_per_split - 1) / blocks_per_split;
  rainbow_attention_kernel<T, G><<<dim3(kvs, batch, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cap_k),
      static_cast<const T*>(cap_v), static_cast<const T*>(hot_k),
      static_cast<const T*>(hot_v), vidx, static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), part, blk_sum, length, nblk, nb_cap, block, kvs,
      hp, hd, blocks_per_split, (float)sqrt((double)hd), vec16);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int csmem = (2 * hp + combine_stage(hp, nsplit) + 1) * (int)sizeof(float);
  e = allow_smem(rainbow_attention_combine_kernel<T>, csmem, combine_smem);
  if (e != cudaSuccess) return (int)e;
  rainbow_attention_combine_kernel<T>
      <<<dim3(hp + (mass != nullptr ? 1 : 0), batch), kThreads, csmem, stream>>>(
          part, blk_sum, static_cast<T*>(out), mass, length, nblk, block, hp, hd,
          nsplit, blocks_per_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_group(const void* q, const void* cap_k, const void* cap_v,
                 const void* hot_k, const void* hot_v, const int* vidx,
                 const void* k_new, const void* v_new, void* out, float* part,
                 float* blk_sum, float* mass, int batch, int length, int nblk,
                 int nb_cap, int block, int kvs, int hp, int hd, int vec16,
                 cudaStream_t stream) {
  const int group = hp / kvs;
  const decltype(&launch<T, 1>) fn = group <= 1 ? &launch<T, 1>
                                   : group <= 2 ? &launch<T, 2>
                                   : group <= 4 ? &launch<T, 4>
                                                : &launch<T, 8>;
  return fn(q, cap_k, cap_v, hot_k, hot_v, vidx, k_new, v_new, out, part, blk_sum,
            mass, batch, length, nblk, nb_cap, block, kvs, hp, hd, vec16, stream);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  k_new/v_new null: no fresh lane.
// part: float32 scratch of B * HP * nsplit * (hd + 2) partial records, with
// nsplit = ceil(nblk / max(1, 64 / block)) (ops.kv_splits).  mass null: no
// mass (blk_sum, float32 scratch [B, HP, nblk], is then unused).  vec16:
// every K/V row start is 16-byte aligned and hd * sizeof(T) is a multiple of
// 16.  Two launches; returns cudaGetLastError() after them.
int rainbow_attention_launch(int dtype, const void* q, const void* cap_k,
                             const void* cap_v, const void* hot_k,
                             const void* hot_v, const int* vidx,
                             const void* k_new, const void* v_new, void* out,
                             float* part, float* blk_sum, float* mass,
                             int batch, int length, int nblk, int nb_cap,
                             int block, int kvs, int hp, int hd, int vec16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block < 1 || block > kMaxBlock || hd < 1 || hd > kMaxHd || kvs < 1 || hp % kvs != 0 ||
      hp / kvs > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  if (mass == nullptr) blk_sum = nullptr;
  if (dtype == 0)
    return launch_group<float>(q, cap_k, cap_v, hot_k, hot_v, vidx, k_new, v_new,
                               out, part, blk_sum, mass, batch, length, nblk,
                               nb_cap, block, kvs, hp, hd, vec16, s);
  if (dtype == 1)
    return launch_group<__nv_bfloat16>(q, cap_k, cap_v, hot_k, hot_v, vidx, k_new,
                                       v_new, out, part, blk_sum, mass, batch,
                                       length, nblk, nb_cap, block, kvs, hp, hd,
                                       vec16, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
