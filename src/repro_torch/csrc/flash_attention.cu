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
// out is written in q's dtype after the division by max(l, 1e-30), as in the
// TPU kernel.  The KV heads are never expanded in memory.  Any S works: a
// ragged last tile is masked (the TPU kernel asserts S % 128 == 0).
//
// Bound on the H100: operations.  At the training shape (B 8, S 1024, 16/8
// heads, hd 128, causal, bf16) a call does 4 * hd flops per unmasked (i, j)
// pair, 34.4 GFLOP (35 us on the bf16 tensor cores at 989 TFLOP/s), against
// 101 MB of q, k, v, out and lse (30 us at 3.35 TB/s).  Two kernels, chosen
// by dtype in ops.py (`flash_route`):
//
// * bfloat16 (the training path), `flash_attention_mma_kernel`: the products
//   run on the tensor cores.  One CTA of 8 warps per (128-row Q tile, head,
//   batch), the largest causal tiles launched first; each warp owns 16 query
//   rows.  Q and a two-stage ring of 32-key K and V tiles stay bf16 in shared
//   memory, filled by cp.async (16 bytes a thread, rows beyond S
//   zero-filled) so that tile t + 1 loads while tile t is multiplied; rows
//   are padded by 16 bytes so that ldmatrix reads them without bank
//   conflicts.  S = Q K^T is mma.sync m16n8k16 (bf16 in, float32 out) on Q
//   and K fragments from ldmatrix; the scale, the mask (from each fragment
//   element's row and column) and the online softmax act on the
//   accumulators in log2 units (exp2), the row max and sum reduced over the
//   fragment's quad of lanes.  P keeps float32 precision in the PV product:
//   it is split into two bf16 halves, hi = bf16(p) and lo = bf16(p - hi),
//   and both multiply V (read with ldmatrix.trans) into one float32
//   accumulator, so P never rounds to bf16 and never leaves registers (the
//   S accumulator's layout is the A operand's).  That costs 1.5x the
//   tensor-core work of a bf16 P; 16-key chunks above a warp's last row are
//   skipped.  What bounds this form is latency more than the tensor cores,
//   so it trades tile size for warps in flight: 128 registers a thread and
//   no spills (Q is re-read from shared memory each k step rather than held,
//   key tiles are 32 wide) so that two CTAs, 16 warps, share an SM.  The
//   output goes out through shared memory in 16-byte stores.
// * float32 (the golden and parity path), `flash_attention_kernel`: the
//   CUDA cores in float32 (67 TFLOP/s; TF32 would lose the float32
//   tolerance), one CTA per (64-row Q tile, head, batch), four threads per
//   query row, each holding a quarter of the row's q and accumulator in
//   registers; K and V tiles of 64 keys staged in shared memory with
//   16-byte loads; the online softmax updated once per 16 keys; key chunks
//   wholly above the diagonal of every row of a warp skipped.  Products are
//   explicit fmaf (the build uses -fmad=false).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float kNegInf = -2.0e38f;  // the reference's mask value

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;                  // query rows per CTA
constexpr int kParts = 4;                  // threads per query row
constexpr int kThreads = kRows * kParts;   // 256
constexpr int kKeys = 64;                  // keys per shared-memory tile
constexpr int kChunk = 16;                 // keys per online-softmax update

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Keys [k0, k0 + kKeys) of one kv head into dst [kKeys][HD];
// keys at or beyond S are zero (they are masked, and 0 * p stays finite).
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride,
                                          int k0, int S) {
  constexpr int VPR = HD / 4;  // 16-byte loads per key row
  for (int i = threadIdx.x; i < kKeys * VPR; i += kThreads) {
    const int j = i / VPR;
    const int c = i - j * VPR;
    float* d = dst + j * HD + c * 4;
    if (k0 + j < S) {
      store4(d, load4(src + (long long)(k0 + j) * stride + c * 4));
    } else {
      store4(d, make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)  // two CTAs per SM
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
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
  const float* qb = q + ((long long)b * S * HP + h) * HD;
  const float* kb = k + ((long long)b * S * KVS + kvh) * HD;
  const float* vb = v + ((long long)b * S * KVS + kvh) * HD;

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
    load_tile<HD>(ks, kb, kv_stride, k0, S);
    load_tile<HD>(vs, vb, kv_stride, k0, S);
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
  float* ob = out + ((long long)b * S * HP + h) * HD + row * q_stride;
#pragma unroll
  for (int m = 0; m < D4; ++m) {
    const int d = 4 * (m * kParts + part);
    store4(ob + d, make_float4(acc[m].x * inv, acc[m].y * inv, acc[m].z * inv,
                               acc[m].w * inv));
  }
  if (part == 0) lse[((long long)b * HP + h) * S + row] = m_i + logf(l_i);
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* out, float* lse,
                int B, int S, int HP, int KVS, int causal, float scale,
                cudaStream_t stream) {
  const int smem = 2 * kKeys * HD * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + kRows - 1) / kRows, HP, B);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, HP, KVS, causal,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16 fed by ldmatrix), cp.async ring
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kM = 128;                 // query rows per CTA, 16 per warp
constexpr int kN = 32;                  // keys per tile
constexpr int kMmaWarps = kM / 16;
constexpr int kMmaThreads = 32 * kMmaWarps;  // 256
constexpr int kStages = 2;              // K/V tiles in flight
constexpr int kMinBlocks = 2;           // CTAs per SM: at most 128 registers a thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct MmaShape {
  static constexpr int kPitch = HD + 8;  // bf16 per shared row: +16 B, so the 8 rows
                                         // one ldmatrix reads lie in 8 bank groups
  static constexpr int kTile = kN * kPitch;  // one K or V tile
  static constexpr int kSmem = (kM * kPitch + 2 * kStages * kTile) * (int)sizeof(bf16);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; src_bytes 0
// reads nothing and zero-fills the 16 bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>  // wait until at most N committed groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// d += a (16 x 16, row-major) b (16 x 8, column-major); bf16 in, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) as two bf16 pairs whose sum keeps float32's precision to 2^-17:
// hi = bf16(x, y), lo = bf16 of what hi leaves out (that difference is exact).
__device__ __forceinline__ void split_pair(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// Rows [r0, r0 + ROWS) of one head (row stride `stride`) into dst
// [ROWS][kPitch], asynchronously; rows at or beyond S are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, long long stride,
                                          int r0, int S) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const bool in = r0 + r < S;
    cp_async16(dst + r * MmaShape<HD>::kPitch + c * 8,
               src + (in ? (long long)(r0 + r) * stride + c * 8 : 0), in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, kMinBlocks)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, int S, int HP, int KVS, int causal,
                           float scale) {
  constexpr int kP = MmaShape<HD>::kPitch;
  constexpr int kTile = MmaShape<HD>::kTile;
  constexpr int KC = HD / 16;  // k steps of Q K^T
  constexpr int ND = HD / 8;   // n tiles of the output
  constexpr int NS = kN / 8;   // n tiles of a score tile
  constexpr int kChunks = HD / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kM][kP]; later the output
  bf16* ks = qs + kM * kP;                       // [kStages][kN][kP]
  bf16* vs = ks + kStages * kTile;               // [kStages][kN][kP]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the largest causal tiles first
  const int q0 = qt * kM;
  const int kvh = h / (HP / KVS);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tq = lane & 3;   // fragment column pair
  const int wrow0 = q0 + warp * 16;  // this warp's first query row
  const int row0 = wrow0 + g;        // this thread's rows: row0 and row0 + 8

  const long long q_stride = (long long)HP * HD;  // between positions
  const long long kv_stride = (long long)KVS * HD;
  const bf16* qb = q + ((long long)b * S * HP + h) * HD;
  const bf16* kb = k + ((long long)b * S * KVS + kvh) * HD;
  const bf16* vb = v + ((long long)b * S * KVS + kvh) * HD;

  const int last_row = min(S, q0 + kM) - 1;
  const int n_tiles = ((causal ? last_row + 1 : S) + kN - 1) / kN;
  const float sscale = scale * kLog2e;  // scores in log2 units: exp2 (ex2.approx)

  // Q with tile 0 is the first group of copies, tiles 1 .. kStages - 2 one
  // group each; every iteration commits one more (empty past the last tile)
  copy_rows<HD, kM>(qs, qb, q_stride, q0, S);
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      copy_rows<HD, kN>(ks + t * kTile, kb, kv_stride, t * kN, S);
      copy_rows<HD, kN>(vs + t * kTile, vb, kv_stride, t * kN, S);
    }
    cp_async_commit();
  }

  float o[ND][4];      // output accumulators: rows row0, row0 + 8
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this thread's share of each row's sum

  for (int t = 0; t < n_tiles; ++t) {
    const int pre = t + kStages - 1;  // prefetch into the stage freed last iteration
    if (pre < n_tiles) {
      copy_rows<HD, kN>(ks + (pre % kStages) * kTile, kb, kv_stride, pre * kN, S);
      copy_rows<HD, kN>(vs + (pre % kStages) * kTile, vb, kv_stride, pre * kN, S);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile t (and Q) have landed
    __syncthreads();
    const bf16* kt = ks + (t % kStages) * kTile;
    const bf16* vt = vs + (t % kStages) * kTile;
    const int k0 = t * kN;
    // 16-key chunks holding a key <= the warp's last row: all of them below
    // the diagonal
    const int chunks = causal ? min(kN / 16, max(0, wrow0 + 31 - k0) / 16) : kN / 16;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      unsigned a[4];  // the warp's Q rows, k step kc (re-read: registers are scarcer)
      ldmatrix_x4(a, qs + (warp * 16 + (lane & 15)) * kP + kc * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        if (np < chunks) {
          unsigned kf[4];  // B fragments of keys 16np..+7 and +8..+15
          ldmatrix_x4(kf, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kP + kc * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], a, kf[2], kf[3]);
        }
      }
    }

    // scale, mask (element e of n tile j: row row0 + 8 * (e >> 1), key
    // k0 + 8j + 2tq + (e & 1)) and the online softmax on the accumulators
    const bool edge = k0 + kN > S || (causal && k0 + kN - 1 > wrow0);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sscale;
        if (edge) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          if (key >= S || (causal && key > row0 + 8 * (e >> 1))) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        l_r[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // O += P V with P = hi + lo: n tiles 2kc, 2kc + 1 of S are the A operand
    // of key chunk kc; skipped chunks hold p = 0 exactly
#pragma unroll
    for (int kc = 0; kc < kN / 16; ++kc) {
      if (kc < chunks) {
        unsigned ph[4], pl[4];
        split_pair(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
        split_pair(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
        split_pair(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
        split_pair(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          unsigned vf[4];  // B fragments of dims 16dp..+7 and +8..+15
          ldmatrix_x4_trans(vf, vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kP +
                                    dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], pl, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
          mma_bf16(o[2 * dp], ph, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], ph, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / fmaxf(l_r[r], 1e-30f);
  }
  // the warp's own 16 rows of the Q tile take its output, then 16-byte stores
  bf16* os = qs + warp * 16 * kP;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * kP + nd * 8 + 2 * tq) =
        __floats2bfloat162_rn(o[nd][0] * inv[0], o[nd][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * kP + nd * 8 + 2 * tq) =
        __floats2bfloat162_rn(o[nd][2] * inv[1], o[nd][3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = out + ((long long)b * S * HP + h) * HD;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    if (wrow0 + r < S)
      *reinterpret_cast<uint4*>(ob + (wrow0 + r) * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * kP + c * 8);
  }
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < S)
        lse[((long long)b * HP + h) * S + row0 + 8 * r] =
            m_r[r] * kLn2 + logf(l_r[r]);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse,
               int B, int S, int HP, int KVS, int causal, float scale,
               cudaStream_t stream) {
  constexpr int smem = MmaShape<HD>::kSmem;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_mma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(HP, B, (S + kM - 1) / kM);
  flash_attention_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, HP, KVS, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_route(int route, const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int S, int HP, int KVS, int causal, float scale,
                 cudaStream_t st) {
  return route == 0
             ? launch_simt<HD>(q, k, v, out, lse, B, S, HP, KVS, causal, scale, st)
             : launch_mma<HD>(q, k, v, out, lse, B, S, HP, KVS, causal, scale, st);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// route 0: float32 on the CUDA cores; route 1: bfloat16 on the tensor cores.
// q, out [B, S, HP, HD]; k, v [B, S, KVS, HD], contiguous, 16-byte aligned, in
// the route's dtype; lse float32 [B, HP, S].  HD is one of 16, 32, 64, 128
// and HP % KVS == 0.  Returns cudaGetLastError().
int flash_attention_launch(int route, const void* q, const void* k, const void* v,
                           void* out, float* lse, int B, int S, int HP, int KVS,
                           int HD, int causal, float scale, void* stream) {
  if (B < 1 || S < 1 || HP < 1 || KVS < 1 || HP % KVS != 0 || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return launch_route<16>(route, q, k, v, out, lse, B, S, HP, KVS, causal, scale, st);
    case 32: return launch_route<32>(route, q, k, v, out, lse, B, S, HP, KVS, causal, scale, st);
    case 64: return launch_route<64>(route, q, k, v, out, lse, B, S, HP, KVS, causal, scale, st);
    case 128: return launch_route<128>(route, q, k, v, out, lse, B, S, HP, KVS, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
