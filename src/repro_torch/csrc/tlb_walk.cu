// The interval walk of the Rainbow translation path ("rainbow" kind): split
// 4 KB and 2 MB TLBs (L1 + L2 each), the bitmap cache and the remap-pointer
// read, for the four cases of the paper's Fig. 6.
//
// Replaces the serial `lax.scan` of repro/sim/tlbsim.py:328
// `make_interval_runner` (scan at :434), which is not a Pallas kernel but
// the largest phase of an interval.  The result -- tags, LRU, the access
// clock t and all 14 counters -- is bitwise that of `run_interval_fast`.
//
// Bound on the H100: latency.  Each access's hits and victims depend on
// every earlier access through the LRU state, so the walk is one serial
// chain; the 10 bytes read per access (2.6 MB at 260k accesses, about a
// microsecond at 3.35 TB/s) are not what limits it.  Design: one block walks
// the interval; its threads stage the TLB and bitmap-cache tables (sized from
// the geometry) and tiles of the access stream in shared memory, and thread
// 0 walks each tile in order, so the serial chain touches shared memory
// only.
//
// Exactness: the five float32 cycle counters are summed serially in access
// order with __fadd_rn (and -fmad=false), adding the same float32 constants
// the reference adds (rounded once on the host).  The nine count-like
// counters are int32 batch counts converted to float32 once and added to the
// carried value, as the reference does.  Hit way = first matching way;
// victim = first way of least LRU; the two L1 touches of a split lookup are
// one conditional write (reference `_fused_split_lookup`).  Set index is
// v % sets for v >= 0 (the wrapper checks), which equals the reference's
// floor-mod.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

struct Geometry {
  int sets1, ways1;  // L1 of each split TLB
  int sets2, ways2;  // L2 of each split TLB
  int setsb, waysb;  // bitmap cache
};

struct Costs {  // float32 values of the reference's per-access adds
  float tlb_hit, tlb_miss;      // l1_lat + 0, l1_lat + l2_lat
  float walk2m;                 // ptw_refs_2m * t_dr
  float bmp_hit, bmp_miss;      // bitmap_cache_lat + 0, + t_nr
  float remap;                  // remap_read_lat
  float t_dr, t_dw, t_nr, t_nw; // memory access costs
};

struct Table {
  int* tags;
  int* lru;
  int sets, ways;
};

// Layout of the packed int32 state (and of its shared-memory copy):
// [t, 4K.L1 tags, lru, 4K.L2 tags, lru, 2M.L1 tags, lru, 2M.L2 tags, lru,
//  bmc tags, lru]
__host__ __device__ inline int state_ints(const Geometry& g) {
  return 1 + 4 * (g.sets1 * g.ways1 + g.sets2 * g.ways2) + 2 * g.setsb * g.waysb;
}

__device__ inline void tables(int* base, const Geometry& g, Table* t) {
  int* p = base + 1;
  const int n1 = g.sets1 * g.ways1, n2 = g.sets2 * g.ways2;
  for (int k = 0; k < 2; ++k) {
    t[2 * k] = {p, p + n1, g.sets1, g.ways1};
    p += 2 * n1;
    t[2 * k + 1] = {p, p + n2, g.sets2, g.ways2};
    p += 2 * n2;
  }
  t[4] = {p, p + g.setsb * g.waysb, g.setsb, g.waysb};
}

__device__ inline int set_base(const Table& tb, int v) {
  return (tb.sets == 1 ? 0 : v % tb.sets) * tb.ways;
}

__device__ inline int hit_way(const Table& tb, int b, int v) {
  for (int w = 0; w < tb.ways; ++w)
    if (tb.tags[b + w] == v) return w;
  return -1;
}

__device__ inline int victim_way(const Table& tb, int b) {
  int best = 0, least = tb.lru[b];
  for (int w = 1; w < tb.ways; ++w) {
    if (tb.lru[b + w] < least) {
      least = tb.lru[b + w];
      best = w;
    }
  }
  return best;
}

__device__ inline void put(const Table& tb, int b, int way, int v, int now) {
  tb.tags[b + way] = v;
  tb.lru[b + way] = now;
}

// One split-TLB lookup; returns the L1 and L2 hits.
__device__ inline void split_lookup(const Table& l1, const Table& l2, int v,
                                    int now, bool fill, bool* h1, bool* h2) {
  const int b1 = set_base(l1, v), b2 = set_base(l2, v);
  const int hw1 = hit_way(l1, b1, v), hw2 = hit_way(l2, b2, v);
  *h1 = hw1 >= 0;
  *h2 = hw2 >= 0;
  const int way2 = *h2 ? hw2 : victim_way(l2, b2);
  const int way1 = *h1 ? hw1 : victim_way(l1, b1);
  if (*h2 || fill) put(l2, b2, way2, v, now);
  if (*h1 || *h2 || fill) put(l1, b1, way1, v, now);
}

// Bitmap-cache probe + fill (always writes the line); returns the hit.
__device__ inline bool bmc_lookup(const Table& tb, int p, int now) {
  const int b = set_base(tb, p);
  const int hw = hit_way(tb, b, p);
  put(tb, b, hw >= 0 ? hw : victim_way(tb, b), p, now);
  return hw >= 0;
}

__global__ void tlb_walk_rainbow_kernel(
    const int* __restrict__ vpn, const int* __restrict__ sp,
    const unsigned char* __restrict__ in_dram,
    const unsigned char* __restrict__ is_write, int a, int* state,
    float* counters, Geometry g, Costs c) {
  extern __shared__ int smem[];
  const int n_state = state_ints(g);
  int* st = smem;
  int* tile_v = st + n_state;
  int* tile_s = tile_v + kTile;
  unsigned char* tile_f = reinterpret_cast<unsigned char*>(tile_s + kTile);

  for (int i = threadIdx.x; i < n_state; i += blockDim.x) st[i] = state[i];
  __syncthreads();

  Table tb[5];
  tables(st, g, tb);
  int t = st[0];
  float ctlb = counters[0], cwalk = counters[1], cbmp = counters[2];
  float crmp = counters[3], cmem = counters[4];
  int m41 = 0, m42 = 0, m21 = 0, m22 = 0, mb = 0;
  int dr = 0, dw = 0, nr = 0, nw = 0;

  for (int base = 0; base < a; base += kTile) {
    const int n = min(kTile, a - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      tile_v[i] = vpn[base + i];
      tile_s[i] = sp[base + i];
      tile_f[i] = (in_dram[base + i] ? 1 : 0) | (is_write[base + i] ? 2 : 0);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        const int v = tile_v[i], s = tile_s[i];
        const bool dram = tile_f[i] & 1, wr = tile_f[i] & 2;
        bool h41, h42, h21, h22;
        split_lookup(tb[0], tb[1], v, t, dram, &h41, &h42);
        const bool hit4 = (h41 || h42) && dram;
        split_lookup(tb[2], tb[3], s, t, true, &h21, &h22);
        const bool sptw = !(h21 || h22);
        const bool need = !hit4;
        const bool bhit = bmc_lookup(tb[4], s, t);
        const bool bmiss = need && !bhit;
        ctlb = __fadd_rn(ctlb, (!h41 && !h21) ? c.tlb_miss : c.tlb_hit);
        cwalk = __fadd_rn(cwalk, (need && sptw) ? c.walk2m : 0.0f);
        cbmp = __fadd_rn(cbmp, need ? (bmiss ? c.bmp_miss : c.bmp_hit) : 0.0f);
        crmp = __fadd_rn(crmp, (need && dram) ? c.remap : 0.0f);
        cmem = __fadd_rn(cmem, wr ? (dram ? c.t_dw : c.t_nw)
                                  : (dram ? c.t_dr : c.t_nr));
        m41 += dram && !h41;
        m42 += dram && !hit4;
        m21 += !h21;
        m22 += sptw;
        mb += bmiss;
        dr += dram && !wr;
        dw += dram && wr;
        nr += !dram && !wr;
        nw += !dram && wr;
        ++t;
      }
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    st[0] = t;
    counters[0] = ctlb;
    counters[1] = cwalk;
    counters[2] = cbmp;
    counters[3] = crmp;
    counters[4] = cmem;
    const int counts[9] = {m41, m42, m21, m22, mb, dr, dw, nr, nw};
    for (int k = 0; k < 9; ++k)
      counters[5 + k] = __fadd_rn(counters[5 + k], __int2float_rn(counts[k]));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_state; i += blockDim.x) state[i] = st[i];
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int tlb_walk_state_ints(int sets1, int ways1, int sets2, int ways2, int setsb,
                        int waysb) {
  return state_ints(Geometry{sets1, ways1, sets2, ways2, setsb, waysb});
}

int tlb_walk_smem_bytes(int state_ints_) {
  return state_ints_ * (int)sizeof(int) + kTile * (2 * (int)sizeof(int) + 1);
}

// Walks `a` accesses, updating `state` (packed int32, see state_ints) and the
// 14 float32 `counters` in place.  Returns cudaGetLastError().
int tlb_walk_rainbow_launch(const int* vpn, const int* sp,
                            const unsigned char* in_dram,
                            const unsigned char* is_write, int a, int* state,
                            float* counters, int sets1, int ways1, int sets2,
                            int ways2, int setsb, int waysb, float tlb_hit,
                            float tlb_miss, float walk2m, float bmp_hit,
                            float bmp_miss, float remap, float t_dr,
                            float t_dw, float t_nr, float t_nw, void* stream) {
  const Geometry g{sets1, ways1, sets2, ways2, setsb, waysb};
  const Costs c{tlb_hit, tlb_miss, walk2m, bmp_hit, bmp_miss,
                remap,   t_dr,     t_dw,   t_nr,    t_nw};
  const int smem = tlb_walk_smem_bytes(state_ints(g));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tlb_walk_rainbow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  tlb_walk_rainbow_kernel<<<1, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      vpn, sp, in_dram, is_write, a, state, counters, g, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
