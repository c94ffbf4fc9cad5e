// Post-gather apply for Hopper (sm_90a): decompress scatter-add of the
// gathered DGC payload plus the packed transmit record, each output word
// written exactly once.
//
// Replaces the TPU kernels dgc_tpu/ops/kernels.py::payload_apply_bits and
// ::dgc_apply_rows (one Pallas body, _payload_apply_call). The TPU kernel
// buckets the payload by output chunk at payload scale (_stage_payload: a
// sort, a cumsum and a staging scatter) and then writes the flat buffer
// once, chunk by chunk, zeros included, with the record beside it. This
// design keeps that idea and drops the sort and the sequential page walk:
//
//   * Chunk ownership. Block b owns coordinates [4096 b, 4096 b + 4096) of
//     `acc` and words [128 b, 128 b + 128) of the record (a 4096-coordinate
//     tile is exactly 128 record words). It writes both once, zeros and sums
//     together, with 16-byte stores; the wrapper allocates them with
//     torch.empty. The last chunk may be partial: its `acc` stores are
//     masked (total is a multiple of 128, so a thread's 8 coordinates are
//     all inside or all outside), and its record words are all written
//     (num_sent_words rounds the record up to whole tiles).
//   * Routing at payload scale, no global sort. Only entries that
//     contribute are routed: in [0, total), and value != 0 or flagged.
//     Route "scan" (one launch, small payloads): every block reads the whole
//     payload from L2 and stages its own entries in shared memory. Route
//     "list" (a memset and two launches): a scatter of each contributing
//     entry's key (flat index, flag, payload position) and value into its
//     chunk's segment of a scratch list, `cap` slots a chunk (the plan sizes
//     it above the mean load), slots handed out by a per-chunk cursor; the
//     rare entries past a full segment go to an overflow region. The
//     scatter counts a tile of 2,048 entries per chunk in shared memory
//     first, so a tile makes one global atomic per chunk it touches, and
//     orders the tile by chunk, so the list is written in runs (above
//     12,288 chunks: one atomic per chunk and warp). The order the scatter
//     leaves within a segment does not matter, see below. The chunk block
//     loads its count and its first entries together (its segment's place
//     is fixed), so no count pass or prefix scan precedes it.
//   * In the block (256 threads), up to 256 entries (the steady state: 15
//     a chunk on average at ResNet-50's ratio 0.001): each thread takes one
//     entry's rank among the chunk's keys (coordinate, then payload
//     position), and the first entry of each coordinate sums its run. More
//     entries: a 4096-bin histogram by coordinate, an exclusive scan, and a
//     placement of each entry into its coordinate's run (shared-memory
//     atomics, so the order inside a run is the race's); each thread owns
//     16 consecutive coordinates and orders each run by payload position (an
//     insertion sort; runs longer than 32 entries are first sorted by the
//     whole block, a bitonic network over the run). Either way each run is
//     summed from +0.0 in payload order into a float tile in shared memory,
//     dividing each value first (IEEE divide and add, no fast math, no FMA:
//     there is no multiply), and a coordinate with a flagged entry ORs its
//     bit into the chunk's 128 record words in shared memory. So the result
//     is bitwise the plain version's payload-order sums and the same from
//     run to run, however the atomics raced. Zero values are routed only for
//     their flag and add nothing (+0.0 + +-0.0 = +0.0, and a sum from +0.0
//     never becomes -0.0), so a selected -0.0 adds as in the plain version;
//     a NaN is routed and summed as there.
//   * Any input stays exact. A chunk whose entries exceed the capacity the
//     launch was planned with (`cap`) reads the rest of them from the
//     overflow region and runs the same steps with its runs in global
//     scratch (a slower loop through L2); a run of any length is sorted by
//     the block-wide network.
//
// The plan (route, grid, `cap`, shared memory and scratch bytes) is computed
// in Python (dgc_tpu_torch/ops/kernels.py::apply_plan), which states the
// crossover between the routes and where it was measured.
//
// Two instantiations, on the index type I (apply_rows_launch and
// apply_rows_launch64; the wrapper picks by `total`, as PyTorch's
// canUse32BitIndexMath does). I = int is the kernel every buffer under
// 2**31 coordinates runs. I = long long takes int64 indices and a 64-bit
// `n`, `total` and chunk count: a routed key then keeps its coordinate
// chunk-local (12 bits, where the 32-bit key holds the flat index) and
// the chunk id lives beside it — implicit in a list segment, an int32 of
// its own beside each overflow entry — so no flat index loses a bit at
// any size. Above 2**31 coordinates there are 524,288 chunks or more, far
// above kHistMax, so the 64-bit scatter always takes the one-atomic-per-
// chunk-and-warp route. The output's word layout and the payload-order
// sums from +0.0 are the same in both.
//
// Bound on the card: bytes. Each payload entry read once (9 bytes: value,
// index, flag), `acc` (4 total bytes) and the record (total / 8 bytes)
// written once. At ResNet-50's ratio 0.001 (T = 27,068,416, n = 102,332) that
// is the [T] write, 0.033 ms at 3.35 TB/s; at ResNet-20's (T = 370,688,
// n = 1,132) 1.5 MB, well under a launch. The list route adds 12 bytes
// written and read per routed entry.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12 on the H100 machine): the chunk pass
// apply_rows_kernel 64 registers (the launch bound's cap: 4 blocks of 256
// an SM), 16 bytes of spill stores; apply_rows_scan_kernel 64 registers, no
// spills; apply_rows_route_kernel 64 registers, no spills, 144 bytes of
// static shared memory; the rest is dynamic: a chunk block 22,784 bytes plus
// 8 per entry of `cap` (12 more per entry on the scan route), a scatter
// block 8 bytes a chunk plus 32 KB of staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4096;             // coordinates a block owns
constexpr int kWords = 128;              // record words of one chunk
constexpr int kThreads = 256;            // threads of a chunk block
constexpr int kPer = kChunk / kThreads;  // coordinates a thread owns
constexpr int kSparse = kThreads;        // up to this many: rank sort
constexpr int kSpec = 32;                // entries a chunk block reads ahead
constexpr int kRunSerial = 32;           // longer runs: block-wide sort
constexpr int kBatch = 4;                // entries a thread loads at once
constexpr int kRouteThreads = 256;
constexpr int kItems = 8;                // entries a route thread per tile
constexpr int kTile = kRouteThreads * kItems;  // payload entries a tile
constexpr int kHistMax = 12288;          // chunks a shared histogram holds
constexpr uint32_t kFlag = 0x80000000u;  // flag bit beside the position
constexpr uint32_t kPos = 0x7fffffffu;

// A routed entry: flat index << 32 | flag << 31 | payload position (the
// 64-bit instantiation: the chunk-local coordinate << 32 | ...). Keys
// are unique (one per position) and order a chunk's entries by
// coordinate, then position, once the flag is masked.
using Key = unsigned long long;
__device__ __forceinline__ Key order_of(Key k) { return k & ~(Key)kFlag; }
__device__ __forceinline__ int coord_of(Key k) {
  return (int)(k >> 32) & (kChunk - 1);
}
// (32-bit keys only: a 64-bit key carries no chunk)
__device__ __forceinline__ int chunk_of(Key k) { return (int)(k >> 44); }

template <typename I>
__device__ __forceinline__ bool contributes(I p, float v, uint8_t f,
                                            I total) {
  return p >= 0 && p < total && (v != 0.0f || f != 0);
}

template <typename I>
__device__ __forceinline__ Key make_key(I p, long long i, uint8_t f) {
  if constexpr (sizeof(I) == 8) p &= kChunk - 1;  // the chunk is beside it
  return (Key)p << 32 | (uint32_t)i | (f ? kFlag : 0u);
}

// Exclusive scan of one int per thread over the block (blockDim.x a
// multiple of 32, at most 1024); `tmp` holds 33 ints. Returns the thread's
// exclusive prefix and sets *sum to the block's total.
__device__ int block_exclusive_scan(int x, int* tmp, int* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) tmp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? tmp[lane] : 0;
    int winc = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, winc, d);
      if (lane >= d) winc += y;
    }
    tmp[lane] = winc - w;                 // exclusive prefix of warp `lane`
    if (lane == 31) tmp[32] = winc;       // the block's total
  }
  __syncthreads();
  *sum = tmp[32];
  const int out = tmp[warp] + inc - x;
  __syncthreads();                        // tmp may be reused
  return out;
}

// Sort P[0, len) ascending by payload position (P & kPos, unique), V
// alongside, with the whole block: a bitonic network whose every
// compare-exchange puts the smaller key at the lower index (the first step
// of each merge compares mirrored pairs), so the missing elements past
// `len` act as +inf and never move. Every thread of the block calls it.
__device__ void block_sort_run(uint32_t* P, float* V, int len) {
  int n2 = 1;
  while (n2 < len) n2 <<= 1;
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (n2 >> 1); i += blockDim.x) {
        const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int b = j == (k >> 1) ? (a ^ (k - 1)) : a + j;
        if (b < len) {
          const uint32_t pa = P[a], pb = P[b];
          if ((pa & kPos) > (pb & kPos)) {
            P[a] = pb;
            P[b] = pa;
            const float t = V[a];
            V[a] = V[b];
            V[b] = t;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Dynamic shared memory of a chunk block: 22,784 fixed bytes, then
// `stage` staged entries (scan route: 12 bytes each), then `cap` placed
// entries (8 bytes each).
struct Shared {
  int* cur;        // [kChunk] counts, run starts, run ends, then the sums
  uint32_t* rec;   // [kWords] the chunk's record words
  uint32_t* lng;   // [kChunk / 32] runs longer than kRunSerial
  int* tmp;        // [64] scan scratch; [40] staged count, [41] P/V base
  Key* K;          // [kSparse] the sparse path's entries, as loaded
  Key* SK;         // [kSparse] ... and sorted
  float* SV;       // [kSparse] their values, sorted
  Key* stK;        // [stage] the scan route's staged entries
  float* stV;      // [stage]
  uint32_t* P;     // [cap] position | flag of each placed entry
  float* V;        // [cap] its value
};

__device__ Shared carve(unsigned char* smem, int stage, int cap) {
  Shared s;
  s.cur = reinterpret_cast<int*>(smem);
  s.rec = reinterpret_cast<uint32_t*>(s.cur + kChunk);
  s.lng = s.rec + kWords;
  s.tmp = reinterpret_cast<int*>(s.lng + kChunk / 32);
  s.K = reinterpret_cast<Key*>(s.tmp + 64);
  s.SK = s.K + kSparse;
  s.SV = reinterpret_cast<float*>(s.SK + kSparse);
  s.stK = reinterpret_cast<Key*>(s.SV + kSparse);
  s.stV = reinterpret_cast<float*>(s.stK + stage);
  s.P = reinterpret_cast<uint32_t*>(s.stV + stage);
  s.V = reinterpret_cast<float*>(s.P + cap);
  return s;
}

__device__ __forceinline__ void zero_chunk(const Shared& sh) {
  const int t = threadIdx.x;
  int4* cur4 = reinterpret_cast<int4*>(sh.cur);
#pragma unroll
  for (int q = 0; q < kChunk / 4 / kThreads; ++q) {
    cur4[t + q * kThreads] = make_int4(0, 0, 0, 0);
  }
  if (t < kWords) sh.rec[t] = 0;
  if (t < kChunk / 32) sh.lng[t] = 0;
  if (t == 0) sh.tmp[40] = 0;
}

// The chunk's sums (the float tile over cur) and record words, written
// once with 16-byte stores; coordinates past `total` are not written.
template <typename I>
__device__ __forceinline__ void store_chunk(const Shared& sh, int chunk,
                                            I total, float* acc,
                                            int* bits) {
  const int t = threadIdx.x;
  const float4* tile = reinterpret_cast<const float4*>(sh.cur);
  float4* out = reinterpret_cast<float4*>(acc) + (long long)chunk * 1024;
#pragma unroll
  for (int q = 0; q < kChunk / 4 / kThreads; ++q) {
    const int g = t + q * kThreads;
    if ((long long)chunk * kChunk + 4 * g < total) out[g] = tile[g];
  }
  if (t < kWords / 4) {
    reinterpret_cast<int4*>(bits + (long long)chunk * kWords)[t] =
        reinterpret_cast<const int4*>(sh.rec)[t];
  }
}

// A chunk's m entries: the first `nseg` in key/val (its list segment, or
// the scan route's staging), the rest among the `nov` entries of the
// overflow region whose chunk is `chunk` (read from the key, or with
// WIDE keys from ovchunk beside it).
template <bool WIDE>
struct Entries {
  const Key* key;
  const float* val;
  int nseg;
  const Key* ovkey;
  const float* ovval;
  int nov, chunk, m;
  const int* ovchunk;

  // f(key, value) for every entry, by every thread of the block; a thread
  // loads kBatch segment entries at once
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    const int t = threadIdx.x;
    for (int i0 = t; i0 < nseg; i0 += kThreads * kBatch) {
      Key k[kBatch];
      float v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads;
        if (i < nseg) {
          k[b] = key[i];
          v[b] = val[i];
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (i0 + b * kThreads < nseg) f(k[b], v[b]);
      }
    }
    if (m > nseg) {
      for (int i = t; i < nov; i += kThreads) {
        const Key k = ovkey[i];
        if constexpr (WIDE) {
          if (ovchunk[i] == chunk) f(k, ovval[i]);
        } else {
          if (chunk_of(k) == chunk) f(k, ovval[i]);
        }
      }
    }
  }
};

__device__ __forceinline__ void set_bit(const Shared& sh, int c) {
  atomicOr(&sh.rec[c & (kWords - 1)], 1u << (c >> 7));
}

// m <= kSparse (all in the segment): thread i takes entry i's rank among
// the m keys, and the first entry of each coordinate sums its run in order
// into the tile. k, v: this thread's entry, loaded by the caller.
__device__ void sparse_chunk(const Shared& sh, int m, Key k, float v,
                             int has_div, float divisor) {
  const int t = threadIdx.x;
  if (t < m) sh.K[t] = k;
  __syncthreads();
  if (t < m) {
    const Key o = order_of(k);
    int r = 0;
    for (int j = 0; j < m; ++j) r += order_of(sh.K[j]) < o;
    sh.SK[r] = k;
    sh.SV[r] = v;
  }
  __syncthreads();
  if (t < m) {
    const int c = coord_of(sh.SK[t]);
    if (t == 0 || coord_of(sh.SK[t - 1]) != c) {
      float sum = 0.0f;
      uint32_t fl = 0;
      for (int x = t; x < m && coord_of(sh.SK[x]) == c; ++x) {
        float w = sh.SV[x];
        if (has_div) w = __fdiv_rn(w, divisor);
        sum = __fadd_rn(sum, w);
        fl |= (uint32_t)sh.SK[x] & kFlag;
      }
      reinterpret_cast<float*>(sh.cur)[c] = sum;
      if (fl) set_bit(sh, c);
    }
  }
}

// Place the entries into their coordinates' runs in P/V (shared memory or
// global scratch), order each run by position, and sum it into the tile.
// cur holds each run's start; thread t owns coordinates
// [kPer t, kPer t + kPer), whose counts are cnt[] from `start` on.
template <class E>
__device__ __forceinline__ void place_and_sum(
    const E& en, const Shared& sh, uint32_t* P, float* V,
    const int (&cnt)[kPer], int start, int has_div, float divisor) {
  const int t = threadIdx.x;
  en.each([&](Key k, float v) {
    const int slot = atomicAdd(&sh.cur[coord_of(k)], 1);
    P[slot] = (uint32_t)k;
    V[slot] = v;
  });
  // now cur[c] is the end of run c, and cur[c - 1] its start
  bool has_long = false;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (cnt[j] > kRunSerial) {
      const int c = t * kPer + j;
      atomicOr(&sh.lng[c >> 5], 1u << (c & 31));
      has_long = true;
    }
  }
  if (__syncthreads_or(has_long)) {
    for (int w = 0; w < kChunk / 32; ++w) {
      uint32_t mask = sh.lng[w];
      while (mask) {
        const int c = w * 32 + __ffs(mask) - 1;
        mask &= mask - 1;
        const int s = c ? sh.cur[c - 1] : 0;
        block_sort_run(P + s, V + s, sh.cur[c] - s);
      }
    }
  }
  // past the barrier no thread reads cur: each overwrites its own
  // coordinates with their sums
  int s = start;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = s + cnt[j];
    for (int x = s + 1; x < e; ++x) {          // insertion sort by position
      const uint32_t px = P[x];
      const float vx = V[x];
      int y = x - 1;
      while (y >= s && (P[y] & kPos) > (px & kPos)) {
        P[y + 1] = P[y];
        V[y + 1] = V[y];
        --y;
      }
      P[y + 1] = px;
      V[y + 1] = vx;
    }
    float sum = 0.0f;
    uint32_t fl = 0;
    for (int x = s; x < e; ++x) {
      float v = V[x];
      if (has_div) v = __fdiv_rn(v, divisor);
      sum = __fadd_rn(sum, v);
      fl |= P[x] & kFlag;
    }
    const int c = t * kPer + j;
    reinterpret_cast<float*>(sh.cur)[c] = sum;
    if (fl) set_bit(sh, c);
    s = e;
  }
}

// m > kSparse: a histogram of the entries by coordinate, an exclusive
// scan, then place_and_sum in shared memory when the m entries fit `cap`,
// else in global scratch: m slots of gP/gV taken from *gnext.
template <class E>
__device__ void dense_chunk(const E& en, const Shared& sh, int cap,
                            uint32_t* gP, float* gV, int* gnext,
                            int has_div, float divisor) {
  const int t = threadIdx.x;
  en.each([&](Key k, float) { atomicAdd(&sh.cur[coord_of(k)], 1); });
  if (t == 0 && en.m > cap) sh.tmp[41] = atomicAdd(gnext, en.m);
  __syncthreads();
  int cnt[kPer];
  const int4* cur4 = reinterpret_cast<const int4*>(sh.cur) + t * (kPer / 4);
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    const int4 a = cur4[q];
    cnt[4 * q] = a.x;
    cnt[4 * q + 1] = a.y;
    cnt[4 * q + 2] = a.z;
    cnt[4 * q + 3] = a.w;
  }
  int tot = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) tot += cnt[j];
  int m;
  const int start = block_exclusive_scan(tot, sh.tmp, &m);
  int run = start;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    sh.cur[t * kPer + j] = run;
    run += cnt[j];
  }
  __syncthreads();
  if (m <= cap) {
    place_and_sum(en, sh, sh.P, sh.V, cnt, start, has_div, divisor);
  } else {
    const int g = sh.tmp[41];
    place_and_sum(en, sh, gP + g, gV + g, cnt, start, has_div, divisor);
  }
}

// One chunk from its entries (cur, rec, lng zeroed and the block synced);
// k, v: the thread's segment entry t, loaded ahead for the sparse path.
template <class E, typename I>
__device__ __forceinline__ void apply_chunk(
    const E& en, Key k, float v, const Shared& sh, int cap,
    uint32_t* gP, float* gV, int* gnext, int chunk, I total, float* acc,
    int* bits, int has_div, float divisor) {
  if (en.m <= kSparse) {
    sparse_chunk(sh, en.m, k, v, has_div, divisor);
  } else {
    dense_chunk(en, sh, cap, gP, gV, gnext, has_div, divisor);
  }
  __syncthreads();
  store_chunk(sh, chunk, total, acc, bits);
}

// Route "scan": block b stages the payload's entries of chunk b in shared
// memory (at most n <= cap of them), then applies them.
template <typename I>
__global__ void __launch_bounds__(kThreads, 4)
apply_rows_scan_kernel(const I* __restrict__ idx,
                       const float* __restrict__ val,
                       const uint8_t* __restrict__ flg, I n, I total,
                       int cap, float* __restrict__ acc,
                       int* __restrict__ bits, int has_div, float divisor) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = carve(smem, cap, cap);
  const int chunk = blockIdx.x;
  zero_chunk(sh);
  __syncthreads();
  for (I i = threadIdx.x; i < n; i += kThreads) {
    const I p = idx[i];
    const float v = val[i];
    const uint8_t fl = flg[i];
    if (contributes(p, v, fl, total) && (p >> 12) == chunk) {
      const int slot = atomicAdd(&sh.tmp[40], 1);
      sh.stK[slot] = make_key(p, i, fl);
      sh.stV[slot] = v;
    }
  }
  __syncthreads();
  const int m = sh.tmp[40];
  const Entries<sizeof(I) == 8> en{sh.stK, sh.stV, m, nullptr, nullptr, 0,
                                   chunk, m, nullptr};
  const int t = threadIdx.x;
  // m <= n <= cap by the plan: the global scratch is never reached
  apply_chunk(en, t < m ? sh.stK[t] : 0, t < m ? sh.stV[t] : 0.0f, sh, cap,
              nullptr, nullptr, nullptr, chunk, total, acc, bits, has_div,
              divisor);
}

// Route "list", chunk pass: block b applies the cursor[b] entries routed
// to it, the first `seg` in its segment [b seg, b seg + seg) of the list,
// the rest in the overflow region (ctr[0] entries; the 64-bit form's
// chunk ids in ovchunk). ctr[1] hands out the global P/V scratch of
// chunks over `cap`.
template <typename I>
__global__ void __launch_bounds__(kThreads, 4)
apply_rows_kernel(const int* __restrict__ cursor, int* ctr,
                  const Key* __restrict__ key,
                  const float* __restrict__ lval, int seg,
                  const Key* __restrict__ ovkey,
                  const float* __restrict__ ovval,
                  const int* __restrict__ ovchunk, uint32_t* ovP,
                  float* ovV, int cap, I total, float* __restrict__ acc,
                  int* __restrict__ bits, int has_div, float divisor) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = carve(smem, 0, cap);
  const int chunk = blockIdx.x, t = threadIdx.x;
  const long long base = (long long)chunk * seg;
  // the count and the segment's first kSpec entries load together (read
  // before they are known to be among the m; seg >= kSparse >= kSpec), the
  // rest of a sparse chunk's once m is known
  const int m = cursor[chunk];
  Key k = 0;
  float v = 0.0f;
  if (t < kSpec) {
    k = key[base + t];
    v = lval[base + t];
  }
  zero_chunk(sh);
  if (t >= kSpec && t < min(m, kSparse)) {
    k = key[base + t];
    v = lval[base + t];
  }
  __syncthreads();
  const Entries<sizeof(I) == 8> en{key + base, lval + base, min(m, seg),
                                   ovkey, ovval, m > seg ? ctr[0] : 0,
                                   chunk, m, ovchunk};
  apply_chunk(en, k, v, sh, cap, ovP, ovV, &ctr[1], chunk, total, acc, bits,
              has_div, divisor);
}

// Warp-aggregated slot: the lanes holding the same key take consecutive
// slots of ctr[key] with one atomic. Every lane of the warp calls it.
__device__ __forceinline__ int warp_slot(int* ctr, int key, bool ok) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, ok ? key : -1);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (ok && lane == leader) base = atomicAdd(&ctr[key], __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// Write a routed entry to slot `slot` of its chunk's segment, or, past the
// segment's `seg` slots, to the overflow region (ctr[0] counts it). A
// WIDE key carries no chunk: `chunk` gives it, and the overflow keeps it
// in ovchunk.
template <bool WIDE>
__device__ __forceinline__ void put(Key k, float v, int slot, int seg,
                                    Key* key, float* lval, int* ctr,
                                    Key* ovkey, float* ovval, int* ovchunk,
                                    int chunk) {
  if constexpr (!WIDE) chunk = chunk_of(k);
  if (slot < seg) {
    const long long at = (long long)chunk * seg + slot;
    key[at] = k;
    lval[at] = v;
  } else {
    const int at = atomicAdd(&ctr[0], 1);
    ovkey[at] = k;
    ovval[at] = v;
    if constexpr (WIDE) ovchunk[at] = chunk;
  }
}

// A staged entry of a route tile: its key, value and slot in its chunk.
struct Staged {
  Key key;
  float val;
  int slot;
};

// The list route's scatter, a tile of kTile payload entries at a time,
// each thread's kItems loaded at once: every contributing entry takes the
// next slot of its chunk from cursor[] and is written there. With at most
// kHistMax chunks the tile is counted per chunk in shared memory first
// (one global atomic per chunk the tile touches) and ordered by chunk, so
// the list is written in runs of consecutive slots; above (and always in
// the 64-bit form), each warp makes one atomic per chunk its lanes touch
// and writes where it stands.
template <typename I>
__global__ void __launch_bounds__(kRouteThreads)
apply_rows_route_kernel(const I* __restrict__ idx,
                        const float* __restrict__ val,
                        const uint8_t* __restrict__ flg, I n, I total,
                        I nchunks, int seg, int* __restrict__ cursor,
                        int* ctr, Key* __restrict__ key,
                        float* __restrict__ lval, Key* __restrict__ ovkey,
                        float* __restrict__ ovval, int* __restrict__ ovchunk) {
  constexpr bool kWide = sizeof(I) == 8;
  extern __shared__ __align__(16) unsigned char rsm[];
  int* hist = reinterpret_cast<int*>(rsm);          // [nchunks]
  int* gbase = hist + nchunks;                      // [nchunks]
  Staged* stage = reinterpret_cast<Staged*>(
      rsm + ((8 * (size_t)nchunks + 15) & ~(size_t)15));   // [kTile]
  __shared__ int tmp[33];
  const int t = threadIdx.x;
  const bool shared_hist = !kWide && nchunks <= kHistMax;
  // the shared histogram's chunk count (the 32-bit form's, at most
  // kHistMax where it is used)
  const int nch = (int)nchunks;
  for (long long t0 = (long long)blockIdx.x * kTile; t0 < n;
       t0 += (long long)gridDim.x * kTile) {
    I p[kItems];
    float v[kItems];
    uint8_t fl[kItems];
#pragma unroll
    for (int b = 0; b < kItems; ++b) {
      const long long i = t0 + b * kRouteThreads + t;
      p[b] = -1;
      if (i < n) {
        p[b] = idx[i];
        v[b] = val[i];
        fl[b] = flg[i];
      }
    }
#pragma unroll
    for (int b = 0; b < kItems; ++b) {
      if (p[b] >= 0 && !contributes(p[b], v[b], fl[b], total)) p[b] = -1;
    }
    if (!shared_hist) {
#pragma unroll
      for (int b = 0; b < kItems; ++b) {
        const int c = (int)(p[b] >> 12);
        const int slot = warp_slot(cursor, c, p[b] >= 0);
        if (p[b] >= 0) {
          put<kWide>(make_key(p[b], t0 + b * kRouteThreads + t, fl[b]), v[b],
                     slot, seg, key, lval, ctr, ovkey, ovval, ovchunk, c);
        }
      }
      continue;
    }
    for (int c = t; c < nch; c += kRouteThreads) hist[c] = 0;
    __syncthreads();
    int r[kItems];
#pragma unroll
    for (int b = 0; b < kItems; ++b) {
      if (p[b] >= 0) r[b] = atomicAdd(&hist[p[b] >> 12], 1);
    }
    __syncthreads();
    for (int c = t; c < nch; c += kRouteThreads) {
      const int h = hist[c];
      if (h) gbase[c] = atomicAdd(&cursor[c], h);
    }
    // the tile's chunks' offsets in the tile, in place of their counts
    const int per = (nch + kRouteThreads - 1) / kRouteThreads;
    const int lo = t * per, hi = min(lo + per, nch);
    int tot = 0;
    for (int c = lo; c < hi; ++c) tot += hist[c];
    int m;
    int run = block_exclusive_scan(tot, tmp, &m);
    for (int c = lo; c < hi; ++c) {
      const int h = hist[c];
      hist[c] = run;
      run += h;
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < kItems; ++b) {
      if (p[b] >= 0) {
        const int c = p[b] >> 12;
        stage[hist[c] + r[b]] = Staged{
            make_key(p[b], t0 + b * kRouteThreads + t, fl[b]), v[b],
            gbase[c] + r[b]};
      }
    }
    __syncthreads();
    for (int j = t; j < m; j += kRouteThreads) {
      const Staged e = stage[j];
      put<false>(e.key, e.val, e.slot, seg, key, lval, ctr, ovkey, ovval,
                 nullptr, 0);
    }
    __syncthreads();
  }
}

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

cudaError_t set_smem(const void* kern, int bytes, int* done) {
  if (bytes <= *done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = bytes;
  return err;
}

// The launches of one instantiation (see apply_rows_launch below); each
// instantiation keeps its own record of the shared memory it has set.
template <typename I>
cudaError_t launch(const I* idx, const uint8_t* flags, const float* val,
                   I n, float* acc, int* bits, I total, int has_div,
                   float divisor, int route, I nchunks, int cap, int smem,
                   int route_grid, void* scratch, int device,
                   cudaStream_t st) {
  constexpr bool kWide = sizeof(I) == 8;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nchunks == 0) return cudaSuccess;
  static int smem_set[3] = {0, 0, 0};
  if (route == 0) {
    err = set_smem((const void*)&apply_rows_scan_kernel<I>, smem,
                   &smem_set[0]);
    if (err != cudaSuccess) return err;
    apply_rows_scan_kernel<I><<<(unsigned)nchunks, kThreads, smem, st>>>(
        idx, val, flags, n, total, cap, acc, bits, has_div, divisor);
    return cudaGetLastError();
  }
  const size_t slots = (size_t)nchunks * cap;
  unsigned char* s = static_cast<unsigned char*>(scratch);
  int* cursor = reinterpret_cast<int*>(s);
  int* ctr = cursor + nchunks;
  s += align16(sizeof(int) * (nchunks + 2));
  Key* key = reinterpret_cast<Key*>(s);
  s += align16(sizeof(Key) * slots);
  float* lval = reinterpret_cast<float*>(s);
  s += align16(sizeof(float) * slots);
  Key* ovkey = reinterpret_cast<Key*>(s);
  s += align16(sizeof(Key) * n);
  float* ovval = reinterpret_cast<float*>(s);
  s += align16(sizeof(float) * n);
  uint32_t* ovP = reinterpret_cast<uint32_t*>(s);
  s += align16(sizeof(uint32_t) * n);
  float* ovV = reinterpret_cast<float*>(s);
  int* ovchunk = nullptr;
  if constexpr (kWide) {
    s += align16(sizeof(float) * n);
    ovchunk = reinterpret_cast<int*>(s);
  }
  const int route_smem =
      !kWide && nchunks <= kHistMax
          ? (int)align16(8 * (size_t)nchunks) + (int)sizeof(Staged) * kTile
          : 0;
  if ((err = set_smem((const void*)&apply_rows_kernel<I>, smem,
                      &smem_set[1])) ||
      (err = set_smem((const void*)&apply_rows_route_kernel<I>, route_smem,
                      &smem_set[2])))
    return err;
  err = cudaMemsetAsync(cursor, 0, sizeof(int) * (nchunks + 2), st);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    apply_rows_route_kernel<I>
        <<<route_grid, kRouteThreads, route_smem, st>>>(
            idx, val, flags, n, total, nchunks, cap, cursor, ctr, key, lval,
            ovkey, ovval, ovchunk);
  }
  apply_rows_kernel<I><<<(unsigned)nchunks, kThreads, smem, st>>>(
      cursor, ctr, key, lval, cap, ovkey, ovval, ovchunk, ovP, ovV, cap,
      total, acc, bits, has_div, divisor);
  return cudaGetLastError();
}

}  // namespace

// idx, flags (bool as uint8), values: the payload, [n]. acc: [total] f32 and
// bits: [nchunks * 128] int32, written whole (no initialisation needed).
// route 0 = scan, 1 = list; cap: entries of a chunk kept in shared memory,
// and the list route's segment of each chunk; smem: dynamic shared bytes of
// a chunk block; route_grid: blocks of the list route's scatter; scratch:
// the list route's scratch, laid out as cursor [nchunks] i32 and two
// counters, key [nchunks * cap] u64, value [nchunks * cap] f32, overflow
// key [n] u64, value [n] f32, P [n] u32, V [n] f32 (and for the 64-bit
// form the overflow's chunk ids [n] i32), each start 16-byte aligned (the
// wrapper sizes it with the same layout). Returns the CUDA error code (0 =
// launched).
extern "C" int apply_rows_launch(const int* idx, const uint8_t* flags,
                                 const float* val, int n, float* acc,
                                 int* bits, int total, int has_div,
                                 float divisor, int route, int nchunks,
                                 int cap, int smem, int route_grid,
                                 void* scratch, int device, void* stream) {
  return (int)launch<int>(idx, flags, val, n, acc, bits, total, has_div,
                          divisor, route, nchunks, cap, smem, route_grid,
                          scratch, device, (cudaStream_t)stream);
}

// The 64-bit instantiation: int64 indices and a 64-bit n, total and chunk
// count (a buffer of 2**31 coordinates or more); the rest as above.
extern "C" int apply_rows_launch64(const long long* idx,
                                   const uint8_t* flags, const float* val,
                                   long long n, float* acc, int* bits,
                                   long long total, int has_div,
                                   float divisor, int route,
                                   long long nchunks, int cap, int smem,
                                   int route_grid, void* scratch, int device,
                                   void* stream) {
  return (int)launch<long long>(idx, flags, val, n, acc, bits, total,
                                has_div, divisor, route, nchunks, cap, smem,
                                route_grid, scratch, device,
                                (cudaStream_t)stream);
}
