// The selection core of the row kernels (topk_rows.cu, select_pack_rows.cu,
// dgc_forward_rows.cu): the k largest order keys of a row, in lax.top_k
// order, for Hopper (sm_90a), and select_rows(), the body the three kernels
// share, over a row policy (see there).
//
// A block owns a row, or, in a thread-block cluster, each block owns a
// slice of one row. Its keys are read from shared memory where the row was
// staged once (or from global memory where it does not fit), and:
//   1. radix_select(): the k-th largest key, four 8-bit digit passes. Each
//      pass builds a 256-bin histogram of the keys that share the digits
//      chosen so far (a shared atomic per key: measured faster than one per
//      distinct digit of a warp through __match_any_sync), while it clears
//      the next pass's (three alternating histograms, so a pass waits on
//      two barriers); in a cluster, every block sums the blocks' histograms
//      through distributed shared memory, one bin a thread. One warp then
//      picks the digit in parallel: each lane owns 8 bins, a shuffle scan
//      gives each lane the count above its bins, and the one lane whose
//      bins hold the k-th key walks its 8 bins.
//   2. collect(): every key above the k-th, plus the first (k - #greater)
//      keys equal to it in column order, as 64-bit words
//      (~key << 32) | column. Each warp owns a contiguous column range
//      and walks it 32 columns at a time; ballots give the ranks inside a
//      step, a scan over the warps (and over the cluster's blocks) gives
//      each warp its first slot, so the slots follow column order and the
//      result is the same from run to run.
//   3. sort_words(): the k words ascending (key descending, column
//      ascending). Large k (2,048 words and more): a stable LSD radix sort
//      by key, four 8-bit passes through a global scratch buffer (see
//      radix_sort_words). Smaller: a bitonic sort padded to a power of
//      two with ~0. Each
//      sorting thread holds E = 2, 4 or 8 consecutive words in registers
//      (a chunk; a 16,384-word sort by 1,024 threads takes two chunks a
//      thread in turn): a stage whose partner is in the same thread is a
//      register compare, one in another lane of the warp a shuffle, and
//      only the stages whose partner is in another warp go through shared
//      memory (28 of the 105 stages of a 16,384-word sort); up to 32
//      words, one warp sorts in registers alone.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

namespace cg = cooperative_groups;

// Order-preserving uint32 key of a float's bits; -0.0 first becomes +0.0,
// so equal floats tie and break by column, as lax.top_k does.
__device__ __forceinline__ uint32_t order_key(uint32_t u) {
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The sort word of a key and its column: ascending words run key
// descending, then column ascending.
__device__ __forceinline__ unsigned long long make_word(uint32_t key,
                                                       int col) {
  return ((unsigned long long)(~key) << 32) | (uint32_t)col;
}

// Where word i of the sort buffer lives: one pad word after every 16, so
// that a warp's 8-byte accesses at a stride of 2, 4 or 8 words (a chunk of
// the register sort each) fall in distinct banks. The buffer of `padded`
// words takes padded + padded / 16.
__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// The shared scratch of a block, at the head of its shared memory.
struct Scratch {
  uint32_t hist[3][256];    // radix histograms, rotating by pass
  uint32_t total[256];      // a cluster's summed histogram
  uint32_t warp_gt[32];     // per-warp counts, then exclusive bases
  uint32_t warp_eq[32];
  uint32_t blk_gt, blk_eq;  // the block's totals (read by later blocks)
  uint32_t prefix, remaining;
};
constexpr int kScratchBytes = 4368;
static_assert(sizeof(Scratch) == kScratchBytes, "planner's scratch size");

// The threads of a block (a multiple of 32): a block of one warp waits on
// __syncwarp, a larger one on __syncthreads.
struct Group {
  int rank, size;
  __device__ __forceinline__ void sync() const {
    if (size == 32) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
};

template <bool CLUSTER>
__device__ __forceinline__ void wide_sync(const Group& g) {
  if constexpr (CLUSTER) {
    cg::this_cluster().sync();
  } else {
    g.sync();
  }
}

// Clears the first pass's histogram; before the block's (and the
// cluster's) first synchronisation.
__device__ __forceinline__ void clear_first_histogram(Scratch& s,
                                                      const Group& g) {
  for (int i = g.rank; i < 256; i += g.size) s.hist[0][i] = 0u;
}

// Step 1. key_at(c) is the order key of column c of this block's n
// columns. Leaves in (prefix, remaining) the k-th largest key of the row
// (of every block's slice together, in a cluster) and how many keys equal
// to it are taken.
template <bool CLUSTER, typename KeyAt>
__device__ void radix_select(KeyAt key_at, int n, uint32_t k, Scratch& s,
                             const Group& g, uint32_t& prefix_out,
                             uint32_t& remaining_out) {
  const int lane = g.rank & 31;
  uint32_t prefix = 0u, mask = 0u, remaining = k;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    uint32_t* hist = s.hist[pass % 3];
    // the next pass's histogram was last read (in a cluster, by every
    // block) before the previous pass's barriers
    for (int i = g.rank; i < 256; i += g.size) s.hist[(pass + 1) % 3][i] = 0u;
    for (int c = g.rank; c < n; c += g.size) {
      const uint32_t key = key_at(c);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xFFu], 1u);
    }
    wide_sync<CLUSTER>(g);
    const uint32_t* bins = hist;
    if constexpr (CLUSTER) {
      cg::cluster_group cl = cg::this_cluster();
      const unsigned nb = cl.num_blocks();
      for (int b = g.rank; b < 256; b += g.size) {
        uint32_t v = 0u;
#pragma unroll
        for (unsigned r = 0; r < 8; ++r)
          if (r < nb) v += cl.map_shared_rank(hist, r)[b];
        s.total[b] = v;
      }
      g.sync();
      bins = s.total;
    }
    if (g.rank < 32) {
      uint32_t h[8], tot = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        h[j] = bins[lane * 8 + j];
        tot += h[j];
      }
      uint32_t suf = tot;  // keys in this lane's bins and every higher one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += y;
      }
      const uint32_t above = suf - tot;
      if (above < remaining && remaining <= suf) {  // exactly one lane
        uint32_t a = above;
        int j = 7;
        for (; j > 0; --j) {
          if (a + h[j] >= remaining) break;
          a += h[j];
        }
        s.prefix = prefix | ((uint32_t)(lane * 8 + j) << shift);
        s.remaining = remaining - a;
      }
    }
    g.sync();
    prefix = s.prefix;
    remaining = s.remaining;
    mask |= 0xFFu << shift;
  }
  prefix_out = prefix;
  remaining_out = remaining;
}

// Step 2: writes the k survivors' words to words [0, k) of buf (see
// slot(); in a cluster, buf is the sorting block's buffer, mapped). col0 is
// the row column of this block's column 0.
template <bool CLUSTER, typename KeyAt>
__device__ void collect(KeyAt key_at, int n, int col0, uint32_t k,
                        uint32_t prefix, uint32_t remaining,
                        unsigned long long* buf, Scratch& s, const Group& g) {
  const int lane = g.rank & 31, w = g.rank >> 5, nw = g.size >> 5;
  const int per = (n + 32 * nw - 1) / (32 * nw) * 32;
  const int c0 = min(w * per, n), c1 = min(c0 + per, n);
  const int cend = c0 + ((c1 - c0 + 31) & ~31);
  uint32_t n_gt = 0u, n_eq = 0u;
  for (int b = c0; b < cend; b += 32) {
    const int c = b + lane;
    const uint32_t key = c < c1 ? key_at(c) : 0u;
    n_gt += __popc(__ballot_sync(0xffffffffu, c < c1 && key > prefix));
    n_eq += __popc(__ballot_sync(0xffffffffu, c < c1 && key == prefix));
  }
  if (lane == 0) {
    s.warp_gt[w] = n_gt;
    s.warp_eq[w] = n_eq;
  }
  g.sync();
  if (g.rank < 32) {
    const uint32_t a = lane < nw ? s.warp_gt[lane] : 0u;
    const uint32_t e = lane < nw ? s.warp_eq[lane] : 0u;
    uint32_t ia = a, ie = e;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t ya = __shfl_up_sync(0xffffffffu, ia, o);
      const uint32_t ye = __shfl_up_sync(0xffffffffu, ie, o);
      if (lane >= o) {
        ia += ya;
        ie += ye;
      }
    }
    if (lane < nw) {
      s.warp_gt[lane] = ia - a;
      s.warp_eq[lane] = ie - e;
    }
    if (lane == 31) {
      s.blk_gt = ia;
      s.blk_eq = ie;
    }
  }
  uint32_t base_gt = 0u, base_eq = 0u;
  if constexpr (CLUSTER) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    for (unsigned r = 0; r < cl.block_rank(); ++r) {
      const Scratch* o = cl.map_shared_rank(&s, r);
      base_gt += o->blk_gt;
      base_eq += o->blk_eq;
    }
  } else {
    g.sync();
  }
  const uint32_t n_greater = k - remaining;
  uint32_t gt_slot = base_gt + s.warp_gt[w];
  uint32_t eq_rank = base_eq + s.warp_eq[w];
  const unsigned below = (1u << lane) - 1u;
  for (int b = c0; b < cend; b += 32) {
    const int c = b + lane;
    const uint32_t key = c < c1 ? key_at(c) : 0u;
    const bool gt = c < c1 && key > prefix, eq = c < c1 && key == prefix;
    const unsigned mg = __ballot_sync(0xffffffffu, gt);
    const unsigned me = __ballot_sync(0xffffffffu, eq);
    const unsigned long long word = make_word(key, col0 + c);
    if (gt) buf[slot(gt_slot + __popc(mg & below))] = word;
    if (eq) {
      const uint32_t r = eq_rank + __popc(me & below);
      if (r < remaining) buf[slot(n_greater + r)] = word;
    }
    gt_slot += __popc(mg);
    eq_rank += __popc(me);
  }
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                    unsigned long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                    unsigned long long b) {
  return a < b ? b : a;
}

// The bitonic stages whose partners are in other warps, on buf in shared
// memory (all the block's threads; each stage ends with the block
// synchronised). Returns the first stride left.
__device__ __forceinline__ int shared_stages(unsigned long long* buf,
                                             int padded, int size,
                                             int stride, int min_stride,
                                             const Group& g) {
  for (; stride >= min_stride; stride >>= 1) {
    for (int i = g.rank; i < (padded >> 1); i += g.size) {
      const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
      const unsigned long long a = buf[slot(lo)], b = buf[slot(hi)];
      if ((a > b) == ((lo & size) == 0)) {
        buf[slot(lo)] = b;
        buf[slot(hi)] = a;
      }
    }
    g.sync();
  }
  return stride;
}

// The stages of one size of the bitonic sort whose partners are in this
// warp, from `stride` (< 32 * E) down, on the E words w of chunk c (words
// c * E ..): in other lanes by shuffles, then in this thread.
template <int E>
__device__ __forceinline__ void register_stages(unsigned long long (&w)[E],
                                                int c, int size,
                                                int stride) {
  for (; stride >= E; stride >>= 1) {
    const int lanes = stride / E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = c * E + e;
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, w[e], lanes);
      w[e] = (((i & stride) == 0) == ((i & size) == 0)) ? umin64(w[e], o)
                                                        : umax64(w[e], o);
    }
  }
#pragma unroll
  for (int st = E / 2; st > 0; st >>= 1) {
    if (st < size) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((e & st) == 0) {
          const bool up = ((c * E + e) & size) == 0;
          const unsigned long long a = w[e], b = w[e + st];
          w[e] = up ? umin64(a, b) : umax64(a, b);
          w[e + st] = up ? umax64(a, b) : umin64(a, b);
        }
      }
    }
  }
}

// The bitonic sort of buf[0..padded): S = min(block, padded / E) threads
// (a multiple of 32) each take V = padded / (S * E) chunks of E
// consecutive words. With one chunk a thread, the words stay in registers
// from size to size; with more, each size loads and stores every chunk.
template <int E>
__device__ void sort_registers(unsigned long long* buf, int padded,
                               const Group& g) {
  const int S = min(g.size, padded / E), V = padded / (S * E);
  const int t = g.rank;
  const bool sorter = t < S;
  unsigned long long w[E];
  if (V == 1) {
    if (sorter) {
#pragma unroll
      for (int e = 0; e < E; ++e) w[e] = buf[slot(t * E + e)];
    }
    for (int size = 2; size <= padded; size <<= 1) {
      int stride = size >> 1;
      if (stride >= 32 * E) {             // partners in other warps
        if (sorter) {
#pragma unroll
          for (int e = 0; e < E; ++e) buf[slot(t * E + e)] = w[e];
        }
        g.sync();
        stride = shared_stages(buf, padded, size, stride, 32 * E, g);
        if (sorter) {
#pragma unroll
          for (int e = 0; e < E; ++e) w[e] = buf[slot(t * E + e)];
        }
      }
      if (sorter) register_stages<E>(w, t, size, stride);
    }
    if (sorter) {
#pragma unroll
      for (int e = 0; e < E; ++e) buf[slot(t * E + e)] = w[e];
    }
    g.sync();
    return;
  }
  for (int size = 2; size <= padded; size <<= 1) {
    const int stride = shared_stages(buf, padded, size, size >> 1, 32 * E, g);
    if (sorter) {
      for (int v = 0; v < V; ++v) {
        const int c = v * S + t;
#pragma unroll
        for (int e = 0; e < E; ++e) w[e] = buf[slot(c * E + e)];
        register_stages<E>(w, c, size, stride);
#pragma unroll
        for (int e = 0; e < E; ++e) buf[slot(c * E + e)] = w[e];
      }
    }
    g.sync();
  }
}

// The stable LSD radix sort of words [0, n) of buf by their high 32 bits
// (the keys; words of equal keys keep their order, which collect() leaves
// in column order): four 8-bit passes, buf -> tmp -> buf -> tmp -> buf,
// tmp being n words of global scratch (L2-resident). Each warp owns a
// contiguous range of the words: it counts its digits into 256 counters
// of its own (hist: the block's warps x 256), one scan over (digit, warp)
// gives each warp its first slot for each digit, and the warp then places
// its words 32 at a time in order, ranked among equal digits by
// __match_any_sync. digit_base holds 256 counters. Ends with the block
// synchronised.
__device__ void radix_sort_words(unsigned long long* buf,
                                 unsigned long long* tmp, int n,
                                 uint32_t* hist, uint32_t* digit_base,
                                 const Group& g) {
  const int lane = g.rank & 31, w = g.rank >> 5, nw = g.size >> 5;
  const int per = (n + 32 * nw - 1) / (32 * nw) * 32;
  const int c0 = min(w * per, n), c1 = min(c0 + per, n);
  const int cend = c0 + ((c1 - c0 + 31) & ~31);
  uint32_t* mine = hist + 256 * w;
  const unsigned below = (1u << lane) - 1u;
  for (int pass = 0; pass < 4; ++pass) {
    const bool from_buf = (pass & 1) == 0;
    const int shift = 32 + 8 * pass;
    auto load = [&](int c) { return from_buf ? buf[slot(c)] : tmp[c]; };
    for (int i = lane; i < 256; i += 32) mine[i] = 0u;
    __syncwarp();
    for (int c = c0 + lane; c < c1; c += 32)
      atomicAdd(&mine[(uint32_t)(load(c) >> shift) & 0xFFu], 1u);
    g.sync();
    for (int d = g.rank; d < 256; d += g.size) {  // warps in order
      uint32_t sum = 0u;
      for (int v = 0; v < nw; ++v) {
        const uint32_t h = hist[256 * v + d];
        hist[256 * v + d] = sum;
        sum += h;
      }
      digit_base[d] = sum;
    }
    g.sync();
    if (g.rank < 32) {  // digits in order
      uint32_t t[8], sum = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        t[j] = digit_base[lane * 8 + j];
        sum += t[j];
      }
      uint32_t inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      uint32_t run = inc - sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        digit_base[lane * 8 + j] = run;
        run += t[j];
      }
    }
    g.sync();
    for (int b = c0; b < cend; b += 32) {
      const int c = b + lane;
      const bool valid = c < c1;
      const unsigned act = __ballot_sync(0xffffffffu, valid);
      unsigned long long x = 0ull;
      uint32_t d = 0u, base = 0u;
      unsigned peers = 0u;
      if (valid) {
        x = load(c);
        d = (uint32_t)(x >> shift) & 0xFFu;
        peers = __match_any_sync(act, d);
        base = mine[d];
      }
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) mine[d] = base + __popc(peers);
      __syncwarp();
      if (valid) {
        const int pos = (int)(digit_base[d] + base + __popc(peers & below));
        if (from_buf) {
          tmp[pos] = x;
        } else {
          buf[slot(pos)] = x;
        }
      }
    }
    g.sync();
  }
}

// Step 3: sorts buf[0..k) ascending; buf holds `padded` words (a power of
// two >= k; [k, padded) is overwritten). With tmp (k words of global
// scratch), hist and digit_base, by radix_sort_words(), else by a bitonic
// sort. Ends with the block synchronised.
__device__ void sort_words(unsigned long long* buf, int k, int padded,
                           const Group& g, unsigned long long* tmp = nullptr,
                           uint32_t* hist = nullptr,
                           uint32_t* digit_base = nullptr) {
  if (tmp != nullptr) {
    g.sync();
    radix_sort_words(buf, tmp, k, hist, digit_base, g);
    return;
  }
  for (int i = k + g.rank; i < padded; i += g.size) buf[slot(i)] = ~0ull;
  g.sync();
  if (padded <= 32) {
    if (g.rank < 32) {
      const int lane = g.rank;
      unsigned long long w = lane < padded ? buf[slot(lane)] : ~0ull;
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, w, stride);
          w = (((lane & stride) == 0) == ((lane & size) == 0)) ? umin64(w, o)
                                                               : umax64(w, o);
        }
      }
      if (lane < k) buf[slot(lane)] = w;
    }
    g.sync();
    return;
  }
  const int per = padded / min(g.size, padded >> 1);  // words a thread
  if (per == 2) {
    sort_registers<2>(buf, padded, g);
  } else if (per == 4) {
    sort_registers<4>(buf, padded, g);
  } else {
    sort_registers<8>(buf, padded, g);
  }
}

// ---------------------------------------------------------------------
// The row kernels' body, and what the kernels share around it.

// A row kernel's geometry, from kernels.topk_plan: each row of `cols`
// columns gives k (0 < k <= cols) outputs; on the cluster route a block
// takes `slice` columns (a multiple of 4); a staged block holds
// `stage_words` words of its slice; the sort buffer holds `padded` words;
// `sort_all`: every column's word is sorted (the "sort" route).
struct Rows {
  int cols, k, slice, stage_words, padded, sort_all;
};

// Stages n floats from src (a row's slice in global memory, read through
// the read-only path) into stage: the 16-byte granules that cover them,
// so that a granule partly outside the row cannot fault. Returns where
// src[0] lands in stage (0-3 words).
__device__ __forceinline__ int stage_granules(const float* src, int n,
                                              uint32_t* stage,
                                              const Group& g) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int off = (int)((a & 15u) >> 2);
  const float4* s4 = reinterpret_cast<const float4*>(a - 4u * off);
  float4* dst = reinterpret_cast<float4*>(stage);
  const int nvec = (off + n + 3) >> 2;
  for (int i = g.rank; i < nvec; i += g.size) dst[i] = __ldg(s4 + i);
  return off;
}

// The body of a row kernel (a block a row, or a cluster of blocks a row
// on the cluster route): the k largest keys of row blockIdx.x (over the
// cluster's blocks, row blockIdx.x / cluster size), each handed to the
// policy in lax.top_k order. Shared memory: the Scratch, the stage, the
// sort buffer, then the radix sort's counters (kernels.topk_geometry
// sizes it). tmp: this launch's radix-sort scratch, or null for the
// bitonic sort.
//
// The row policy P says four things:
//   - how a block prepares its slice: P::stage(col0, n, stage, g) puts the
//     bits of row columns [col0, col0 + n) into shared memory and returns
//     where column col0 lands (called on the staged routes only);
//   - the order key of row column c, from the bits of its float:
//     P::key(bits, c);
//   - what is written for a selected column: P::emit(o, c, v, key),
//     output slot o (row r's j-th is r * k + j), row column c, its float
//     v and its order key;
//   - whether the values may be read through __ldg (P::kLdg, with
//     P::values() the row in global memory). A policy that writes the
//     values in this launch may not: it is always staged at offset 0 (its
//     slices are 16-byte aligned), and on the cluster route the sorting
//     block reads other blocks' values from their stages through
//     distributed shared memory, so every block stays until a last
//     cluster barrier.
// P::begin(r, cols) first points the policy at row r.
template <bool CLUSTER, bool STAGED, typename P>
__device__ __forceinline__ void select_rows(P p, unsigned long long* tmp,
                                            Rows geo) {
  static_assert(STAGED || P::kLdg, "an unstaged row is read through __ldg");
  extern __shared__ __align__(16) unsigned char smem[];
  const Group g{(int)threadIdx.x, (int)blockDim.x};
  const int cols = geo.cols, k = geo.k, padded = geo.padded;
  int row = blockIdx.x, col0 = 0, n = cols;
  if constexpr (CLUSTER) {
    cg::cluster_group cl = cg::this_cluster();
    row = blockIdx.x / cl.num_blocks();
    col0 = (int)cl.block_rank() * geo.slice;
    n = max(0, min(geo.slice, cols - col0));
  }
  Scratch& s = *reinterpret_cast<Scratch*>(smem);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + sizeof(Scratch));
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(
      smem + sizeof(Scratch) + 4 * (size_t)geo.stage_words);
  // the radix sort's per-warp digit counters follow the sort buffer
  uint32_t* hist = reinterpret_cast<uint32_t*>(buf + padded + padded / 16);
  if (tmp != nullptr) tmp += (size_t)row * padded;
  p.begin(row, cols);

  clear_first_histogram(s, g);
  const uint32_t* keys;  // the bits of the slice's column c at keys[c]
  if constexpr (STAGED) {
    keys = stage + p.stage(col0, n, stage, g);
  } else {
    keys = reinterpret_cast<const uint32_t*>(p.values() + col0);
  }
  g.sync();
  auto key_at = [&p, keys, col0](int c) {
    if constexpr (STAGED) {
      return p.key(keys[c], col0 + c);
    } else {
      return p.key(__ldg(keys + c), col0 + c);
    }
  };

  if (CLUSTER || !geo.sort_all) {
    uint32_t prefix, remaining;
    radix_select<CLUSTER>(key_at, n, (uint32_t)k, s, g, prefix, remaining);
    unsigned long long* dst = buf;
    if constexpr (CLUSTER) dst = cg::this_cluster().map_shared_rank(buf, 0);
    collect<CLUSTER>(key_at, n, col0, (uint32_t)k, prefix, remaining, dst, s,
                     g);
    if constexpr (CLUSTER) {
      // the survivors are in block 0's buffer, and no block reads another's
      // scratch or buffer after this
      cg::this_cluster().sync();
      if (cg::this_cluster().block_rank() != 0) {
        // block 0 reads the values from this block's stage
        if constexpr (!P::kLdg) cg::this_cluster().sync();
        return;
      }
    } else {
      g.sync();
    }
    sort_words(buf, k, padded, g, tmp, hist, s.total);
  } else {  // a narrow row: every column's word, sorted
    for (int c = g.rank; c < n; c += g.size)
      buf[slot(c)] = make_word(key_at(c), c);
    sort_words(buf, n, padded, g);
  }

  const size_t o = (size_t)row * k;
  for (int j = g.rank; j < k; j += g.size) {
    const unsigned long long word = buf[slot(j)];
    const int c = (int)(uint32_t)word;
    float v;
    if constexpr (STAGED && !CLUSTER) {
      v = __uint_as_float(keys[c]);
    } else if constexpr (P::kLdg) {
      v = __ldg(p.values() + c);
    } else {  // from the owner block's stage
      const int owner = c / geo.slice;
      v = __uint_as_float(cg::this_cluster().map_shared_rank(
          stage, owner)[c - owner * geo.slice]);
    }
    p.emit(o + j, c, v, ~(uint32_t)(word >> 32));
  }
  if constexpr (CLUSTER && !P::kLdg) cg::this_cluster().sync();
}

// The part of a row policy over a read-only [rows, cols] input x: the
// values may be read through __ldg, and a block stages its slice as it is.
struct ReadRows {
  static constexpr bool kLdg = true;
  const float* x;
  const float* row;  // the current row of x
  __device__ __forceinline__ void begin(int r, int cols) {
    row = x + (size_t)r * cols;
  }
  __device__ __forceinline__ const float* values() const { return row; }
  __device__ __forceinline__ int stage(int col0, int n, uint32_t* st,
                                       const Group& g) const {
    return stage_granules(row + col0, n, st, g);
  }
};

// The order key of the importance -1.0f (order_key(0xBF800000)), which the
// select-and-pack rows give the columns past a row's numel.
constexpr uint32_t kTailKey = ~0xBF800000u;

// The select-and-pack rows' keys and outputs (select_pack_rows.cu,
// dgc_forward_rows.cu): the importance of row column c is |x| for c below
// the row's numels[r], else -1; a selected column is written as its
// importance (the score), its value + 0.0f (a selected -0.0 is written
// +0.0, as the Pallas kernels' one-hot masked sum reads it) and its
// column. The score comes from the key (the key of |x| has its top bit
// set, the tail's not), so numel is dead once the keys are taken.
struct PackRows {
  const int* numels;
  float* out_s;
  float* out_v;
  int* out_i;
  int numel;  // of the current row
  __device__ __forceinline__ void begin_row(int r) { numel = numels[r]; }
  __device__ __forceinline__ uint32_t key(uint32_t bits, int c) const {
    return c < numel ? order_key(bits & 0x7fffffffu) : kTailKey;
  }
  __device__ __forceinline__ void emit(size_t o, int c, float v,
                                       uint32_t key) const {
    out_s[o] = (key & 0x80000000u) ? fabsf(v) : -1.0f;
    out_v[o] = __fadd_rn(v, 0.0f);
    out_i[o] = c;
  }
};

constexpr int kMaxDevices = 64;

// Makes `device` the current device (the launch functions' first step).
inline cudaError_t use_device(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

// Launches kernel(args...) over `grid` blocks of `threads` with `smem`
// bytes of dynamic shared memory, in clusters of `cluster` blocks where
// cluster > 1. smem_set is the dynamic shared memory the kernel may use on
// this device so far, raised only where it is short (cudaFuncSetAttribute
// is not free). Returns the launch's error code.
template <typename... Params, typename... Args>
cudaError_t launch_rows(void (*kernel)(Params...), int& smem_set, int grid,
                        int threads, int cluster, int smem,
                        cudaStream_t stream, Args... args) {
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace topk
