// Exact per-row selection of the k largest keys, one thread block per row,
// shared by the top-k kernels (topk_rows.cu, select_pack_rows.cu,
// dgc_forward_rows.cu), and the select-and-pack of one row that the last
// two share.
//
// select_row_sorted() leaves in shared memory the k (key, column) pairs of
// the row's k largest order keys as 64-bit words (~key << 32) | column,
// ascending — key descending, column ascending, the lax.top_k order:
//   1. Radix-select the k-th largest key: four 8-bit histogram passes over
//      the row, each restricted to the keys that share the digits chosen so
//      far. The row is re-read from global memory (L2) on each pass, which
//      keeps shared memory free for step 3.
//   2. Collect every key above the k-th, plus the first (k - #greater) keys
//      equal to it in column order. Each thread owns a contiguous column
//      chunk; a block-wide exclusive scan over the per-thread counts gives
//      every taken element its slot, so the result is deterministic.
//   3. Sort the k words with a shared-memory bitonic sort, padded to a power
//      of two with ~0.
// The caller supplies key_of(c), the order key of column c (order_key() of
// the float it ranks by), so a kernel can rank a value it computes on the
// fly (a masked |x|) without writing it out.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dgc {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Order-preserving uint32 key of a float; -0.0 first becomes +0.0, so equal
// floats tie and break by column, as lax.top_k does.
__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Shared-memory scratch of one block's selection (besides the sort buffer).
struct SelectScratch {
  uint32_t hist[256];
  uint32_t warp_sums[kWarps];
  uint32_t prefix, remaining;
};

// Exclusive scan of one value per thread over the block, in thread order;
// *total receives the block sum. All threads must call it.
__device__ __forceinline__ uint32_t block_exclusive_scan(
    uint32_t v, uint32_t* warp_sums, uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      uint32_t y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive
  }
  __syncthreads();
  const uint32_t out = (warp ? warp_sums[warp - 1] : 0u) + x - v;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return out;
}

// See the file comment. buf holds `padded` words (a power of two >= k, all
// of them written here); 0 < k <= cols. All threads of the block must call
// it; it ends with a __syncthreads(), so buf[0..k) is ready to read.
template <typename KeyOf>
__device__ void select_row_sorted(KeyOf key_of, int cols, int k, int padded,
                                  unsigned long long* buf, SelectScratch& s) {
  const int tid = threadIdx.x;

  // --- 1. radix select: prefix becomes the k-th largest key ---
  uint32_t prefix = 0u, mask = 0u, remaining = (uint32_t)k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) s.hist[i] = 0u;
    __syncthreads();
    for (int c = tid; c < cols; c += kThreads) {
      const uint32_t key = key_of(c);
      if ((key & mask) == prefix) atomicAdd(&s.hist[(key >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      uint32_t above = 0u;
      int d = 255;
      for (; d > 0; --d) {
        if (above + s.hist[d] >= remaining) break;
        above += s.hist[d];
      }
      s.prefix = prefix | ((uint32_t)d << shift);
      s.remaining = remaining - above;
    }
    __syncthreads();
    prefix = s.prefix;
    remaining = s.remaining;
    mask |= 0xFFu << shift;
  }
  // `remaining` keys equal to `prefix` are taken, in column order

  // --- 2. collect, deterministic slots from two block scans ---
  const int chunk = (cols + kThreads - 1) / kThreads;
  const int c0 = min(tid * chunk, cols), c1 = min(c0 + chunk, cols);
  uint32_t n_gt = 0u, n_eq = 0u;
  for (int c = c0; c < c1; ++c) {
    const uint32_t key = key_of(c);
    n_gt += key > prefix;
    n_eq += key == prefix;
  }
  uint32_t total;
  uint32_t gt_slot = block_exclusive_scan(n_gt, s.warp_sums, &total);
  uint32_t eq_rank = block_exclusive_scan(n_eq, s.warp_sums, &total);
  const uint32_t n_greater = (uint32_t)k - remaining;
  for (int c = c0; c < c1; ++c) {
    const uint32_t key = key_of(c);
    const unsigned long long word =
        ((unsigned long long)(~key) << 32) | (uint32_t)c;
    if (key > prefix) {
      buf[gt_slot++] = word;
    } else if (key == prefix) {
      if (eq_rank < remaining) buf[n_greater + eq_rank] = word;
      ++eq_rank;
    }
  }
  for (int i = k + tid; i < padded; i += kThreads) buf[i] = ~0ull;
  __syncthreads();

  // --- 3. bitonic sort, ascending ---
  for (int size = 2; size <= padded; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (padded >> 1); i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = buf[lo], b = buf[hi];
        if ((a > b) == up) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The column of a sorted word.
__device__ __forceinline__ int word_column(unsigned long long w) {
  return (int)(uint32_t)w;
}

// The masked importance of column c of a row with `numel` valid columns.
__device__ __forceinline__ float importance(const float* row, int numel,
                                            int c) {
  return c < numel ? fabsf(row[c]) : -1.0f;
}

// Select and pack one row (select_pack_rows.cu; all threads of the block):
// writes the score, the signed value (x + 0.0f, so -0.0 reads +0.0) and the
// column of the k most important entries to out_*[0..k). k <= 1024 with a
// buf of next_pow2(k) words.
__device__ __forceinline__ void select_pack_row(
    const float* row, int numel, int cols, int k, int padded,
    unsigned long long* buf, SelectScratch& s, float* out_s, float* out_v,
    int* out_i) {
  select_row_sorted(
      [row, numel](int c) { return order_key(importance(row, numel, c)); },
      cols, k, padded, buf, s);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const int c = word_column(buf[j]);
    out_s[j] = importance(row, numel, c);
    out_v[j] = __fadd_rn(row[c], 0.0f);
    out_i[j] = c;
  }
}

// The smallest power of two >= k (k >= 1).
inline int next_pow2(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

}  // namespace dgc
