// Exact per-row top-k for Hopper (sm_90a), in lax.top_k order.
//
// Replaces the TPU kernel dgc_tpu/ops/kernels.py::topk_rows (Pallas
// iterative max extraction, k <= 128). The engine selects exactly at every
// k of the warm-up schedule (up to 11,658 of 36,864 columns for ResNet-20),
// so the TPU design — k sequential passes over a VMEM-resident block — does
// not carry over.
//
// Design, one thread block per row:
//   1. Map each f32 to an order-preserving uint32 key (-0.0 first becomes
//      +0.0, so equal floats tie and break by index like lax.top_k).
//   2. Radix-select the k-th largest key: four 8-bit histogram passes over
//      the row, each restricted to the keys that share the digits chosen so
//      far. The row is re-read from global memory (L2) on each pass, which
//      keeps shared memory free for step 4.
//   3. Collect every key above the k-th, plus the first (k - #greater) keys
//      equal to it in column order. Each thread owns a contiguous column
//      chunk; a block-wide exclusive scan over the per-thread counts gives
//      every taken element its slot, so the result is deterministic.
//   4. Sort the k (key, column) pairs as one 64-bit word, (~key << 32) |
//      column, ascending — i.e. value descending, column ascending — with a
//      shared-memory bitonic sort padded to a power of two with ~0.
//   5. Write values (read back from the row, so signed zeros keep their
//      sign) and int32 columns.
//
// Bound on the card: bytes. The row is read 5 times from L2 and once from
// HBM, and k·8 bytes are written; the top-k work itself is a few compares
// per element. ResNet-20 has only 6-16 rows per bucket, so 6-16 of the
// 132 SMs are busy: the kernel is latency-bound at these shapes, which a
// later multi-block-per-row split would address.
//
// Shared memory: the sort buffer takes next_pow2(k)·8 bytes, so k <= 16384
// (128 KB); the wrapper raises above that. NaN input is unspecified, as it
// is for the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;  // -0.0 ties with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Exclusive scan of one value per thread over the block, in thread order;
// *total receives the block sum. All threads must call it.
__device__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* warp_sums,
                                         uint32_t* total) {
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

__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ out_v,
                 int* __restrict__ out_i, int cols, int k, int padded) {
  extern __shared__ unsigned long long buf[];  // [padded] sort words
  __shared__ uint32_t hist[256];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t s_prefix, s_remaining;

  const int tid = threadIdx.x;
  const float* row = x + (size_t)blockIdx.x * cols;

  // --- 2. radix select: prefix becomes the k-th largest key ---
  uint32_t prefix = 0u, mask = 0u, remaining = (uint32_t)k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0u;
    __syncthreads();
    for (int c = tid; c < cols; c += kThreads) {
      const uint32_t key = order_key(row[c]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      uint32_t above = 0u;
      int d = 255;
      for (; d > 0; --d) {
        if (above + hist[d] >= remaining) break;
        above += hist[d];
      }
      s_prefix = prefix | ((uint32_t)d << shift);
      s_remaining = remaining - above;
    }
    __syncthreads();
    prefix = s_prefix;
    remaining = s_remaining;
    mask |= 0xFFu << shift;
  }
  // `remaining` keys equal to `prefix` are taken, in column order

  // --- 3. collect, deterministic slots from two block scans ---
  const int chunk = (cols + kThreads - 1) / kThreads;
  const int c0 = min(tid * chunk, cols), c1 = min(c0 + chunk, cols);
  uint32_t n_gt = 0u, n_eq = 0u;
  for (int c = c0; c < c1; ++c) {
    const uint32_t key = order_key(row[c]);
    n_gt += key > prefix;
    n_eq += key == prefix;
  }
  uint32_t total;
  uint32_t gt_slot = block_exclusive_scan(n_gt, warp_sums, &total);
  uint32_t eq_rank = block_exclusive_scan(n_eq, warp_sums, &total);
  const uint32_t n_greater = (uint32_t)k - remaining;
  for (int c = c0; c < c1; ++c) {
    const uint32_t key = order_key(row[c]);
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

  // --- 4. bitonic sort, ascending ---
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

  // --- 5. emit ---
  const size_t o = (size_t)blockIdx.x * k;
  for (int j = tid; j < k; j += kThreads) {
    const int c = (int)(uint32_t)buf[j];
    out_i[o + j] = c;
    out_v[o + j] = row[c];
  }
}

}  // namespace

// x: [rows, cols] f32 contiguous; out_v: [rows, k] f32; out_i: [rows, k]
// int32. Returns the CUDA error code of the launch (0 = launched).
extern "C" int topk_rows_launch(const float* x, float* out_v, int* out_i,
                                int rows, int cols, int k, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || k == 0) return 0;
  int padded = 1;
  while (padded < k) padded <<= 1;
  const size_t smem = (size_t)padded * sizeof(unsigned long long);
  err = cudaFuncSetAttribute(topk_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_rows_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      x, out_v, out_i, cols, k, padded);
  return (int)cudaGetLastError();
}
