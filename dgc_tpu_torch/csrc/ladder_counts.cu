// Threshold-ladder pass counts for Hopper (sm_90a):
//   counts[r, i] = #{ c : imp[r, c] >= factor[i] * thr[r] },  i < L <= 128.
//
// Replaces the TPU kernel dgc_tpu/ops/kernels.py::ladder_counts
// (_ladder_kernel, pallas_call :674). The TPU kernel walks a grid of (8-row
// block, 128K-column chunk) steps in order on one core, carrying each row
// block's [8, 128] int32 counts across its column chunks in the revisited
// output block, and needs rows padded to 8 and columns to the chunk. On
// Hopper blocks run in parallel and in no order.
//
// What bounds it on this card: bytes, 4 B per element read once plus R * L
// * 4 written (5.3 us at [17, 262144]), as long as the counting keeps up.
// It does not always: counting L levels costs about 2 L instructions an
// element, and one level's count of a row can only be summed within one
// thread-block cluster (16 SMs at most) when no global atomics may combine
// counts. So the design spreads rows as far as that goes and writes each
// count once:
//   * A row is split over a cluster of C blocks (C = 1: one block a row),
//     each a contiguous share of the row's 16-byte quads; no row or column
//     padding. A wide row may also split its levels: S clusters each
//     count ceil(L / S) of them over the whole row, so the row spreads
//     over C x S SMs for S reads of its bytes (which mostly hit L2: the S
//     clusters run at once). kernels.ladder_plan picks the C and S of
//     least work a block among those whose R x S clusters run in one wave
//     (cudaOccupancyMaxActiveClusters, ladder_max_clusters below). Each
//     thread issues kUnroll independent float4 loads before it counts.
//   * Any row base and any cols: each row's quads start at its first
//     16-byte aligned element (head = 0-3 elements); block 0 of the row
//     counts the scalar head and the ragged tail (at most 3 each).
//   * Per group of up to 16 levels (L > 16 walks the slice once per group),
//     each thread keeps one counter a level in registers; the last group is
//     LAST levels wide (an instantiation per width), so L = 11 makes 11
//     compares an element. Then a warp sum (__reduce_add_sync) per level,
//     and warp j sums level j over the warps.
//   * In a cluster, every block stores its counts into block 0's shared
//     memory (distributed shared memory), and after one cluster barrier
//     block 0 sums them and writes [r, :L] once. No zero-fill, no global
//     atomics; integer sums are order-free, so the result is
//     deterministic.
//   * The levels are formed by every thread as __fmul_rn(factor[i],
//     thr[r]): factor[i] is float32(lb ** i), the Python double power
//     rounded once, computed on the host and passed by value; this is the
//     Pallas kernel's `(lower_bound ** i) * t` with the weak-typed scalar
//     cast to f32. Nothing assumes the levels monotone: thr may be 0 or
//     NaN.
//   * `x >= level` is false for a NaN importance (or a NaN level), so a NaN
//     is never counted, as in the reference.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 128;
constexpr int kGroup = 16;
constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMaxCluster = 16;

// float32(lb ** i) for i < L, 0 past L (the last split's spare levels)
struct Factors {
  float f[2 * kMaxLevels];
};

// This block's counts of `x >= lv[j]` over its quads [q0, q1) of the
// row's body and the thread's scalar elements `edge` and `edge2` (-1:
// none), into the thread's counters.
template <int G>
__device__ __forceinline__ void scan(const float* row, const float4* body,
                                     long long q0, long long q1,
                                     long long edge, long long edge2,
                                     const float (&lv)[G], int (&cnt)[G]) {
  auto add = [&](float x) {
#pragma unroll
    for (int j = 0; j < G; ++j) cnt[j] += x >= lv[j];
  };
  const int T = blockDim.x;
  long long q = q0 + threadIdx.x;
  for (; q + (kUnroll - 1) * T < q1; q += kUnroll * T) {
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(body + q + u * T);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add(x[u].x);
      add(x[u].y);
      add(x[u].z);
      add(x[u].w);
    }
  }
  for (; q < q1; q += T) {
    const float4 x = __ldg(body + q);
    add(x.x);
    add(x.y);
    add(x.z);
    add(x.w);
  }
  if (edge >= 0) add(row[edge]);
  if (edge2 >= 0) add(row[edge2]);
}

// One group of G levels, __fmul_rn(f[j], t), over the block's share of the
// row (see scan): the block's count of each level into part[0..G) (shared
// memory).
template <int G>
__device__ __forceinline__ void count_group(const float* row,
                                            const float4* body, long long q0,
                                            long long q1, long long edge,
                                            long long edge2, float t,
                                            const float* f, int* part,
                                            int (*wsum)[kWarps]) {
  float lv[G];
  int cnt[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    lv[j] = __fmul_rn(f[j], t);
    cnt[j] = 0;
  }
  scan(row, body, q0, q1, edge, edge2, lv, cnt);
  // a warp sum per level, then warp j sums level j over the warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int s = __reduce_add_sync(0xffffffffu, cnt[j]);
    if (lane == 0) wsum[j][warp] = s;
  }
  __syncthreads();
  for (int j = warp; j < G; j += warps) {
    const int s = __reduce_add_sync(0xffffffffu,
                                    lane < warps ? wsum[j][lane] : 0);
    if (lane == 0) part[j] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A block counts the levels [lo, lo + Ls) of one row's split (Ls =
// ceil(L / S); the row's S splits count all of them, each reading the
// row), over its share of the row: C blocks a split, in a cluster of C (C
// = 1: no cluster). LAST: the width of the split's last group of levels
// (1-16). Levels past L are counted (factor 0) but not written.
template <int LAST>
__global__ void __launch_bounds__(kMaxThreads)
ladder_counts_kernel(const float* __restrict__ imp,
                     const float* __restrict__ thr,
                     const __grid_constant__ Factors factors,
                     long long cols, int L, int S, int C,
                     int* __restrict__ out) {
  __shared__ int wsum[kGroup][kWarps];
  __shared__ int part[kMaxLevels];
  __shared__ int slots[kMaxCluster * kMaxLevels];   // block 0's: [rank][level]
  if (C > 1) cluster_arrive();       // matched by the wait before DSMEM use
  const int cid = blockIdx.x / C, k = blockIdx.x % C;
  const int r = cid / S, Ls = (L + S - 1) / S, lo = (cid % S) * Ls;
  const int nl = Ls < L - lo ? Ls : L - lo;       // levels written
  const float t = thr[r];
  const float* row = imp + (long long)r * cols;
  long long head = ((16 - ((uintptr_t)row & 15)) & 15) >> 2;
  if (head > cols) head = cols;
  const long long nq = (cols - head) >> 2;
  const long long per = (nq + C - 1) / C;
  const long long q0 = k * per < nq ? k * per : nq;
  const long long q1 = q0 + per < nq ? q0 + per : nq;
  // block 0 of the split: thread i < 4 counts head element i (i < head)
  // and tail element head + 4 nq + i (inside the row)
  long long edge = -1, edge2 = -1;
  if (k == 0 && threadIdx.x < 4) {
    if (threadIdx.x < head) edge = threadIdx.x;
    if (head + 4 * nq + threadIdx.x < cols) edge2 = head + 4 * nq + threadIdx.x;
  }
  const float4* body = reinterpret_cast<const float4*>(row + head);
  const float* f = factors.f + lo;
  int g0 = 0;
  for (; g0 + kGroup < Ls; g0 += kGroup)
    count_group<kGroup>(row, body, q0, q1, edge, edge2, t, f + g0,
                        part + g0, wsum);
  count_group<LAST>(row, body, q0, q1, edge, edge2, t, f + g0, part + g0,
                    wsum);

  int* dst = out + (long long)r * L + lo;
  if (C == 1) {
    for (int i = threadIdx.x; i < nl; i += blockDim.x) dst[i] = part[i];
    return;
  }
  // every block stores its counts into block 0's slots (distributed shared
  // memory); after the cluster barrier block 0 sums them, warp w the
  // levels w, w + warps, ..., lane c the count of rank c
  cg::cluster_group cl = cg::this_cluster();
  cluster_wait();
  int* remote = cl.map_shared_rank(slots, 0) + k * Ls;
  for (int i = threadIdx.x; i < nl; i += blockDim.x) remote[i] = part[i];
  cl.sync();
  if (k == 0) {
    const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    for (int i = threadIdx.x >> 5; i < nl; i += warps) {
      const int s = __reduce_add_sync(0xffffffffu,
                                      lane < C ? slots[lane * Ls + i] : 0);
      if (lane == 0) dst[i] = s;
    }
  }
}

using Kernel = void (*)(const float*, const float*, Factors, long long, int,
                        int, int, int*);

template <int... I>
constexpr auto kernels(std::integer_sequence<int, I...>) {
  return std::array<Kernel, sizeof...(I)>{ladder_counts_kernel<I + 1>...};
}

// The kernel for splits of Ls levels and its launch configuration for
// clusters of `cluster` blocks of `threads` (no cluster attribute for one
// block).
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                      Kernel& kernel, int Ls, int cluster, int threads) {
  static const auto table = kernels(std::make_integer_sequence<int, kGroup>{});
  kernel = table[Ls - kGroup * ((Ls - 1) / kGroup) - 1];
  if (cluster > 8) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(threads);
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaSuccess;
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// imp: [R, cols] f32 row-major (any 4-byte aligned base); thr: [R] f32;
// factors: L host floats (float32(lb ** i)); out: [R, L] int32, every
// count written once. Each row's levels in `splits` splits of ceil(L /
// splits) (none empty), each over `cluster` (1-16) blocks of `threads` (a
// multiple of 32, at most 1,024), as kernels.ladder_plan picks them.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int ladder_counts_launch(const float* imp, const float* thr,
                                    const float* factors, int R,
                                    long long cols, int L, int cluster,
                                    int splits, int threads, int* out,
                                    int device, void* stream) {
  if (L < 1 || L > kMaxLevels || cluster < 1 || cluster > kMaxCluster ||
      threads < 32 || threads > kMaxThreads || threads % 32 ||
      splits < 1 || splits > L)
    return (int)cudaErrorInvalidValue;
  const int Ls = (L + splits - 1) / splits;
  if ((L + Ls - 1) / Ls != splits) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  Factors f;
  for (int i = 0; i < 2 * kMaxLevels; ++i) f.f[i] = i < L ? factors[i] : 0.0f;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Kernel kernel = nullptr;
  if ((err = configure(cfg, attr, kernel, Ls, cluster, threads)) !=
      cudaSuccess)
    return (int)err;
  cfg.gridDim = dim3(R * splits * cluster);
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel, imp, thr, f, cols, L, splits,
                           cluster, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The most clusters of `cluster` blocks of `threads` that the device runs
// at once (cudaOccupancyMaxActiveClusters) for the kernel of a full group
// of levels (every width takes the same registers to a block: one block an
// SM at 1,024 threads); kernels.ladder_counts asks it once per device and
// geometry and plans within it. Returns a negative CUDA error code on
// failure.
extern "C" int ladder_max_clusters(int cluster, int threads, int device) {
  if (cluster < 1 || cluster > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Kernel kernel = nullptr;
  if (err == cudaSuccess)
    err = configure(cfg, attr, kernel, kGroup, cluster, threads);
  cfg.gridDim = dim3(cluster);
  attr[0].val.clusterDim.x = cluster;      // asked of every size, 1 too
  cfg.numAttrs = 1;
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
