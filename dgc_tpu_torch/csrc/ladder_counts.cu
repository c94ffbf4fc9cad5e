// Threshold-ladder pass counts for Hopper (sm_90a):
//   counts[r, i] = #{ c : imp[r, c] >= factor[i] * thr[r] },  i < L <= 128.
//
// Replaces the TPU kernel dgc_tpu/ops/kernels.py::ladder_counts
// (_ladder_kernel). The TPU kernel walks a grid of (8-row block, 128K-column
// chunk) steps in order on one core, carrying each row block's [8, 128]
// int32 counts across its column chunks in the revisited output block, and
// needs rows padded to 8 and columns to the chunk. On Hopper blocks run in
// parallel and in no order, so the design is different:
//
//   * One block per (row, 4096-column chunk). Any [R, cols] is taken as it
//     is: no row or column padding (the reference pads with -1, which no
//     level counts, since thresholds are >= 0).
//   * The levels are computed once per block into shared memory as
//     __fmul_rn(factor[i], thr[r]): factor[i] is float32(lb ** i), the
//     Python double power rounded once, computed on the host and passed by
//     value in the launch parameters; this is the Pallas kernel's
//     `(lower_bound ** i) * t` with the weak-typed scalar cast to f32.
//   * Each thread reads 16-byte float4s (a scalar loop when the rows are not
//     16-byte aligned) and keeps 16 counters in registers, one per level of
//     the current group of 16 levels; L > 16 walks the chunk once per group
//     (at most eight, for the reference's L <= 128).
//   * Per group: a warp sum (__reduce_add_sync), one shared-memory atomic
//     per (warp, level), then one global int32 atomicAdd per (block, level)
//     into the zeroed [R, L] output. Integer sums are order-free, so the
//     result is deterministic.
//   * `x >= level` is false for a NaN importance (or a NaN level), so a NaN
//     is never counted, as in the reference.
//
// Bound on the card: bytes, 4 B per element read once plus R * L * 4
// written; the compares ride the stream (L <= 16 per element and group).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 128;
constexpr int kGroup = 16;
constexpr int kThreads = 256;
constexpr long long kChunk = 4096;

struct Factors {
  float f[kMaxLevels];
};

__global__ void ladder_counts_kernel(const float* __restrict__ imp,
                                     const float* __restrict__ thr,
                                     Factors factors, long long cols, int L,
                                     int vec, int* __restrict__ out) {
  __shared__ float lev[kMaxLevels + kGroup];
  __shared__ int bcnt[kGroup];
  const int r = blockIdx.y;
  const float t = thr[r];
  for (int i = threadIdx.x; i < kMaxLevels + kGroup; i += blockDim.x)
    lev[i] = i < L ? __fmul_rn(factors.f[i], t) : __int_as_float(0x7fc00000);
  const long long c0 = (long long)blockIdx.x * kChunk;
  const long long c1 = c0 + kChunk < cols ? c0 + kChunk : cols;
  const float* row = imp + (long long)r * cols;
  const int lane = threadIdx.x & 31;

  for (int g0 = 0; g0 < L; g0 += kGroup) {
    if (threadIdx.x < kGroup) bcnt[threadIdx.x] = 0;
    __syncthreads();
    int cnt[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) cnt[j] = 0;
    if (vec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      for (long long q = c0 / 4 + threadIdx.x; q < c1 / 4; q += blockDim.x) {
        const float4 x = row4[q];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const float l = lev[g0 + j];
          cnt[j] += (x.x >= l) + (x.y >= l) + (x.z >= l) + (x.w >= l);
        }
      }
    } else {
      for (long long c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
        const float x = row[c];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) cnt[j] += x >= lev[g0 + j];
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int s = __reduce_add_sync(0xffffffffu, cnt[j]);
      if (lane == 0 && s) atomicAdd(&bcnt[j], s);
    }
    __syncthreads();
    if (threadIdx.x < kGroup && g0 + threadIdx.x < L && bcnt[threadIdx.x])
      atomicAdd(&out[(long long)r * L + g0 + threadIdx.x], bcnt[threadIdx.x]);
    __syncthreads();
  }
}

}  // namespace

// imp: [R, cols] f32 row-major; thr: [R] f32; factors: L host floats
// (float32(lb ** i)); out: [R, L] int32, zeroed by the caller. Returns the
// CUDA error code of the launch (0 = launched; 1 for L outside [1, 128]).
extern "C" int ladder_counts_launch(const float* imp, const float* thr,
                                    const float* factors, int R,
                                    long long cols, int L, int* out,
                                    int device, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R == 0 || cols == 0) return 0;
  Factors f;
  for (int i = 0; i < kMaxLevels; ++i) f.f[i] = i < L ? factors[i] : 0.0f;
  const int vec = (cols % 4 == 0) && ((uintptr_t)imp % 16 == 0);
  const dim3 grid((unsigned)((cols + kChunk - 1) / kChunk), (unsigned)R);
  ladder_counts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      imp, thr, f, cols, L, vec, out);
  return (int)cudaGetLastError();
}
