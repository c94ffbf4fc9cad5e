// The forward megakernel for Hopper (sm_90a): masked error-feedback
// compensate, then exact select and pack, per bucket row in one launch.
//
// Replaces the TPU kernel dgc_tpu/ops/kernels.py::dgc_forward_rows (body
// _dgc_forward_kernel). Per row r of a bucket of `rows` x `cols` at flat
// offset `base`:
//   (a) stream the row's g, m and v (16-byte loads), take each element's
//       keep bit from the full transmit record at its flat position
//       p = base + r * cols + c (word (p >> 12) * 128 + (p & 127), bit
//       (p >> 7) & 31; words past the record read 0), and write
//       m' = momentum * m * keep + g, v' = v * keep + m' (or the nesterov
//       form) in place — _compensate_math (kernels.py:471), op by op;
//   (b) after __syncthreads(), select and pack the row's v' exactly as
//       select_pack_rows.cu does (select_pack_row(), row_select.cuh):
//       scores |v'| (row tail -1), signed values (-0.0 read +0.0) and
//       int32 columns of the k <= 1024 most important entries.
// The TPU kernel keeps a whole row in VMEM; an SM's 227 KB of shared
// memory holds ResNet-20's 36,864-column row but not ResNet-50's 65,536
// or the gate's 131,072 columns, so phase (b) reads v' back from global
// memory, where a row of at most 512 KB is still in the 50 MB L2.
//
// Numerics: the compensate is dgc::compensate() (compensate.cuh, shared
// with seg_top2.cu), so m' and v' are bitwise the Triton compensate_bits
// and the plain version.
//
// Bound on the card: bytes — g, m, v read and m', v' written (20 B per
// element) plus the record's bits, and 12 B per selected slot; the
// selection re-reads the row five times from L2. One block per row: a
// bucket of 6-16 rows keeps 6-16 of the 132 SMs busy, so at these shapes
// the kernel is latency-bound.

#include "compensate.cuh"
#include "row_select.cuh"

namespace {

using dgc::compensate;
using dgc::kThreads;

// v is written in phase (a) and read back in phase (b), so it is neither
// const nor __restrict__ (no read-only cache path for it).
__global__ void __launch_bounds__(kThreads)
dgc_forward_rows_kernel(const float4* __restrict__ g, float4* __restrict__ m,
                        float* v, const int* __restrict__ bits, long long nwords,
                        long long base, const int* __restrict__ numels,
                        int cols, int k, int padded, float momentum,
                        int nesterov, int mask_momentum,
                        float* __restrict__ out_s, float* __restrict__ out_v,
                        int* __restrict__ out_i) {
  __shared__ unsigned long long buf[1024];
  __shared__ dgc::SelectScratch scratch;
  const size_t r = blockIdx.x;
  const size_t q0 = r * (cols / 4);  // the row's first float4
  float4* v4 = reinterpret_cast<float4*>(v);

  // --- (a) compensate, four elements per thread and step ---
  for (int j = threadIdx.x; j < cols / 4; j += kThreads) {
    // the four elements share one 128-lane row of the record: one word
    // each, one bit position for all four
    const long long p = base + 4 * (long long)(q0 + j);
    const long long w = (p >> 12) * 128 + (p & 127);
    const int bit = (int)((p >> 7) & 31);
    float keep[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int word = w + e < nwords ? bits[w + e] : 0;
      keep[e] = dgc::keep_bit(word, bit);
    }
    const float4 gg = g[q0 + j];
    float4 mm = m[q0 + j], vv = v4[q0 + j];
    compensate(gg.x, mm.x, vv.x, keep[0], momentum, nesterov, mask_momentum);
    compensate(gg.y, mm.y, vv.y, keep[1], momentum, nesterov, mask_momentum);
    compensate(gg.z, mm.z, vv.z, keep[2], momentum, nesterov, mask_momentum);
    compensate(gg.w, mm.w, vv.w, keep[3], momentum, nesterov, mask_momentum);
    m[q0 + j] = mm;
    v4[q0 + j] = vv;
  }
  __syncthreads();  // v' of the whole row is visible to the block

  // --- (b) select and pack over v' ---
  dgc::select_pack_row(v + r * cols, numels[r], cols, k, padded, buf, scratch,
                       out_s + r * k, out_v + r * k, out_i + r * k);
}

}  // namespace

// g, m, v: the bucket's [rows * cols] f32 region (16-byte aligned; m and v
// updated in place); bits: the full transmit record [nwords] int32; base:
// the region's flat offset (a multiple of 128); numels: [rows] int32;
// cols a multiple of 128; 0 < k <= min(cols, 1024); out_s, out_v: [rows, k]
// f32; out_i: [rows, k] int32. Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int dgc_forward_rows_launch(
    const float* g, float* m, float* v, const int* bits, long long nwords,
    long long base, const int* numels, int rows, int cols, int k,
    float momentum, int nesterov, int mask_momentum, float* out_s,
    float* out_v, int* out_i, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  if (k < 1 || k > 1024 || k > cols || cols % 128 || base % 128)
    return (int)cudaErrorInvalidValue;
  dgc_forward_rows_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(m), v,
      bits, nwords, base, numels, cols, k, dgc::next_pow2(k), momentum,
      nesterov, mask_momentum, out_s, out_v, out_i);
  return (int)cudaGetLastError();
}
