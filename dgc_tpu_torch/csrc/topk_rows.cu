// Exact per-row top-k for Hopper (sm_90a), in lax.top_k order.
//
// Replaces the TPU kernel dgc_tpu/ops/kernels.py::topk_rows (Pallas
// iterative max extraction, k <= 128). The engine selects exactly at every
// k of the warm-up schedule (up to 11,658 of 36,864 columns for ResNet-20),
// so the TPU design — k sequential passes over a VMEM-resident block — does
// not carry over.
//
// Design, one thread block per row: select_row_sorted() (row_select.cuh)
// over the order keys of the row's floats — a four-pass radix select of the
// k-th key, an index-ordered collect, a shared-memory bitonic sort — then
// the values are read back from the row (so signed zeros keep their sign)
// with their int32 columns.
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

#include "row_select.cuh"

namespace {

using dgc::kThreads;

__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ out_v,
                 int* __restrict__ out_i, int cols, int k, int padded) {
  extern __shared__ unsigned long long buf[];  // [padded] sort words
  __shared__ dgc::SelectScratch scratch;
  const float* row = x + (size_t)blockIdx.x * cols;
  dgc::select_row_sorted(
      [row](int c) { return dgc::order_key(row[c]); }, cols, k, padded, buf,
      scratch);
  const size_t o = (size_t)blockIdx.x * k;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const int c = dgc::word_column(buf[j]);
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
  const int padded = dgc::next_pow2(k);
  const size_t smem = (size_t)padded * sizeof(unsigned long long);
  err = cudaFuncSetAttribute(topk_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_rows_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      x, out_v, out_i, cols, k, padded);
  return (int)cudaGetLastError();
}
