// Fused threshold -> select -> pack over a bucket's rows, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels dgc_tpu/ops/kernels.py::select_pack_rows
// (_select_pack_kernel, k <= 128 in one VMEM block) and
// ::_select_pack_rows_mr (_select_pack_mr_kernel, 128 < k <= 1024 or wide
// rows, 16K-column chunks with a running carry). The TPU splits the two
// only to fit its VMEM budget and its 128-lane output block; here one
// kernel covers 0 < k <= 1024 at any width.
//
// Per row r of x [R, cols]: importance imp(c) = c < numels[r] ? |x[r, c]|
// : -1 (computed on the fly, never written), the k most important columns
// in lax.top_k order (importance descending, ties to the lower column),
// and for each (score, signed value, int32 column). The value is read back
// as x + 0.0f, so a selected -0.0 is written +0.0, as the Pallas kernels'
// one-hot masked sum reads it.
//
// Design, one thread block per row: select_pack_row() (row_select.cuh) —
// a four-pass radix select of the k-th importance key, an index-ordered
// collect, a bitonic sort of the k <= 1024 survivors in 8 KB of shared
// memory — then the three outputs.
//
// Bound on the card: bytes (the row read once, 12 B per selected slot
// written); the selection is a few compares per element. The row is read
// six times (four radix passes, two collect passes), five of them from L2.
// With one block per row, a bucket of 6-16 rows keeps 6-16 of the 132 SMs
// busy: latency-bound at ResNet-20's shapes. NaN input is unspecified, as
// it is for the TPU kernels.

#include "row_select.cuh"

namespace {

using dgc::kThreads;

__global__ void __launch_bounds__(kThreads)
select_pack_rows_kernel(const float* __restrict__ x,
                        const int* __restrict__ numels, int cols, int k,
                        int padded, float* __restrict__ out_s,
                        float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ unsigned long long buf[1024];
  __shared__ dgc::SelectScratch scratch;
  const size_t r = blockIdx.x;
  dgc::select_pack_row(x + r * cols, numels[r], cols, k, padded, buf, scratch,
                       out_s + r * k, out_v + r * k, out_i + r * k);
}

}  // namespace

// x: [rows, cols] f32 contiguous; numels: [rows] int32; 0 < k <= min(cols,
// 1024); out_s, out_v: [rows, k] f32; out_i: [rows, k] int32. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int select_pack_rows_launch(const float* x, const int* numels,
                                       int rows, int cols, int k, float* out_s,
                                       float* out_v, int* out_i, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  if (k < 1 || k > 1024 || k > cols) return (int)cudaErrorInvalidValue;
  select_pack_rows_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      x, numels, cols, k, dgc::next_pow2(k), out_s, out_v, out_i);
  return (int)cudaGetLastError();
}
