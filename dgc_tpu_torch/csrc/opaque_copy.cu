// Identity copy of one f32 tensor into a buffer of its own, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels dgc_tpu/ops/kernels.py::opaque_view
// (_opaque_copy) and ::opaque_view_from (_opaque_from), one Pallas identity
// body. On the TPU the copy gives XLA a buffer it cannot trace back to the
// flat parameter buffer; the port's train step binds the same tensors
// through it, so both packages run one structure. The source is
// `src + offset` of the flat buffer (or a view), read in place.
//
// Design: a grid-stride loop of 16-byte (float4) loads and stores when
// both pointers are 16-byte aligned, then a scalar tail; one launch. Bound
// on the card: bytes, one read and one write of the tensor (8 B per
// element); the copy does no arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void opaque_copy_kernel(const float* __restrict__ src,
                                   float* __restrict__ dst, long long n,
                                   int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  const float4* __restrict__ s4 = reinterpret_cast<const float4*>(src);
  float4* __restrict__ d4 = reinterpret_cast<float4*>(dst);
  for (long long j = i0; j < n4; j += stride) d4[j] = s4[j];
  for (long long j = n4 * 4 + i0; j < n; j += stride) dst[j] = src[j];
}

}  // namespace

// src: n f32 to read; dst: n f32 to write (a fresh tensor). Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int opaque_copy_launch(const float* src, float* dst, long long n,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int vec = ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0);
  const int threads = 256;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // 16 blocks per SM, then stride
  opaque_copy_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      src, dst, n, vec);
  return (int)cudaGetLastError();
}
