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
// Design: one thread per 16-byte (float4) word when both pointers are
// 16-byte aligned and n is a multiple of 4, else one per element; a grid
// sized to the work in 128-thread blocks, 32-bit indices, no loop; one
// launch. Bound on the card: bytes, one read and one write of the tensor
// (8 B per element); the copy does no arithmetic. At the engine's sizes
// (512-4,096 elements) it is a launch: what it can save is instructions
// ahead of the first load. A slice past 2**31 elements of a larger flat
// buffer needs no 64-bit index: the wrapper passes its address, and the
// kernel's indices stay under n (at most 2**31 - 1, refused above).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(128)
opaque_copy_kernel(const float* __restrict__ src, float* __restrict__ dst,
                   int n, int vec) {
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (vec) {
    if (i < (n >> 2))
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
  } else if (i < n) {
    dst[i] = src[i];
  }
}

}  // namespace

// src: n f32 to read; dst: n f32 to write (a fresh tensor); n < 2^31.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int opaque_copy_launch(const float* src, float* dst, long long n,
                                  int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0) &&
                  n % 4 == 0;
  const int work = vec ? (int)(n >> 2) : (int)n;
  opaque_copy_kernel<<<(work + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      src, dst, (int)n, vec);
  return (int)cudaGetLastError();
}
