// The momentum compensate of one element, shared by the kernels that
// compensate (compensate.cu; dgc_forward_rows.cu and seg_top2.cu on the
// fly), so their m' and v' stay bitwise the Triton compensate_bits and the
// plain versions.
//
// _compensate_math (dgc_tpu/ops/kernels.py:471), op by op: the arithmetic is
// written with __fmul_rn / __fadd_rn, which nvcc never contracts into an
// FMA (the Triton kernel launches with FMA contraction off). The keep mask
// multiplies (m * 0.0f, not a select), so signed zeros and NaNs follow the
// reference. The bf16 state's conversions are here too: loaded by
// widening (exact), stored with round-to-nearest-even
// (__float2bfloat16_rn, the conversion PyTorch's own cast uses on sm_80+),
// four elements to a uint2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dgc {

// The bf16 bits of x, rounded to nearest even.
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// One bf16 element's f32 value.
__device__ __forceinline__ float bf16_value(unsigned short h) {
  return __uint_as_float((uint32_t)h << 16);
}

// Four bf16 elements (low half first) as f32, and back, rounded.
__device__ __forceinline__ float4 bf16x4_unpack(uint2 w) {
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ uint2 bf16x4_pack(float4 x) {
  return make_uint2(bf16_bits(x.x) | (bf16_bits(x.y) << 16),
                    bf16_bits(x.z) | (bf16_bits(x.w) << 16));
}

// The keep factor of bit `bit` of a transmit-record word: 0.0f where the
// coordinate was sent last step, else 1.0f.
__device__ __forceinline__ float keep_bit(int word, int bit) {
  return ((word >> bit) & 1) ? 0.0f : 1.0f;
}

// The momentum correction of one element: m', v' from g and the (masked)
// state m, v, updated in place.
__device__ __forceinline__ void momentum_correct(float g, float& m, float& v,
                                                 float momentum,
                                                 bool nesterov) {
  if (nesterov) {
    m = __fmul_rn(__fadd_rn(m, g), momentum);
    v = __fadd_rn(__fadd_rn(v, m), g);
  } else {
    m = __fadd_rn(__fmul_rn(momentum, m), g);
    v = __fadd_rn(v, m);
  }
}

// m', v' of one element from g and the stored m, v; keep is 1.0f or 0.0f.
__device__ __forceinline__ void compensate(float g, float& m, float& v,
                                           float keep, float momentum,
                                           bool nesterov, bool mask_momentum) {
  if (mask_momentum) m = __fmul_rn(m, keep);
  v = __fmul_rn(v, keep);
  momentum_correct(g, m, v, momentum, nesterov);
}

}  // namespace dgc
