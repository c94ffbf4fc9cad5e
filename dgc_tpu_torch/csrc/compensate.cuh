// The momentum compensate of one element, shared by the kernels that
// compensate (compensate.cu; dgc_forward_rows.cu and seg_top2.cu on the
// fly), so their m' and v' stay bitwise the Triton compensate_bits and the
// plain versions.
//
// _compensate_math (dgc_tpu/ops/kernels.py:471), op by op: the arithmetic is
// written with __fmul_rn / __fadd_rn, which nvcc never contracts into an
// FMA (the Triton kernel launches with FMA contraction off). The keep mask
// multiplies (m * 0.0f, not a select), so signed zeros and NaNs follow the
// reference.

#pragma once

#include <cuda_runtime.h>

namespace dgc {

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
