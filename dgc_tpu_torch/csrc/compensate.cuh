// The bit-masked momentum compensate of one element, shared by the kernels
// that compensate on the fly (dgc_forward_rows.cu, seg_top2.cu), so their m'
// and v' stay bitwise the Triton compensate_bits and the plain version.
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

// m', v' of one element from g and the stored m, v; keep is 1.0f or 0.0f.
__device__ __forceinline__ void compensate(float g, float& m, float& v,
                                           float keep, float momentum,
                                           bool nesterov, bool mask_momentum) {
  const float m0 = mask_momentum ? __fmul_rn(m, keep) : m;
  const float v0 = __fmul_rn(v, keep);
  if (nesterov) {
    m = __fmul_rn(__fadd_rn(m0, g), momentum);
    v = __fadd_rn(__fadd_rn(v0, m), g);
  } else {
    m = __fadd_rn(__fmul_rn(momentum, m0), g);
    v = __fadd_rn(v0, m);
  }
}

}  // namespace dgc
