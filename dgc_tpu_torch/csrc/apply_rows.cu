// Post-gather apply for Hopper (sm_90a): decompress scatter-add of the
// gathered DGC payload plus the packed transmit record, in one launch.
//
// Replaces the TPU kernels dgc_tpu/ops/kernels.py::payload_apply_bits and
// ::dgc_apply_rows (one Pallas body, _payload_apply_call). The TPU kernel
// streams 2048x128 chunks of the flat buffer through VMEM, one payload page
// at a time, because its grid runs in order on one core. On Hopper blocks
// run in parallel and in no order, so the design is different:
//
//   * Staging (outside this kernel, like _stage_payload on the TPU) sorts
//     the payload stably by index. Entries whose value is exactly zero sort
//     to a trailing dummy run with key `total`: adding a zero to a sum that
//     starts at +0.0 is the identity, and the engine's padded slots (all
//     value 0.0 at the sentinel) would otherwise make one very long run.
//   * One thread per sorted entry; the first entry of each run of equal
//     indices sums the run's values from 0.0f in sorted order — which is
//     payload order, the stable sort keeps it — dividing each by the worker
//     count first (IEEE divide: no fast math). That reproduces
//     `zeros.at[idx].add(wire / W)` bitwise for unique indices and the
//     XLA-CPU update order for cross-worker duplicates. No float atomics,
//     so the result does not depend on scheduling.
//   * Every flagged entry (this worker's own, non-sentinel slots) ORs its
//     bit into the transmit record with atomicOr, which is order-free. The
//     record uses pack_sent_bits' layout: word (p >> 12) * 128 + (p & 127),
//     bit (p >> 7) & 31. The bits read the UNSORTED payload.
//   * Indices outside [0, total) are dropped: staging keys them `total`,
//     and the record skips them, so no write leaves acc or bits.
//
// The wrapper zero-initialises `acc` and `bits`. Bound on the card: bytes,
// the [total] f32 zero-init and write of `acc` plus 12 bytes per payload
// entry; at ResNet-20 sizes a few microseconds, so the launch dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void apply_rows_kernel(const int* __restrict__ idx,
                                  const uint8_t* __restrict__ flags,
                                  const int* __restrict__ skey,
                                  const float* __restrict__ sval, int n,
                                  float* __restrict__ acc,
                                  int* __restrict__ bits, int total,
                                  int has_div, float divisor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = idx[i];
  if (flags[i] && p >= 0 && p < total) {
    atomicOr(&bits[(p >> 12) * 128 + (p & 127)],
             (int)(1u << ((p >> 7) & 31)));
  }
  const int key = skey[i];
  if (key >= total || (i > 0 && skey[i - 1] == key)) return;
  float s = 0.0f;
  for (int j = i; j < n && skey[j] == key; ++j) {
    float v = sval[j];
    if (has_div) v = v / divisor;
    s = s + v;
  }
  acc[key] = s;
}

}  // namespace

// idx, flags: the unsorted payload's indices (int32) and transmit flags
// (bool as uint8); skey, sval: the staged (sorted) keys and values, [n].
// acc: [total] f32 and bits: [num_sent_words(total)] int32, zero-filled.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int apply_rows_launch(const int* idx, const uint8_t* flags,
                                 const int* skey, const float* sval, int n,
                                 float* acc, int* bits, int total,
                                 int has_div, float divisor, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int threads = 256;
  apply_rows_kernel<<<(n + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(idx, flags, skey, sval, n, acc,
                                              bits, total, has_div, divisor);
  return (int)cudaGetLastError();
}
