// The segment-candidate kernels for Hopper (sm_90a): per (128-lane,
// 256-block segment) cell, the two largest |x| as (signed value,
// segment-local block), alone or fused behind the bit-masked compensate.
//
// Replaces the TPU kernels dgc_tpu/ops/kernels.py::seg_top2_candidates
// (:1130, pallas_call :1156) and ::fused_compensate_bits_cands (:1265,
// pallas_call :1325), which share the cell function _seg_top2_block (:1184):
// per lane, the top-2 of the segment's 256 blocks in the order (|x|
// descending, block ascending), each value read back as a masked sum (so
// -0.0 reads +0.0). A segment is 32,768 flat elements starting at a
// multiple of 32,768.
//
// Design. The TPU kernel reduces a [256, 128] VMEM tile along its block
// axis (max, min-of-blocks, masked sum, twice). Spread over a GPU block,
// every such reduction crosses warps: a shared-memory round trip with
// barriers per reduction. Here nothing is reduced inside the stream:
//   * A cell is (lane l, record row j): the 32 elements s0 + (32j + i) *
//     128 + l, i = 0..31. Their 32 keep bits are bits i of one record
//     word, (s0 >> 12) * 128 + j * 128 + l. A block of 256 threads covers
//     one segment: warp j owns record row j, thread q of the warp the four
//     lanes 4q..4q+3, so it reads one int4 word group and 16-byte float4s,
//     neighbouring threads on neighbouring addresses (512 B a warp a load).
//   * Each thread walks its 32 blocks in ascending order and keeps a
//     running top-2 per lane in registers (top2_push): a new entry goes
//     first only when |x| > a1, second only when |x| > a2. Strict compares
//     keep the lower block on ties, as the reference's min over blocks does.
//     The loads are unrolled in batches (kScanUnroll, kFusedUnroll), so
//     several independent 16-byte loads per thread are in flight before the
//     first compare.
//   * One merge at the end: the 8 row partials of each lane go through
//     shared memory and are pushed in row (= block) order into one top-2,
//     the first entry before the second. Every entry of a later partial has
//     a higher block, so the strict rule still gives ties to the lower
//     block. Then [2, 128] values (x + 0.0f, so -0.0 reads +0.0) and blocks
//     are written once.
// Both kernels run that one lane scan (scan_blocks) and merge
// (emit_segment), so their candidates agree bitwise by construction. The fused kernel
// compensates each element first (dgc::compensate, compensate.cuh: m' and
// v' bitwise the Triton compensate_bits), stores m' and v' in place as
// float4s and scans the stored v'.
// State is f32 or bf16 (the bf16 error-feedback memory; a template flag of
// both kernels): a quad of four bf16 is one 8-byte load, widened to f32
// (exact), and the fused kernel rounds m' and v' to nearest even as it
// stores them and scans the stored (rounded) v', so its candidates stay
// bitwise the standalone kernel's on the stored velocity. The compares and
// the candidates are f32 either way. The ragged tail past the last whole
// segment (T % 32,768, e.g. 2,048 at ResNet-50) is compensated by the same
// launch, masked per 128-lane block, and emits no candidate; its record
// words exist only for its first rows. NaN inputs are outside the contract:
// the reference's max over blocks is then NaN and matches no block.
//
// Bound on the card: bytes. The fused pass reads g, m, v and writes m', v'
// (20 B per element), reads the record (T / 8 B) and writes 2 KB of
// candidates per segment: 541 MB at ResNet-50's T = 27,068,416, 0.16 ms
// at 3.35 TB/s; with bf16 state 12 B per element, 0.098 ms. The standalone
// pass reads each bucket once (4 B per element, 2 for bf16) and writes 2 KB
// per segment. The compares (about 3 per element) are far below the f32
// rate.
//
// Offsets: the segment, element, record-word and candidate offsets are
// long long throughout (seg, e0, w0, rem, o below), so this one form serves
// buffers of 2**31 elements or more as well; the launch counts (segments a
// call, at most 2**31 - 1) are the only ints. Held bitwise over a whole
// 2.17e9-element buffer by chip_smoke.py's phase_large_layout.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "compensate.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kRows = 8;          // record rows (32 blocks each) a segment
constexpr int kThreads = 256;     // kRows warps of 32 threads x 4 lanes
constexpr long long kSpan = 32768;
// Loads per thread in flight in one batch of each kernel, and the blocks
// each SM must hold (launch bounds: at most 128 registers a thread).
constexpr int kScanUnroll = 16;
constexpr int kFusedUnroll = 4;
constexpr int kMinBlocks = 2;
static_assert(32 % kScanUnroll == 0 && 32 % kFusedUnroll == 0,
              "a batch of loads must divide a record row");

// Four consecutive state elements: a float4, or four bf16 in a uint2.
template <bool BF16>
using Quad = typename std::conditional<BF16, uint2, float4>::type;

__device__ __forceinline__ float4 widen(float4 x) { return x; }
__device__ __forceinline__ float4 widen(uint2 w) {
  return dgc::bf16x4_unpack(w);
}

// Store a quad of state; returns the stored values as f32 (rounded to
// bf16 where the state is bf16).
__device__ __forceinline__ float4 store_quad(float4* p, float4 x) {
  *p = x;
  return x;
}
__device__ __forceinline__ float4 store_quad(uint2* p, float4 x) {
  const uint2 w = dgc::bf16x4_pack(x);
  *p = w;
  return dgc::bf16x4_unpack(w);
}

// A running top-2 of one lane: |x|, the signed value and the block.
struct Top2 {
  float a1, x1, a2, x2;
  int b1, b2;
};

__device__ __forceinline__ void top2_init(Top2& t) {
  t.a1 = t.a2 = -1.0f;
  t.x1 = t.x2 = 0.0f;
  t.b1 = t.b2 = 0;
}

// Push (x, block) that comes after every entry pushed so far.
__device__ __forceinline__ void top2_push(Top2& t, float x, int b) {
  const float a = fabsf(x);
  if (a > t.a1) {
    t.a2 = t.a1;
    t.x2 = t.x1;
    t.b2 = t.b1;
    t.a1 = a;
    t.x1 = x;
    t.b1 = b;
  } else if (a > t.a2) {
    t.a2 = a;
    t.x2 = x;
    t.b2 = b;
  }
}

// The lane scan: push U consecutive blocks b0 .. b0 + U - 1 of the
// thread's four lanes, in ascending block order.
template <int U>
__device__ __forceinline__ void scan_blocks(Top2 (&t)[4],
                                            const float4 (&x)[U], int b0) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    top2_push(t[0], x[u].x, b0 + u);
    top2_push(t[1], x[u].y, b0 + u);
    top2_push(t[2], x[u].z, b0 + u);
    top2_push(t[3], x[u].w, b0 + u);
  }
}

// The compensate of one float4 of block i of a record row, whose keep bits
// are bits i of the four record words w.
__device__ __forceinline__ void compensate4(float4 g, float4& m, float4& v,
                                            int4 w, int i, float momentum,
                                            bool nesterov, bool mask_momentum) {
  dgc::compensate(g.x, m.x, v.x, dgc::keep_bit(w.x, i), momentum, nesterov,
                  mask_momentum);
  dgc::compensate(g.y, m.y, v.y, dgc::keep_bit(w.y, i), momentum, nesterov,
                  mask_momentum);
  dgc::compensate(g.z, m.z, v.z, dgc::keep_bit(w.z, i), momentum, nesterov,
                  mask_momentum);
  dgc::compensate(g.w, m.w, v.w, dgc::keep_bit(w.w, i), momentum, nesterov,
                  mask_momentum);
}

// The row partials of one segment: [row][lane] per field.
struct Partials {
  float x1[kRows][kLane];
  float x2[kRows][kLane];
  int b1[kRows][kLane];
  int b2[kRows][kLane];
};

// Merge the 8 row partials of each lane in row order and write the
// segment's [2, 128] values and blocks at cv/cb + seg * 256. Called by the
// whole block (one barrier).
__device__ __forceinline__ void emit_segment(const Top2 (&t)[4], Partials& sh,
                                             int j, int q, long long seg,
                                             float* __restrict__ cv,
                                             int* __restrict__ cb) {
  *reinterpret_cast<float4*>(&sh.x1[j][4 * q]) =
      make_float4(t[0].x1, t[1].x1, t[2].x1, t[3].x1);
  *reinterpret_cast<float4*>(&sh.x2[j][4 * q]) =
      make_float4(t[0].x2, t[1].x2, t[2].x2, t[3].x2);
  *reinterpret_cast<int4*>(&sh.b1[j][4 * q]) =
      make_int4(t[0].b1, t[1].b1, t[2].b1, t[3].b1);
  *reinterpret_cast<int4*>(&sh.b2[j][4 * q]) =
      make_int4(t[0].b2, t[1].b2, t[2].b2, t[3].b2);
  __syncthreads();
  const int l = threadIdx.x;
  if (l < kLane) {
    Top2 r;
    top2_init(r);
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      top2_push(r, sh.x1[p][l], sh.b1[p][l]);
      top2_push(r, sh.x2[p][l], sh.b2[p][l]);
    }
    const long long o = seg * 2 * kLane + l;
    cv[o] = __fadd_rn(r.x1, 0.0f);
    cv[o + kLane] = __fadd_rn(r.x2, 0.0f);
    cb[o] = r.b1;
    cb[o + kLane] = r.b2;
  }
}

// The standalone kernel: segment blockIdx.x of x (a whole number of
// segments from x).
template <bool BF16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_top2_kernel(const Quad<BF16>* __restrict__ x, float* __restrict__ cv,
                int* __restrict__ cb) {
  __shared__ Partials sh;
  const long long seg = blockIdx.x;
  const int j = threadIdx.x >> 5, q = threadIdx.x & 31;
  // the quad of lanes 4q..4q+3 in block 32j of the segment
  const Quad<BF16>* src = x + seg * (kSpan / 4) + j * 32 * (kLane / 4) + q;
  Top2 t[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) top2_init(t[e]);
#pragma unroll
  for (int i0 = 0; i0 < 32; i0 += kScanUnroll) {
    float4 r[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u)
      r[u] = widen(__ldg(src + (i0 + u) * (kLane / 4)));
    scan_blocks(t, r, 32 * j + i0);
  }
  emit_segment(t, sh, j, q, seg, cv, cb);
}

// The fused kernel: compensate segment blockIdx.x of the [n] state
// (m, v updated in place) and emit its candidates if it is whole.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
compensate_bits_cands_kernel(const float4* __restrict__ g,
                             Quad<BF16>* __restrict__ m,
                             Quad<BF16>* __restrict__ v,
                             const int4* __restrict__ bits, long long n,
                             float momentum, int nesterov, int mask_momentum,
                             float* __restrict__ cv, int* __restrict__ cb) {
  __shared__ Partials sh;
  const long long seg = blockIdx.x;
  const int j = threadIdx.x >> 5, q = threadIdx.x & 31;
  const long long e0 = seg * (kSpan / 4) + j * 32 * (kLane / 4) + q;
  // the int4 of record words (8 seg + j) * 128 + 4q .. + 3
  const long long w0 = (seg * kRows + j) * (kLane / 4) + q;
  const long long rem = n - seg * kSpan;
  if (rem >= kSpan) {  // a whole segment (block-uniform branch)
    const int4 w = bits[w0];
    Top2 t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) top2_init(t[e]);
#pragma unroll
    for (int i0 = 0; i0 < 32; i0 += kFusedUnroll) {
      float4 gg[kFusedUnroll], mm[kFusedUnroll], vv[kFusedUnroll];
#pragma unroll
      for (int u = 0; u < kFusedUnroll; ++u) {
        const long long e = e0 + (i0 + u) * (kLane / 4);
        gg[u] = __ldg(g + e);
        mm[u] = widen(m[e]);
        vv[u] = widen(v[e]);
      }
#pragma unroll
      for (int u = 0; u < kFusedUnroll; ++u) {
        const long long e = e0 + (i0 + u) * (kLane / 4);
        compensate4(gg[u], mm[u], vv[u], w, i0 + u, momentum, nesterov,
                    mask_momentum);
        store_quad(m + e, mm[u]);
        vv[u] = store_quad(v + e, vv[u]);
      }
      scan_blocks(t, vv, 32 * j + i0);
    }
    emit_segment(t, sh, j, q, seg, cv, cb);
    return;
  }
  // the ragged tail: rem / 128 whole 128-lane blocks (n is lane-aligned);
  // record row j exists only if its first block does
  const int nblk = (int)(rem / kLane);
  if (32 * j >= nblk) return;
  const int4 w = bits[w0];
  for (int i = 0; i < 32 && 32 * j + i < nblk; ++i) {
    const long long e = e0 + i * (kLane / 4);
    float4 mm = widen(m[e]), vv = widen(v[e]);
    compensate4(g[e], mm, vv, w, i, momentum, nesterov, mask_momentum);
    store_quad(m + e, mm);
    store_quad(v + e, vv);
  }
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// x: nseg whole segments of f32, or of bf16 where bf16 (nseg * 32768
// elements, aligned to a quad: 16 bytes, 8 for bf16); cv: [nseg, 2, 128]
// f32; cb: [nseg, 2, 128] int32. Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int seg_top2_launch(const void* x, int nseg, float* cv, int* cb,
                               int bf16, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (nseg <= 0) return 0;
  if ((uintptr_t)x % (bf16 ? 8 : 16)) return (int)cudaErrorInvalidValue;
  if (bf16)
    seg_top2_kernel<true><<<nseg, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint2*>(x), cv, cb);
  else
    seg_top2_kernel<false><<<nseg, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float4*>(x), cv, cb);
  return (int)cudaGetLastError();
}

// g: [n] f32, 16-byte aligned; m, v: [n] f32, or bf16 where bf16 (updated
// in place; 16-byte aligned, 8 for bf16), n a multiple of 128; bits: the
// transmit record [ceil(n / 4096) * 128] int32 (16-byte aligned); cv, cb:
// [n / 32768, 2, 128] f32 / int32. Returns the CUDA error code of the
// launch (0 = launched).
extern "C" int compensate_bits_cands_launch(
    const float* g, void* m, void* v, const int* bits, long long n,
    float momentum, int nesterov, int mask_momentum, float* cv, int* cb,
    int bf16, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (n % kLane || ((uintptr_t)g | (uintptr_t)bits) % 16 ||
      ((uintptr_t)m | (uintptr_t)v) % (bf16 ? 8 : 16))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + kSpan - 1) / kSpan);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const int4* b4 = reinterpret_cast<const int4*>(bits);
  if (bf16)
    compensate_bits_cands_kernel<true>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            g4, static_cast<uint2*>(m), static_cast<uint2*>(v), b4, n,
            momentum, nesterov, mask_momentum, cv, cb);
  else
    compensate_bits_cands_kernel<false>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            g4, static_cast<float4*>(m), static_cast<float4*>(v), b4, n,
            momentum, nesterov, mask_momentum, cv, cb);
  return (int)cudaGetLastError();
}
