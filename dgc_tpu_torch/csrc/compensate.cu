// Momentum correction and local accumulation of many tensors in one launch,
// for Hopper (sm_90a): for every entry of a table of (g, m, v[, sent], n),
//   keep = (sent == 0)                      (the masked form only)
//   m0 = m * keep (under momentum masking), v0 = v * keep
//   m' = momentum * m0 + g,       v' = v0 + m'          (or, nesterov:
//   m' = (m0 + g) * momentum,     v' = v0 + m' + g)
// with m and v updated in place, f32 or bf16 state (math in f32, one
// round-to-nearest-even per stored value).
//
// Replaces the TPU kernels dgc_tpu/ops/kernels.py::fused_compensate
// (_compensate_kernel :156, pallas_call :200) and ::fused_compensate_masked
// (_compensate_masked_kernel :252, pallas_call :305). The TPU pads each
// buffer to 16 x 128 tiles and walks one tensor per pallas_call; the
// reference's per-tensor memory calls it once per compressed tensor.
//
// What bounds it on this card. Per element the pass moves 20 B (f32 state)
// or 12 B (bf16), plus 4 B of count vector when masked: bytes. But the
// per-tensor path's tensors are small (ResNet-20: 22 of 432 to 36,864
// elements a worker, 8.6 to 737 KB a call), so a launch a tensor costs the
// launch (2-3 us against a summed byte bound of 1.6 us for all 22). So:
//   * One launch takes a table of up to kMaxEntries tensors in its
//     parameters (no device-side table, no host-to-device copy, nothing
//     synchronises). Each entry owns whole blocks: entry e owns blocks
//     [block0[e], block0[e + 1]), found by a binary search over the block
//     prefix, so no block spans two tensors. More tensors make more
//     launches (kernels.compensate_plan splits the table). A launch of
//     kFewEntries or fewer (fused_compensate's one tensor) passes a table
//     of that capacity: 4 KB of parameters cost a small tensor's launch
//     time.
//   * A block covers 4,096 elements in quads (16-byte float4s of g, m, v
//     and sent; 8-byte groups of four bf16 for bf16 state): 512 threads
//     that issue the loads of their 2 quads at once, or, when masked, 256
//     threads of 4 quads loaded 2 at a time; at most 64 registers a
//     thread, no spill. How many loads a thread keeps in flight decides
//     the large tensors' time: all of 4 quads (256 threads) lost L2-warm,
//     2 quads then 2 more lost from DRAM; 2 at once, 512 threads, came
//     closest to the Triton kernel it replaces both ways (PERF.md, PR 9).
//     g and sent are read through ld.global.ca like the state.
//   * The vector body starts at element `head` (0-3), where every stream
//     of the entry is aligned (16 bytes for f32 streams, 8 for bf16
//     state); block 0 of the entry does the scalar head and the ragged
//     tail (at most 3 elements each). The host picks head from the
//     pointers (head < 0: the entry runs scalar, 16 elements a thread), so
//     any view offset runs copy-free.
//   * The arithmetic is compensate.cuh's, written with __fmul_rn /
//     __fadd_rn, which nvcc never contracts into an FMA; the unmasked form
//     multiplies by no keep factor. The bf16 store is __float2bfloat16_rn,
//     the conversion PyTorch's own cast uses on sm_80+, so the card agrees
//     with the plain version bit for bit, NaNs included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "compensate.cuh"

namespace {

constexpr int kMaxEntries = 96;
constexpr int kFewEntries = 4;
constexpr int kTileQuads = 1024;                // 4,096 elements a block
constexpr int kBatch = 2;                       // quads a thread loads first
// Threads a block: the unmasked form's 512 threads each load their 2 quads
// of g, m and v at once; the masked form's fourth stream takes 256 threads
// of 4 quads, loaded 2 at a time (kBatch).
template <bool MASKED>
constexpr int kThreads = MASKED ? 256 : 512;
template <bool MASKED>
constexpr int kUnroll = kTileQuads / kThreads<MASKED>;   // quads a thread

// The launch's table of up to CAP entries, passed by value in the kernel
// parameters (kept under the classic 4 KB parameter limit).
template <int CAP>
struct Table {
  const float* g[CAP];
  void* m[CAP];
  void* v[CAP];
  const float* sent[CAP];
  int n[CAP];
  int block0[CAP + 1];
  signed char head[CAP];
  int count;
};
static_assert(sizeof(Table<kMaxEntries>) + 16 <= 4096,
              "the table must fit the 4 KB of kernel parameters");

// The state's loads and stores: f32, or bf16 up-cast on load and rounded
// to nearest even on store. A quad is four elements. The table's pointers
// are generic, so the accesses name the global space themselves (__ldca,
// __stwb: ld.global.ca / st.global.wb, the default caching).
template <bool BF16>
struct StateIO {
  static __device__ __forceinline__ void* at(void* p, int i) {
    return static_cast<float*>(p) + i;
  }
  static __device__ __forceinline__ float4 load4(const void* p, int q) {
    return __ldca(static_cast<const float4*>(p) + q);
  }
  static __device__ __forceinline__ void store4(void* p, int q, float4 x) {
    __stwb(static_cast<float4*>(p) + q, x);
  }
  static __device__ __forceinline__ float load1(const void* p, int i) {
    return __ldca(static_cast<const float*>(p) + i);
  }
  static __device__ __forceinline__ void store1(void* p, int i, float x) {
    __stwb(static_cast<float*>(p) + i, x);
  }
};

template <>
struct StateIO<true> {
  static __device__ __forceinline__ void* at(void* p, int i) {
    return static_cast<__nv_bfloat16*>(p) + i;
  }
  static __device__ __forceinline__ float4 load4(const void* p, int q) {
    return dgc::bf16x4_unpack(__ldca(static_cast<const uint2*>(p) + q));
  }
  static __device__ __forceinline__ void store4(void* p, int q, float4 x) {
    __stwb(static_cast<uint2*>(p) + q, dgc::bf16x4_pack(x));
  }
  static __device__ __forceinline__ float load1(const void* p, int i) {
    const unsigned short h =
        __ldca(static_cast<const unsigned short*>(p) + i);
    return dgc::bf16_value(h);
  }
  static __device__ __forceinline__ void store1(void* p, int i, float x) {
    __stwb(static_cast<unsigned short*>(p) + i, (unsigned short)dgc::bf16_bits(x));
  }
};

// One element: the keep mask where MASKED, then the momentum correction.
template <bool MASKED>
__device__ __forceinline__ void compensate1(float g, float& m, float& v,
                                            float sent, float momentum,
                                            bool nesterov,
                                            bool mask_momentum) {
  if (MASKED)
    dgc::compensate(g, m, v, sent == 0.0f ? 1.0f : 0.0f, momentum, nesterov,
                    mask_momentum);
  else
    dgc::momentum_correct(g, m, v, momentum, nesterov);
}

template <bool MASKED>
__device__ __forceinline__ void compensate4(float4 g, float4& m, float4& v,
                                            float4 s, float momentum,
                                            bool nesterov,
                                            bool mask_momentum) {
  compensate1<MASKED>(g.x, m.x, v.x, s.x, momentum, nesterov, mask_momentum);
  compensate1<MASKED>(g.y, m.y, v.y, s.y, momentum, nesterov, mask_momentum);
  compensate1<MASKED>(g.z, m.z, v.z, s.z, momentum, nesterov, mask_momentum);
  compensate1<MASKED>(g.w, m.w, v.w, s.w, momentum, nesterov, mask_momentum);
}

template <bool BF16, bool MASKED, int CAP>
__global__ void __launch_bounds__(kThreads<MASKED>, 1024 / kThreads<MASKED>)
compensate_multi_kernel(const __grid_constant__ Table<CAP> t, float momentum,
                        int nesterov, int mask_momentum) {
  using IO = StateIO<BF16>;
  // the entry that owns this block: the last e with block0[e] <= block
  const int b = blockIdx.x;
  int e = 0, hi = t.count - 1;
  while (e < hi) {
    const int mid = (e + hi + 1) >> 1;
    if (t.block0[mid] <= b) e = mid; else hi = mid - 1;
  }
  const int blk = b - t.block0[e];
  const float* g = t.g[e];
  const float* s = t.sent[e];
  void* m = t.m[e];
  void* v = t.v[e];
  const int n = t.n[e];
  const int head = t.head[e];

  constexpr int T = kThreads<MASKED>;
  if (head >= 0) {
    const int nq = (n - head) >> 2;
    // this thread's quads: q0 + u * T, u < kUnroll, those below nq
    const int q0 = blk * kTileQuads + threadIdx.x;
    const int rem = nq - q0;
    const float4* gq = reinterpret_cast<const float4*>(g + head) + q0;
    const float4* sq = reinterpret_cast<const float4*>(s + head) + q0;
    void* mq = IO::at(m, head + 4 * q0);
    void* vq = IO::at(v, head + 4 * q0);
#pragma unroll
    for (int u0 = 0; u0 < kUnroll<MASKED>; u0 += kBatch) {
      float4 gx[kBatch], mx[kBatch], vx[kBatch], sx[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int o = (u0 + u) * T;
        if (o < rem) {
          gx[u] = __ldca(gq + o);
          mx[u] = IO::load4(mq, o);
          vx[u] = IO::load4(vq, o);
          sx[u] = MASKED ? __ldca(sq + o) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int o = (u0 + u) * T;
        if (o < rem) {
          compensate4<MASKED>(gx[u], mx[u], vx[u], sx[u], momentum, nesterov,
                              mask_momentum);
          IO::store4(mq, o, mx[u]);
          IO::store4(vq, o, vx[u]);
        }
      }
    }
    // block 0: threads 0-3 the scalar head [0, head), threads 4-7 the tail
    // [head + 4 nq, n)
    if (blk == 0 && threadIdx.x < 8) {
      const int i = threadIdx.x < 4 ? threadIdx.x
                                    : head + 4 * nq + (threadIdx.x - 4);
      if (threadIdx.x < 4 ? i < head : i < n) {
        float mi = IO::load1(m, i), vi = IO::load1(v, i);
        compensate1<MASKED>(g[i], mi, vi, MASKED ? s[i] : 0.0f, momentum,
                            nesterov, mask_momentum);
        IO::store1(m, i, mi);
        IO::store1(v, i, vi);
      }
    }
  } else {
    // an entry whose streams share no alignment: 4,096 / T scalars a
    // thread, 8 loaded at a time
    constexpr int kScalars = 8;
    const int i0 = blk * (4 * kTileQuads) + threadIdx.x;
#pragma unroll
    for (int u0 = 0; u0 < 4 * kUnroll<MASKED>; u0 += kScalars) {
      float gx[kScalars], mx[kScalars], vx[kScalars], sx[kScalars];
#pragma unroll
      for (int u = 0; u < kScalars; ++u) {
        const int i = i0 + (u0 + u) * T;
        if (i < n) {
          gx[u] = __ldca(g + i);
          mx[u] = IO::load1(m, i);
          vx[u] = IO::load1(v, i);
          sx[u] = MASKED ? __ldca(s + i) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kScalars; ++u) {
        const int i = i0 + (u0 + u) * T;
        if (i < n) {
          compensate1<MASKED>(gx[u], mx[u], vx[u], sx[u], momentum, nesterov,
                              mask_momentum);
          IO::store1(m, i, mx[u]);
          IO::store1(v, i, vx[u]);
        }
      }
    }
  }
}

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

// Fills a table of capacity CAP and launches the kernel of that capacity.
template <int CAP>
cudaError_t launch(const long long* ptrs, const int* n, const int* block0,
                   const signed char* head, int count, int bf16, int masked,
                   float momentum, int nesterov, int mask_momentum,
                   cudaStream_t st) {
  Table<CAP> t = {};
  for (int e = 0; e < count; ++e) {
    t.g[e] = reinterpret_cast<const float*>(ptrs[4 * e]);
    t.m[e] = reinterpret_cast<void*>(ptrs[4 * e + 1]);
    t.v[e] = reinterpret_cast<void*>(ptrs[4 * e + 2]);
    t.sent[e] = reinterpret_cast<const float*>(ptrs[4 * e + 3]);
    t.n[e] = n[e];
    t.block0[e] = block0[e];
    t.head[e] = head[e];
  }
  t.block0[count] = block0[count];
  t.count = count;
  const int blocks = block0[count];
  if (masked) {
    auto kernel = bf16 ? compensate_multi_kernel<true, true, CAP>
                       : compensate_multi_kernel<false, true, CAP>;
    kernel<<<blocks, kThreads<true>, 0, st>>>(t, momentum, nesterov,
                                             mask_momentum);
  } else {
    auto kernel = bf16 ? compensate_multi_kernel<true, false, CAP>
                       : compensate_multi_kernel<false, false, CAP>;
    kernel<<<blocks, kThreads<false>, 0, st>>>(t, momentum, nesterov,
                                              mask_momentum);
  }
  return cudaGetLastError();
}

}  // namespace

// One launch over `count` (1 to 96) entries: ptrs holds 4 addresses an
// entry (g, m, v, sent; sent 0 unless masked), n the elements, block0 the
// count + 1 block prefix (block0[count] blocks in all), head each entry's
// scalar head before its vector body (-1: all scalar); all host arrays,
// as kernels.compensate_plan builds them. bf16: the state is bf16, else
// f32. Returns the CUDA error code of the launch (0 = launched).
extern "C" int compensate_multi_launch(const long long* ptrs, const int* n,
                                       const int* block0,
                                       const signed char* head, int count,
                                       int bf16, int masked, float momentum,
                                       int nesterov, int mask_momentum,
                                       int device, void* stream) {
  if (count < 1 || count > kMaxEntries) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (block0[count] <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(count <= kFewEntries
                   ? launch<kFewEntries>(ptrs, n, block0, head, count, bf16,
                                         masked, momentum, nesterov,
                                         mask_momentum, st)
                   : launch<kMaxEntries>(ptrs, n, block0, head, count, bf16,
                                         masked, momentum, nesterov,
                                         mask_momentum, st));
}
