// The forward megakernel for Hopper (sm_90a): masked error-feedback
// compensate, then exact select and pack, per bucket row in one launch.
//
// Replaces the TPU kernel dgc_tpu/ops/kernels.py::dgc_forward_rows (body
// _dgc_forward_kernel). Per row r of a bucket of `rows` x `cols` at flat
// offset `base`:
//   (a) compensate: each element's keep bit comes from the full transmit
//       record at its flat position p = base + r * cols + c (word
//       (p >> 12) * 128 + (p & 127), bit (p >> 7) & 31; words past the
//       record read 0), and m' = momentum * m * keep + g, v' = v * keep +
//       m' (or the nesterov form) are written in place, once —
//       _compensate_math (kernels.py:471), op by op;
//   (b) select and pack v' exactly as select_pack_rows.cu does: scores
//       |v'| (row tail -1, though the tail is compensated too), signed
//       values (-0.0 written +0.0) and int32 columns of the k <= 1024 most
//       important entries.
//
// Numerics: the compensate is dgc::compensate() (compensate.cuh, shared
// with seg_top2.cu), so m' and v' are bitwise the Triton compensate_bits
// and the plain version.
//
// Bound on the card: bytes — g, m, v read and m', v' written (20 B per
// element) plus the record's bits, and 12 B per selected slot. The kernel
// is the top-k kernel's (topk_rows.cu) with another row policy: the body
// topk::select_rows() (topk_select.cuh) on kernels.topk_plan's route and
// geometry, a block a row or a cluster of 2-8 blocks a wide row. Phase (a)
// is how a block prepares its slice: it streams g, m, v with 16-byte
// loads (a slice is a multiple of 4 columns and cols of 128, so a float4
// shares one record row), writes m' and v' to global memory and stages
// v' in shared memory, and the selection then reads only the stage, never
// L2 (the planner stages every row the megakernel's gate admits, up to
// 131,072 columns; the launch refuses an unstaged plan). v is written in
// this launch, so on the cluster route the sorting block reads other
// slices' values from their owners' stages through distributed shared
// memory, not from v, and every block waits at a last cluster barrier
// until it has.

#include "compensate.cuh"
#include "topk_select.cuh"

namespace {

using topk::Group;

// The forward row policy (see topk::select_rows): a block's slice is
// compensated, written and staged; keys and outputs as select_pack_rows'.
struct ForwardRows : topk::PackRows {
  static constexpr bool kLdg = false;
  const float4* g;
  float4* m;
  float4* v;
  const int* bits;
  long long nwords, base;
  float momentum;
  int nesterov, mask_momentum;
  size_t e0;  // the current row's first element in the region
  __device__ __forceinline__ void begin(int r, int cols) {
    e0 = (size_t)r * cols;
    begin_row(r);
  }
  // Compensates row columns [col0, col0 + n) (col0 and n multiples of 4),
  // writes m' and v', and stages v' at offset 0.
  __device__ __forceinline__ int stage(int col0, int n, uint32_t* st,
                                       const Group& grp) const {
    float4* dst = reinterpret_cast<float4*>(st);
    const size_t q0 = (e0 + col0) / 4;  // the slice's first float4
    for (int j = grp.rank; j < n / 4; j += grp.size) {
      // the four elements share one 128-lane row of the record: one word
      // each, one bit position for all four
      const long long p = base + 4 * (long long)(q0 + j);
      const long long w = (p >> 12) * 128 + (p & 127);
      const int bit = (int)((p >> 7) & 31);
      float keep[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int word = w + e < nwords ? __ldg(bits + w + e) : 0;
        keep[e] = dgc::keep_bit(word, bit);
      }
      const float4 gg = __ldg(g + q0 + j);
      float4 mm = m[q0 + j], vv = v[q0 + j];
      dgc::compensate(gg.x, mm.x, vv.x, keep[0], momentum, nesterov,
                      mask_momentum);
      dgc::compensate(gg.y, mm.y, vv.y, keep[1], momentum, nesterov,
                      mask_momentum);
      dgc::compensate(gg.z, mm.z, vv.z, keep[2], momentum, nesterov,
                      mask_momentum);
      dgc::compensate(gg.w, mm.w, vv.w, keep[3], momentum, nesterov,
                      mask_momentum);
      m[q0 + j] = mm;
      v[q0 + j] = vv;
      dst[j] = vv;
    }
    return 0;
  }
};

template <bool CLUSTER>
__global__ void __launch_bounds__(1024)
dgc_forward_rows_kernel(ForwardRows p, topk::Rows geo) {
  topk::select_rows<CLUSTER, true>(p, nullptr, geo);
}

// the dynamic shared memory each variant may use on each device
int g_smem_set[2][topk::kMaxDevices];

template <bool CLUSTER>
cudaError_t launch(const ForwardRows& p, const topk::Rows& geo, int grid,
                   int threads, int cluster, int smem, int device,
                   cudaStream_t stream) {
  return topk::launch_rows(dgc_forward_rows_kernel<CLUSTER>,
                           g_smem_set[CLUSTER][device], grid, threads,
                           cluster, smem, stream, p, geo);
}

}  // namespace

// g, m, v: the bucket's [rows * cols] f32 region (16-byte aligned; m and v
// updated in place); bits: the full transmit record [nwords] int32; base:
// the region's flat offset (a multiple of 128); numels: [rows] int32;
// out_s, out_v: [rows, k] f32; out_i: [rows, k] int32; cols a multiple of
// 128; 0 < k <= min(cols, 1024); the geometry is kernels.topk_plan's,
// staged and bitonic-sorted. Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int dgc_forward_rows_launch(
    const float* g, float* m, float* v, const int* bits, long long nwords,
    long long base, const int* numels, float* out_s, float* out_v,
    int* out_i, int rows, int cols, int k, float momentum, int nesterov,
    int mask_momentum, int cluster, int threads, int slice, int staged,
    int stage_words, int padded, int sort_all, int smem, int device,
    void* stream) {
  cudaError_t err = topk::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  if (k < 1 || k > 1024 || k > cols || cols % 128 || base % 128 ||
      slice % 4 || !staged)
    return (int)cudaErrorInvalidValue;
  ForwardRows p{};
  p.numels = numels;
  p.out_s = out_s;
  p.out_v = out_v;
  p.out_i = out_i;
  p.g = reinterpret_cast<const float4*>(g);
  p.m = reinterpret_cast<float4*>(m);
  p.v = reinterpret_cast<float4*>(v);
  p.bits = bits;
  p.nwords = nwords;
  p.base = base;
  p.momentum = momentum;
  p.nesterov = nesterov;
  p.mask_momentum = mask_momentum;
  const topk::Rows geo{cols, k, slice, stage_words, padded, sort_all};
  auto run = [&](auto kernel_launch) {
    return kernel_launch(p, geo, rows * cluster, threads, cluster, smem,
                         device, (cudaStream_t)stream);
  };
  err = cluster > 1 ? run(launch<true>) : run(launch<false>);
  return (int)err;
}
