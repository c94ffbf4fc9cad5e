// Exact per-row top-k for Hopper (sm_90a), in lax.top_k order.
//
// Replaces the TPU kernel dgc_tpu/ops/kernels.py::topk_rows (Pallas
// iterative max extraction, k <= 128). The engine selects exactly at every
// k of the warm-up schedule (up to 11,658 of 36,864 columns for ResNet-20),
// so the TPU design — k sequential passes over a VMEM-resident block — does
// not carry over.
//
// Bound on the card: bytes (each row read once, k (value, column) pairs
// written); the selection is a few operations per element. At the engine's
// shapes (2-17 rows, 95-36,864 columns) the bound is 2-450 ns, so what
// costs is latency: dependent shared-memory round trips and barriers, and
// the sort of large k. The design (selection core: topk_select.cuh) keeps
// every pass on chip and sizes the threads that own a row to the row, by
// the route that kernels.topk_plan picks (sized with topk_bench.py):
//   - "sort": a row of at most 512 columns is sorted whole (every column's
//     word) by a block of one thread for every two columns (one warp up
//     to 64 columns, 8 at 512), no selection at all.
//   - "block": one block of 256-1,024 threads radix-selects in a row.
//   - "cluster": a thread-block cluster of 2-8 blocks splits each of a few
//     wide rows, so more SMs work; the blocks sum their histograms and
//     place their survivors in column order through distributed shared
//     memory, and block 0 sorts the k survivors.
// The survivors of a selection are radix-sorted through global scratch
// from 2,048 sort words on, else bitonic-sorted in registers and shared
// memory. The row (or the block's slice) is staged once into shared
// memory with 16-byte loads of the 16-byte-aligned span that covers it,
// so no pass goes back to L2; a slice that does not fit beside the sort
// buffer is read from global memory instead ("staged" = 0). Values are
// read back from the row, so -0.0 keeps its sign. NaN input is
// unspecified, as it is for the TPU kernel.
//
// Shared memory per block: the scratch, the staged slice, the sort buffer
// of next_pow2(k) words (and a pad word every 16), so k <= 16,384 (the
// wrapper raises above), and for the radix sort 256 counters a warp.
//
// The kernel's body is topk::select_rows() (topk_select.cuh), which the
// select-and-pack kernels share; the row policy here ranks the row's
// floats as they are and writes each selected one with its column.

#include "topk_select.cuh"

namespace {

// The top-k row policy (see topk::select_rows): keys are the floats' own
// order keys, values are read back from x.
struct TopkRows : topk::ReadRows {
  float* out_v;
  int* out_i;
  __device__ __forceinline__ uint32_t key(uint32_t bits, int) const {
    return topk::order_key(bits);
  }
  __device__ __forceinline__ void emit(size_t o, int c, float v,
                                       uint32_t) const {
    out_i[o] = c;
    out_v[o] = v;
  }
};

template <bool CLUSTER, bool STAGED>
__global__ void __launch_bounds__(1024)
topk_rows_kernel(TopkRows p, unsigned long long* tmp, topk::Rows geo) {
  topk::select_rows<CLUSTER, STAGED>(p, tmp, geo);
}

// the dynamic shared memory each variant may use on each device
int g_smem_set[4][topk::kMaxDevices];

template <bool CLUSTER, bool STAGED>
cudaError_t launch(const TopkRows& p, unsigned long long* tmp,
                   const topk::Rows& geo, int grid, int threads, int cluster,
                   int smem, int device, cudaStream_t stream) {
  return topk::launch_rows(topk_rows_kernel<CLUSTER, STAGED>,
                           g_smem_set[2 * CLUSTER + STAGED][device], grid,
                           threads, cluster, smem, stream, p, tmp, geo);
}

}  // namespace

// x: [rows, cols] f32 contiguous; out_v: [rows, k] f32; out_i: [rows, k]
// int32; tmp: [rows, padded] words of scratch for the radix sort, or null
// for the bitonic sort; the geometry is kernels.topk_plan's (one block a
// row, or `cluster` blocks a row on the cluster route). Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int topk_rows_launch(const float* x, float* out_v, int* out_i,
                                void* tmp, int rows, int cols, int k,
                                int cluster, int threads, int slice,
                                int staged, int stage_words, int padded,
                                int sort_all, int smem, int device,
                                void* stream) {
  cudaError_t err = topk::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0 || k == 0) return 0;
  TopkRows p{};
  p.x = x;
  p.out_v = out_v;
  p.out_i = out_i;
  const topk::Rows geo{cols, k, slice, stage_words, padded, sort_all};
  auto run = [&](auto kernel_launch) {
    return kernel_launch(p, (unsigned long long*)tmp, geo, rows * cluster,
                         threads, cluster, smem, device,
                         (cudaStream_t)stream);
  };
  if (cluster > 1) {
    err = staged ? run(launch<true, true>) : run(launch<true, false>);
  } else {
    err = staged ? run(launch<false, true>) : run(launch<false, false>);
  }
  return (int)err;
}
