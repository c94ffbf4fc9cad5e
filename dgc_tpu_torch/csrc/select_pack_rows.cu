// Fused threshold -> select -> pack over a bucket's rows, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels dgc_tpu/ops/kernels.py::select_pack_rows
// (_select_pack_kernel, k <= 128 in one VMEM block) and
// ::_select_pack_rows_mr (_select_pack_mr_kernel, 128 < k <= 1024 or wide
// rows, 16K-column chunks with a running carry). The TPU splits the two
// only to fit its VMEM budget and its 128-lane output block; here one
// kernel covers 0 < k <= 1024 at any width.
//
// Per row r of x [R, cols]: importance imp(c) = c < numels[r] ? |x[r, c]|
// : -1 (computed on the fly, never written), the k most important columns
// in lax.top_k order (importance descending, ties to the lower column),
// and for each (score, signed value, int32 column). The value is read back
// as x + 0.0f, so a selected -0.0 is written +0.0, as the Pallas kernels'
// one-hot masked sum reads it.
//
// Bound on the card: bytes (the row read once, 12 B per selected slot
// written); the selection is a few compares per element. At the paths'
// shapes (6-17 rows of 512-131,072 columns) the bound is 0.2-4 us, so
// what costs is latency. The kernel is the top-k kernel's (topk_rows.cu)
// with another row policy: the body topk::select_rows() (topk_select.cuh)
// on the route and geometry of kernels.topk_plan: a row of at most 512
// columns sorted whole by one block; a wider row staged once into a
// block's shared memory and radix-selected there; a wide row of a bucket
// that would leave most SMs idle split over a cluster of 2-8 blocks (its
// blocks sum their histograms and place their survivors in block 0's
// buffer through distributed shared memory, and block 0 sorts them and
// reads the values of other slices back from x, which is read-only). The
// k <= 1024 survivors are bitonic-sorted in registers and shared memory.
// A slice too wide to stage is read from global memory. The policy keys
// column c by the masked |x| (the tail's -1 included) and writes the
// three outputs. NaN input is unspecified, as it is for the TPU kernels.

#include "topk_select.cuh"

namespace {

// The select-and-pack row policy over x (see topk::select_rows).
struct SelectRows : topk::ReadRows, topk::PackRows {
  __device__ __forceinline__ void begin(int r, int cols) {
    ReadRows::begin(r, cols);
    begin_row(r);
  }
};

template <bool CLUSTER, bool STAGED>
__global__ void __launch_bounds__(1024)
select_pack_rows_kernel(SelectRows p, topk::Rows geo) {
  topk::select_rows<CLUSTER, STAGED>(p, nullptr, geo);
}

// the dynamic shared memory each variant may use on each device
int g_smem_set[4][topk::kMaxDevices];

template <bool CLUSTER, bool STAGED>
cudaError_t launch(const SelectRows& p, const topk::Rows& geo, int grid,
                   int threads, int cluster, int smem, int device,
                   cudaStream_t stream) {
  return topk::launch_rows(select_pack_rows_kernel<CLUSTER, STAGED>,
                           g_smem_set[2 * CLUSTER + STAGED][device], grid,
                           threads, cluster, smem, stream, p, geo);
}

}  // namespace

// x: [rows, cols] f32 contiguous; numels: [rows] int32; 0 < k <= min(cols,
// 1024); out_s, out_v: [rows, k] f32; out_i: [rows, k] int32; the geometry
// is kernels.topk_plan's, bitonic-sorted (padded <= 1,024 words, or the
// whole row on the sort route). Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int select_pack_rows_launch(const float* x, const int* numels,
                                       float* out_s, float* out_v,
                                       int* out_i, int rows, int cols, int k,
                                       int cluster, int threads, int slice,
                                       int staged, int stage_words,
                                       int padded, int sort_all, int smem,
                                       int device, void* stream) {
  cudaError_t err = topk::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  if (k < 1 || k > 1024 || k > cols) return (int)cudaErrorInvalidValue;
  SelectRows p{};
  p.numels = numels;
  p.out_s = out_s;
  p.out_v = out_v;
  p.out_i = out_i;
  p.x = x;
  const topk::Rows geo{cols, k, slice, stage_words, padded, sort_all};
  auto run = [&](auto kernel_launch) {
    return kernel_launch(p, geo, rows * cluster, threads, cluster, smem,
                         device, (cudaStream_t)stream);
  };
  if (cluster > 1) {
    err = staged ? run(launch<true, true>) : run(launch<true, false>);
  } else {
    err = staged ? run(launch<false, true>) : run(launch<false, false>);
  }
  return (int)err;
}
