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

#include "topk_select.cuh"

namespace {

namespace cg = cooperative_groups;
using topk::Group;
using topk::Scratch;

template <bool CLUSTER, bool STAGED>
__global__ void __launch_bounds__(1024)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ out_v,
                 int* __restrict__ out_i, unsigned long long* tmp, int cols,
                 int k, int slice, int stage_words, int padded, int sort_all) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Group g{(int)threadIdx.x, (int)blockDim.x};
  int row = blockIdx.x, col0 = 0, n = cols;
  if constexpr (CLUSTER) {
    cg::cluster_group cl = cg::this_cluster();
    row = blockIdx.x / cl.num_blocks();
    col0 = (int)cl.block_rank() * slice;
    n = max(0, min(slice, cols - col0));
  }
  Scratch& s = *reinterpret_cast<Scratch*>(smem);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + sizeof(Scratch));
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(
      smem + sizeof(Scratch) + 4 * (size_t)stage_words);
  // the radix sort's per-warp digit counters follow the sort buffer
  uint32_t* hist = reinterpret_cast<uint32_t*>(buf + padded + padded / 16);
  if (tmp != nullptr) tmp += (size_t)row * padded;
  const float* xrow = x + (size_t)row * cols;

  topk::clear_first_histogram(s, g);
  const uint32_t* keys;
  if constexpr (STAGED) {
    // the 16-byte granules that cover [col0, col0 + n): reading a granule
    // partly outside the row cannot fault
    const uintptr_t a = reinterpret_cast<uintptr_t>(xrow + col0);
    const int off = (int)((a & 15u) >> 2);
    const float4* src = reinterpret_cast<const float4*>(a - 4u * off);
    float4* dst = reinterpret_cast<float4*>(stage);
    const int nvec = (off + n + 3) >> 2;
    for (int i = g.rank; i < nvec; i += g.size) dst[i] = __ldg(src + i);
    keys = stage + off;
  } else {
    keys = reinterpret_cast<const uint32_t*>(xrow + col0);
  }
  g.sync();
  auto key_at = [keys](int c) {
    if constexpr (STAGED) {
      return topk::order_key(keys[c]);
    } else {
      return topk::order_key(__ldg(keys + c));
    }
  };

  if (CLUSTER || !sort_all) {
    uint32_t prefix, remaining;
    topk::radix_select<CLUSTER>(key_at, n, (uint32_t)k, s, g, prefix,
                                remaining);
    unsigned long long* dst = buf;
    if constexpr (CLUSTER) dst = cg::this_cluster().map_shared_rank(buf, 0);
    topk::collect<CLUSTER>(key_at, n, col0, (uint32_t)k, prefix, remaining,
                           dst, s, g);
    if constexpr (CLUSTER) {
      // the survivors are in block 0's buffer, and no block reads
      // another's shared memory after this
      cg::this_cluster().sync();
      if (cg::this_cluster().block_rank() != 0) return;
    } else {
      g.sync();
    }
    topk::sort_words(buf, k, padded, g, tmp, hist, s.total);
  } else {  // a narrow row: every column's word, sorted
    for (int c = g.rank; c < n; c += g.size)
      buf[topk::slot(c)] = topk::make_word(key_at(c), c);
    topk::sort_words(buf, n, padded, g);
  }

  const size_t o = (size_t)row * k;
  for (int j = g.rank; j < k; j += g.size) {
    const int c = (int)(uint32_t)buf[topk::slot(j)];
    float v;
    if constexpr (STAGED && !CLUSTER) {
      v = __uint_as_float(keys[c]);
    } else {
      v = __ldg(xrow + c);
    }
    out_i[o + j] = c;
    out_v[o + j] = v;
  }
}

constexpr int kMaxDevices = 64;
// the dynamic shared memory each variant may use on each device, set once
// per device and size (cudaFuncSetAttribute is not free)
int g_smem_set[4][kMaxDevices];

template <bool CLUSTER, bool STAGED>
cudaError_t launch(const float* x, float* out_v, int* out_i,
                   unsigned long long* tmp, int cols, int k, int cluster,
                   int threads, int grid, int slice, int stage_words,
                   int padded, int sort_all, int smem, int device,
                   cudaStream_t stream) {
  auto kernel = topk_rows_kernel<CLUSTER, STAGED>;
  int& set = g_smem_set[2 * CLUSTER + STAGED][device];
  if (smem > set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set = smem;
  }
  if constexpr (CLUSTER) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, out_v, out_i, tmp,
                                         cols, k, slice, stage_words, padded,
                                         sort_all);
    if (err != cudaSuccess) return err;
  } else {
    kernel<<<grid, threads, smem, stream>>>(x, out_v, out_i, tmp, cols, k,
                                            slice, stage_words, padded,
                                            sort_all);
  }
  return cudaGetLastError();
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
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  if (rows == 0 || k == 0) return 0;
  auto run = [&](auto kernel_launch) {
    return kernel_launch(x, out_v, out_i, (unsigned long long*)tmp, cols, k,
                         cluster, threads, rows * cluster, slice, stage_words,
                         padded, sort_all, smem, device,
                         (cudaStream_t)stream);
  };
  if (cluster > 1) {
    err = staged ? run(launch<true, true>) : run(launch<true, false>);
  } else {
    err = staged ? run(launch<false, true>) : run(launch<false, false>);
  }
  return (int)err;
}
