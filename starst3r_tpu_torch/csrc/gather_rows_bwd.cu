// The backward of the global alignment's row gather, for Hopper (sm_90a):
// a deterministic sum of each table row's cotangent rows.
//
// Replaces the accelerator route of `_gather_rows_bwd` in
// starst3r_tpu/alignment/ga.py (a jax.custom_vjp whose TPU backward is a
// one-hot contraction, dense or two-level factored, in place of the
// scatter-add that the TPU serialises over duplicate indices). It is not a
// Pallas kernel; it computes what that contraction computes:
//   d[r, j] = sum over k in [offsets[r], offsets[r+1]) of ct[order[k], j]
// with ct (M, D) float32, order (M,) int32 a stable argsort of the gather's
// index, offsets (R+1,) int32 the cumulative counts of each row, and d
// (R, D) float32. Every row of d is written; an empty row gets 0. Entries
// of order past offsets[R] belong to no row and are never read.
//
// It also sums the rasterizer's packed gradient (splat/composite.py::
// CompositePacked): K2's per-slot gradient, M = C*T*K slots of D = 9, into
// the R = C*N rows of the projected table, each row's slots in ascending
// position (at most max_tiles_per_gaussian of them), the slots past each
// tile's count in the tail of order. That is the JAX package's
// scatter-free backward of its packed gather (rasterize.py::
// _gather_packed_bwd, a fixed-length sum through Bins.bw_idx).
//
// Bound on this card: bytes. Each cotangent element is read once and each
// output element written once, plus the row order and the offsets; one add
// per cotangent element.
//
// Design. The rows run from a few entries (the depth gather: R = C*S rows,
// D = 1) to tens of thousands (the per-camera gathers: R = C rows, D =
// 9..16; 36,864 entries a row at the 512 px operating point). The launch
// shape, chosen on the host from (M, R, D) alone
// (alignment/ga.py::_gather_plan), is a block of tile_w columns by `groups`
// entry groups by rows_per_block rows, and a cluster of `cluster` blocks a
// row block. The plan gives each row about (M / R) / kBatch threads (groups
// times cluster), so each thread sums about one batch of entries; a row
// that needs more than 64 is spread over a cluster of up to 8 blocks:
//   - vec: a thread loads vec = 4 neighbouring floats (one float4) of a
//     cotangent row where D is a multiple of 4, else 1; tile_w threads
//     cover a tile of tile_w * vec columns;
//   - a row's entries are cut into `cluster` consecutive shares of
//     ceil(len / cluster) entries (the last ones may be short or empty),
//     one for each block of the cluster; within a share, group g sums the
//     entries g, g + groups, g + 2 groups, ... in that order, issuing the
//     loads of kBatch entries (their row order, then their cotangent rows)
//     before adding them, so a thread keeps kBatch loads in flight instead
//     of a chain of dependent ones;
//   - a shared-memory tree over the groups combines each block's partial
//     sums in a fixed order, and the cluster's rank-0 block adds the ranks'
//     results in rank order, reading them through distributed shared
//     memory (a thread-block cluster: the blocks of one row run at once, on
//     neighbouring SMs, and no second pass or scratch buffer is needed).
// Which entry lands in which partial sum, and the order of every add,
// depend only on the plan and the offsets. No atomics: the same call gives
// the same bits every time, a CUDA graph that replays it gives the eager
// launch's bits, and alignment/ga.py::_gather_rows_bwd_in_order repeats the
// same adds in PyTorch. A camera row of 36,864 entries runs on a cluster of
// 8 blocks, so the per-camera gathers keep 8 C SMs busy where one block a
// row kept C; a depth row of 9 entries gets 2 threads, not 16.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxTile = 32;
constexpr int kMaxCluster = 8;
// entries whose loads a thread issues before it adds them (the host plan's
// _ENTRIES_PER_THREAD aims each thread at about one such batch)
constexpr int kBatch = 8;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ T zero() { return 0.0f; }
  static __device__ T add(T a, T b) { return a + b; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  static __device__ T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};

// cols is D / V; ct and d are read and written V floats at a time. groups
// and cluster are powers of two (1 << log_groups, 1 << log_cluster), so the
// index arithmetic is shifts and masks, in 32 bits (M < 2^31)
template <int V, bool kClustered>
__global__ void __launch_bounds__(kMaxThreads)
    gather_rows_bwd_kernel(const typename Vec<V>::T* __restrict__ ct,
                           const int* __restrict__ order,
                           const int* __restrict__ offsets,
                           typename Vec<V>::T* __restrict__ d, int rows,
                           int cols, int tile_w, int log_groups,
                           int rows_per_block, int log_cluster) {
  using T = typename Vec<V>::T;
  __shared__ T partial[kMaxThreads];
  const unsigned groups = 1u << log_groups;
  const int tid = threadIdx.x;
  const int x = tid % tile_w;
  const int group_row = tid / tile_w;
  const unsigned g = group_row & (groups - 1);
  const int rb = group_row >> log_groups;
  // a cluster is 1 << log_cluster consecutive blocks along x (its rank is
  // the block's rank in cooperative_groups::this_cluster())
  const unsigned cluster = 1u << log_cluster;
  const unsigned rank = kClustered ? blockIdx.x & (cluster - 1) : 0;
  const int r = (blockIdx.x >> log_cluster) * rows_per_block + rb;
  const int col = blockIdx.y * tile_w + x;
  const bool live = r < rows && col < cols;

  T acc = Vec<V>::zero();
  if (live) {
    const unsigned begin = offsets[r];
    const unsigned len = offsets[r + 1] - begin;
    const unsigned share = (len + cluster - 1) >> log_cluster;
    const unsigned first = rank * share, last = first + share;
    const unsigned lo = begin + (first < len ? first : len);
    const unsigned hi = begin + (last < len ? last : len);
    for (unsigned k = lo + g; k < hi; k += groups * kBatch) {
      int e[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned kk = k + u * groups;
        e[u] = kk < hi ? __ldg(order + kk) : -1;
      }
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        v[u] = e[u] >= 0
                   ? __ldg(ct + static_cast<int64_t>(e[u]) * cols + col)
                   : Vec<V>::zero();
      }
      // adding +0 for a missing entry leaves the sum's bits as they are (a
      // sum that starts at +0 is never -0)
#pragma unroll
      for (int u = 0; u < kBatch; ++u) acc = Vec<V>::add(acc, v[u]);
    }
  }
  partial[tid] = acc;
  __syncthreads();
  // the groups of one (row, column) sit tile_w threads apart
  for (unsigned s = groups / 2; s > 0; s /= 2) {
    if (g < s) {
      partial[tid] = Vec<V>::add(partial[tid], partial[tid + s * tile_w]);
    }
    __syncthreads();
  }
  const int64_t out = static_cast<int64_t>(r) * cols + col;
  if constexpr (!kClustered) {
    if (live && g == 0) d[out] = partial[tid];
  } else {
    cg::cluster_group block_cluster = cg::this_cluster();
    block_cluster.sync();  // every rank's tree is done
    if (live && g == 0 && rank == 0) {
      T sum = partial[tid];
      for (unsigned q = 1; q < cluster; ++q) {
        sum = Vec<V>::add(sum,
                          *block_cluster.map_shared_rank(&partial[tid], q));
      }
      d[out] = sum;
    }
    block_cluster.sync();  // no rank leaves while rank 0 reads its memory
  }
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

int log2_of(int v) {
  int n = 0;
  while ((1 << n) < v) ++n;
  return n;
}

// one block a row block where the cluster is 1 (a plain launch), else
// clusters of `cluster` blocks along x
template <int V>
cudaError_t launch(const float* ct, const int* order, const int* offsets,
                   float* d, int rows, int cols, int tile_w, int groups,
                   int rows_per_block, int cluster, cudaStream_t stream) {
  const int64_t row_blocks =
      (static_cast<int64_t>(rows) + rows_per_block - 1) / rows_per_block;
  const int64_t tiles = (static_cast<int64_t>(cols) + tile_w - 1) / tile_w;
  if (row_blocks * cluster > 0x7fffffff || tiles > 65535) {
    return cudaErrorInvalidValue;
  }
  using T = typename Vec<V>::T;
  const auto* ct_v = reinterpret_cast<const T*>(ct);
  auto* d_v = reinterpret_cast<T*>(d);
  const dim3 grid(static_cast<unsigned>(row_blocks * cluster),
                  static_cast<unsigned>(tiles));
  const int threads = tile_w * groups * rows_per_block;
  const int log_groups = log2_of(groups), log_cluster = log2_of(cluster);
  if (cluster == 1) {
    gather_rows_bwd_kernel<V, false><<<grid, threads, 0, stream>>>(
        ct_v, order, offsets, d_v, rows, cols, tile_w, log_groups,
        rows_per_block, 0);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gather_rows_bwd_kernel<V, true>, ct_v,
                            order, offsets, d_v, rows, cols, tile_w,
                            log_groups, rows_per_block, log_cluster);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) with the plan the host
// chose (vec, tile_w, groups, rows_per_block, cluster: see the header);
// returns the launch's CUDA error code, cudaErrorInvalidValue for a plan
// the kernel does not take. With vec = 4, ct and d must be 16-byte aligned.
extern "C" int gather_rows_bwd_split(const float* ct, const int* order,
                                     const int* offsets, float* d, int rows,
                                     int width, int vec, int tile_w,
                                     int groups, int rows_per_block,
                                     int cluster, void* stream) {
  if (rows < 0 || width < 0 || (vec != 1 && vec != 4) || width % vec != 0 ||
      tile_w < 1 || tile_w > kMaxTile || !pow2(groups) ||
      rows_per_block < 1 ||
      static_cast<int64_t>(tile_w) * groups * rows_per_block > kMaxThreads ||
      !pow2(cluster) || cluster > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || width == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const int cols = width / vec;
  const cudaError_t err =
      vec == 4 ? launch<4>(ct, order, offsets, d, rows, cols, tile_w, groups,
                           rows_per_block, cluster, s)
               : launch<1>(ct, order, offsets, d, rows, cols, tile_w, groups,
                           rows_per_block, cluster, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
