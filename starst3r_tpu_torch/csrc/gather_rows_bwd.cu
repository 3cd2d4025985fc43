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
// (R, D) float32. Every row of d is written; an empty row gets 0.
//
// Design: a block of T threads covers RB rows by a tile of W columns, with
// G groups of threads splitting each row's entries. Thread (x, g, rb) sums
// the entries offsets[r] + g, + g + G, ... of column x in that order, and a
// shared-memory tree over the G partial sums combines them in a fixed order.
// No atomics: the same call gives the same bits every time, and a CUDA graph
// that replays it gives the eager launch's bits. W is the next power of two
// of D up to 32 (neighbouring threads read neighbouring floats of a
// cotangent row), G the next power of two of the mean entries per row, T
// = W * G within [256, 1024] (G capped at T / W), and RB = T / (W * G) rows
// fill the block; all four depend only on the shapes. The shapes run from
// the depth gather (R = C*S rows, D = 1, a few entries a row: W = 1, G = 4,
// 64 rows a block) to the per-camera gathers (R = C rows, thousands of
// entries each, D = 9..16: W = 16, G = 64, a row a block) and the
// core-point gather (R = C, D = 2352, a few entries a row: W = 32, G = 8,
// 74 tiles a row). A row of thousands of entries is one block's work, so
// those gathers fill only C of the card's SMs: splitting such rows over
// blocks needs a second, combining pass.
//
// Bound on this card: bytes. Each cotangent element is read once and each
// output element written once, plus the index and the offsets; one add per
// cotangent element.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMinThreads = 256;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWidth = 32;

__global__ void gather_rows_bwd_kernel(const float* __restrict__ ct,
                                       const int* __restrict__ order,
                                       const int* __restrict__ offsets,
                                       float* __restrict__ d, int rows,
                                       int width, int tile_w, int groups) {
  __shared__ float partial[kMaxThreads];
  const int tid = threadIdx.x;
  const int x = tid % tile_w;
  const int g = (tid / tile_w) % groups;
  const int rb = tid / (tile_w * groups);
  const int rows_per_block = blockDim.x / (tile_w * groups);
  const int r = blockIdx.x * rows_per_block + rb;
  const int col = blockIdx.y * tile_w + x;
  const bool live = r < rows && col < width;

  float acc = 0.0f;
  if (live) {
    const int end = offsets[r + 1];
    // the loads of four entries are issued together; the adds stay in order
#pragma unroll 4
    for (int k = offsets[r] + g; k < end; k += groups) {
      acc += ct[static_cast<int64_t>(order[k]) * width + col];
    }
  }
  partial[tid] = acc;
  __syncthreads();
  // the groups of one (row, column) sit tile_w threads apart
  for (int s = groups / 2; s > 0; s /= 2) {
    if (g < s) partial[tid] += partial[tid + s * tile_w];
    __syncthreads();
  }
  if (live && g == 0) d[static_cast<int64_t>(r) * width + col] = partial[tid];
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns
// cudaGetLastError() so the caller can raise on a refused launch. `entries`
// is M, the rows of ct and of order.
extern "C" int gather_rows_bwd(const float* ct, const int* order,
                               const int* offsets, float* d, int rows,
                               int width, int entries, void* stream) {
  if (rows == 0 || width == 0) return static_cast<int>(cudaSuccess);
  const int tile_w = next_pow2(width < kMaxWidth ? width : kMaxWidth);
  const int mean = (entries + rows - 1) / rows;
  int groups = next_pow2(mean > 1 ? mean : 1);
  int threads = tile_w * groups;
  if (threads < kMinThreads) threads = kMinThreads;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (groups > threads / tile_w) groups = threads / tile_w;
  const int rows_per_block = threads / (tile_w * groups);
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block,
                  (width + tile_w - 1) / tile_w);
  gather_rows_bwd_kernel<<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      ct, order, offsets, d, rows, width, tile_w, groups);
  return static_cast<int>(cudaGetLastError());
}
