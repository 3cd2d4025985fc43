// Tile-entry gather for the 3D Gaussian Splatting rasterizer, for Hopper
// (sm_90a).
//
// Replaces the six Mosaic gather kernels of tools/probe_mosaic_gather.py
// (v1_kernel .. v4_kernel) and tools/probe_mosaic_gather2.py (v5_kernel,
// v6_kernel). All six compute one function, a row gather of an (N, A)
// float32 attribute table by (T, K) int32 indices; they differ only in TPU
// layout (row- or lane-major table, 8 tiles per program, flat output),
// choices that mean nothing on this card, so one kernel stands for all of
// them. Here the table is the rasterizer's packed (C*N, 9) projected
// attributes [mx, my, conic a, b, c, r, g, b, opacity] and the indices are
// the binning's gidx (C, T, K), which point into that table already offset
// by camera:
//   out[c, t, k, :] = valid[c, t, k] ? packed[gidx[c, t, k], :] : 0.
//
// Design: one thread per (slot, attribute). Neighbouring threads write
// neighbouring output floats, so the stores (the largest stream) are
// coalesced; the nine threads of a slot read one 36-byte row, and the index
// and mask reads are shared by them through the L1. Rows are read only for
// valid slots.
//
// Bound on this card: bytes. Per slot 5 bytes of index and mask and 36
// bytes of output, plus each table row the slots need, read once; no
// arithmetic beyond the addressing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kAttr = 9;

__global__ void gather_entries_kernel(const float* __restrict__ packed,
                                      const int* __restrict__ gidx,
                                      const uint8_t* __restrict__ valid,
                                      float* __restrict__ out,
                                      int64_t n_values) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_values) return;
  const int64_t slot = i / kAttr;
  const int a = static_cast<int>(i - slot * kAttr);
  float v = 0.0f;
  if (valid[slot]) v = packed[static_cast<int64_t>(gidx[slot]) * kAttr + a];
  out[i] = v;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the caller can raise on a refused launch.
extern "C" int gather_entries(const float* packed, const int* gidx,
                              const uint8_t* valid, float* out,
                              int64_t n_slots, void* stream) {
  const int64_t n_values = n_slots * kAttr;
  if (n_values == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int64_t blocks = (n_values + threads - 1) / threads;
  gather_entries_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      packed, gidx, valid, out, n_values);
  return static_cast<int>(cudaGetLastError());
}
