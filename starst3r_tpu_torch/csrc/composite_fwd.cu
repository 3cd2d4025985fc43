// Forward tile compositing of 3D Gaussian splats, for Hopper (sm_90a).
//
// Replaces starst3r_tpu/splat/pallas_composite.py::_fwd_kernel (launched by
// _run_fwd through composite_tiles_pallas). Same function: per 16x16 tile,
// front-to-back alpha compositing over the tile's depth-sorted entries,
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy, clipped to [0, 50] before exp,
//   alpha = min(op * exp(-sigma), 0.999), culled when sigma < 0 or
//           alpha <= 1/255,
//   rgb += color * alpha * T,  T *= 1 - alpha,
// the loop bounded by the tile's own entry count, and a tile-wide exit at
// a batch boundary once every pixel of the tile has T <= 1e-6.
//
// Design for this card, not a block-by-block copy of the TPU kernel:
//   - one block per (camera, tile), one thread per pixel (tile*tile <= 1024
//     threads), the blocks independent so the SMs take them in any order;
//   - the tile's entries are staged through shared memory in batches of
//     BATCH entries (BATCH * 9 floats = 4.6 KB), read once from device
//     memory with coalesced loads, then read by every thread as broadcasts;
//   - each thread runs the plain sequential float32 recurrence
//     T *= (1 - alpha), which needs no prefix products: the TPU kernel's
//     triangular-matmul cumprod exists only because Mosaic lowers none;
//   - after each batch a block vote (__syncthreads_or) stops the tile once
//     no pixel has T > 1e-6. `done` counts the batches processed, as the
//     TPU kernel's does (BATCH = its 128-entry chunk), for the backward;
//   - sigma is rounded operation by operation in the order of the plain
//     PyTorch version (splat/composite.py), so the two culls, which are
//     jumps, decide alike; the falloff and the culls live in
//     composite_common.cuh, shared with the backward (composite_bwd.cu).
//
// Bound on this card: the float32 exp/FMA work of pixels x entries
// processed, on the CUDA cores, not the tensor cores: 16 operations per
// pair for the falloff and the culls, 9 more per pair that passes them.
// The gathered entries are read once: C*T*K*36 bytes at most, about 43 MB
// at 6 cameras, 224 px, K = 1024, which at 3.35 TB/s takes a fraction of
// the arithmetic's time.
//
// Layouts: entries (C*T, K, 9) float32 [mx, my, a, b, c, r, g, b, op];
// counts (C*T,) int32. Outputs: rgb (C, H, W, 3) and alpha (C, H, W) in image
// layout (pixels outside the H x W image are computed, take part in the
// vote, and are not written), tfin (C*T, tile*tile) final transmittance per
// tile pixel, done (C*T,) int32 batches processed.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace composite;

__global__ void composite_fwd_kernel(
    const float* __restrict__ entries, const int* __restrict__ counts,
    float* __restrict__ rgb, float* __restrict__ alpha_out,
    float* __restrict__ tfin, int* __restrict__ done,
    int k, int tile, int tw, int th, int h, int w) {
  __shared__ float sh[kBatch * kAttr];

  const int ct = blockIdx.x;
  const int t_per_cam = tw * th;
  const int cam = ct / t_per_cam;
  const int t_id = ct - cam * t_per_cam;
  const int p = threadIdx.x;
  const int x = (t_id % tw) * tile + p % tile;
  const int y = (t_id / tw) * tile + p / tile;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;

  const int count = min(max(counts[ct], 0), k);
  const float* src = entries + static_cast<size_t>(ct) * k * kAttr;

  float T = 1.0f;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  int batches = 0;
  for (int start = 0; start < count; start += kBatch) {
    // the vote is also the barrier before the shared batch is overwritten
    if (!__syncthreads_or(T > kTExit)) break;
    const int n = min(kBatch, count - start);
    const float* bsrc = src + static_cast<size_t>(start) * kAttr;
    for (int i = p; i < n * kAttr; i += blockDim.x) sh[i] = bsrc[i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* a = sh + j * kAttr;
      // the culls are jumps: composite_common.cuh rounds sigma as the
      // plain version does, and the backward calls the same function
      const Falloff f = entry_falloff(a, px, py);
      if (f.ok) {
        const float al = fminf(f.raw, kAlphaMax);
        const float wgt = al * T;
        r += a[5] * wgt;
        g += a[6] * wgt;
        b += a[7] * wgt;
        T *= 1.0f - al;
      }
    }
    ++batches;
  }

  tfin[static_cast<size_t>(ct) * blockDim.x + p] = T;
  if (p == 0) done[ct] = batches;
  if (x < w && y < h) {
    const size_t pix = (static_cast<size_t>(cam) * h + y) * w + x;
    rgb[pix * 3 + 0] = r;
    rgb[pix * 3 + 1] = g;
    rgb[pix * 3 + 2] = b;
    alpha_out[pix] = 1.0f - T;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the caller can raise on a refused launch.
extern "C" int composite_fwd(const float* entries, const int* counts,
                             float* rgb, float* alpha, float* tfin,
                             int* done, int n_tiles, int k, int tile, int tw,
                             int th, int h, int w, void* stream) {
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  composite_fwd_kernel<<<n_tiles, tile * tile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      entries, counts, rgb, alpha, tfin, done, k, tile, tw, th, h, w);
  return static_cast<int>(cudaGetLastError());
}
