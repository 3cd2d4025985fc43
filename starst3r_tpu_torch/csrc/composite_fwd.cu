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
//   - one block per (camera, tile), one thread per pixel, the blocks
//     independent so the SMs take them in any order. Each warp owns an 8x4
//     block of the tile's pixels (composite_common.cuh), not two rows;
//   - the tile's entries come in batches of BATCH = 128 (128 * 9 floats,
//     4.6 KB), double-buffered in shared memory: while the block composites
//     batch b, cp.async copies batch b + 1 into the other buffer, so the
//     load overlaps the arithmetic;
//   - most splats cover a few pixels of one or two warps (on the trained
//     scene ~9 of a tile's 256 pixels pass an entry's culls), so after a
//     batch lands, one lane per entry computes its cull box (the pixel
//     rectangle outside of which the culls cannot pass) and a ballot per
//     warp builds each warp's 128-bit mask of the entries whose box meets
//     its footprint. A warp walks only its set bits, in entry order: the
//     branch is warp-uniform, and a skipped entry would have been culled at
//     every pixel of the warp, so the output is unchanged;
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
// Bound on this card: the float32 exp/FMA work of the (pixel, entry) pairs
// inside the entries' cull boxes, on the CUDA cores, not the tensor cores:
// 16 operations per pair for the falloff and the culls, 9 more per pair
// that passes them, and the box of every entry walked; or the bytes, the
// entries walked read once and the outputs written once, whichever is
// larger (chip_smoke.py counts both from the run's data).
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
  __shared__ __align__(16) float sh[2][kBatch * kAttr];
  __shared__ unsigned mask[kMaxWarps * kWords];

  const int ct = blockIdx.x;
  const int t_per_cam = tw * th;
  const int cam = ct / t_per_cam;
  const int t_id = ct - cam * t_per_cam;
  const int n_warps = blockDim.x >> 5;
  const Layout lay = thread_layout(tile);
  const int ox = (t_id % tw) * tile, oy = (t_id / tw) * tile;
  const int x = ox + lay.lx;
  const int y = oy + lay.ly;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const unsigned* my_mask = mask + (threadIdx.x >> 5) * kWords;

  const int count = min(max(counts[ct], 0), k);
  const float* src = entries + static_cast<size_t>(ct) * k * kAttr;

  float T = 1.0f;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  int batches = 0;
  if (count > 0) stage_batch(sh[0], src, min(kBatch, count));
  for (int start = 0; start < count; start += kBatch) {
    // the vote is also the barrier after which the buffer of the previous
    // batch, and the masks, may be overwritten
    if (!__syncthreads_or(lay.inside && T > kTExit)) break;
    const int n = min(kBatch, count - start);
    const float* cur = sh[batches & 1];
    if (start + kBatch < count) {
      stage_batch(sh[(batches + 1) & 1],
                  src + static_cast<size_t>(start + kBatch) * kAttr,
                  min(kBatch, count - start - kBatch));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    build_masks(cur, n, tile, static_cast<float>(ox), static_cast<float>(oy),
                lay.warps_x, n_warps, mask, nullptr);
    __syncthreads();
    for_each_entry(my_mask, [&](int j) {
      const float* a = cur + j * kAttr;
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
    });
    ++batches;
  }
  // a batch staged ahead of an early exit must land before the block ends
  cp_async_wait<0>();

  if (!lay.inside) return;
  tfin[static_cast<size_t>(ct) * tile * tile + lay.ly * tile + lay.lx] = T;
  if (lay.lx == 0 && lay.ly == 0) done[ct] = batches;
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
  composite_fwd_kernel<<<n_tiles, 32 * warps_for(tile), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      entries, counts, rgb, alpha, tfin, done, k, tile, tw, th, h, w);
  return static_cast<int>(cudaGetLastError());
}
