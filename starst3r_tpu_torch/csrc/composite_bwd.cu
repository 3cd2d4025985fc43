// Backward tile compositing of 3D Gaussian splats, for Hopper (sm_90a).
//
// Replaces starst3r_tpu/splat/pallas_composite.py::_bwd_kernel (launched by
// _bwd_rule, the backward of the jax.custom_vjp around the forward kernel).
// Same function: the gradient of the forward compositing (composite_fwd.cu)
// with respect to every entry's 9 attributes. With
//   out = sum_j c_j a_j T_j,  T_j = prod_{l<j} (1 - a_l),  T_fin = T_n,
//   dL/dc_j = a_j T_j g
//   dL/da_j = T_j (c_j . g) - S_j / (1 - a_j) - g_T T_fin / (1 - a_j)
// where g = dL/drgb, g_T = dL/dT_fin = -dL/dalpha and
// S_j = sum_{l>j} (c_l . g) a_l T_l; then through a_j = op * exp(-sigma):
//   dL/dop = dL/da_j * exp(-sigma),  dL/dsigma = -dL/da_j * raw,
// and sigma's derivatives in the mean and the conic. Colour gradients count
// for every entry that passed the culls, including those clipped at 0.999;
// the sigma and opacity gradients are zero unless the entry is inside
// (passed the culls and raw < 0.999), as in the TPU kernel.
//
// Design for this card, not a block-by-block copy of the TPU kernel:
//   - one block per (camera, tile), one thread per pixel, as the forward;
//     the block is rounded up to whole warps, and the extra threads (and
//     pixels outside the image) carry zero pixel gradients;
//   - the block walks the batches the forward processed (`done`, batches of
//     128 entries, n = min(128, count - start)) FRONT TO BACK, as the
//     forward did, and rebuilds each entry's T_j with the forward's own
//     running product T *= 1 - a. The suffix sum comes from the prefix:
//     S_j = g . (out - C_j), with C_j the colour accumulated up to and
//     including entry j (the same operations as the forward's, so
//     C_n = out) and out the forward's rgb. The TPU kernel instead walks
//     back to front and rebuilds T_j = T_after / (1 - a_j) from T_fin; in
//     a tile that saturates, T_fin underflows to 0 inside the last batch
//     (128 entries of alpha 0.999 multiply T by 1e-384), and every T_j
//     rebuilt from it is 0: the gradients of the whole tile vanish. The
//     forward walk needs no division and no triangular-matmul products
//     (which exist in the TPU kernel only because Mosaic lowers no
//     cumprod). out - C_j cancels to about 1e-7 of |out|, which the
//     1 / (1 - a) <= 1e3 factor keeps within the tests' tolerance;
//   - the 9 per-entry sums over the tile's pixels: a warp-shuffle reduction
//     per entry (skipped, with zeros written, when no lane of the warp
//     passed the entry's culls), each warp's sums parked in shared memory
//     for the whole batch, and one pass after the batch that adds the warps'
//     sums and writes the batch's gradients with coalesced stores. One
//     block owns its tile's slots, so no global atomics; slots the walk does
//     not reach keep the zeros of the caller's torch.zeros output;
//   - the falloff and the culls come from composite_common.cuh, the same
//     function the forward calls, so the backward culls exactly the
//     entries the forward culled.
//
// Bound on this card: float32 arithmetic on the CUDA cores. Every (pixel,
// entry) pair walked takes the falloff and the culls, 16 operations; a pair
// that passes the culls takes 53 more: the transmittance, colour prefix and
// alpha gradient 20, the 9 gradient terms 24, the reduction's adds 9. The
// bytes (the entries walked and their gradients, the pixel gradients, rgb,
// T_fin) take a fraction of that time.
//
// Layouts: entries (C*T, K, 9) float32; counts, done (C*T,) int32; rgb
// (C, H, W, 3) the forward's output; tfin (C*T, tile*tile) float32 from the
// forward; grad_rgb (C, H, W, 3) and grad_alpha (C, H, W) float32 in image
// layout. Output: grad_entries (C*T, K, 9) float32, zero-filled by the
// caller.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace composite;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void composite_bwd_kernel(
    const float* __restrict__ entries, const int* __restrict__ counts,
    const int* __restrict__ done, const float* __restrict__ rgb,
    const float* __restrict__ tfin,
    const float* __restrict__ grad_rgb, const float* __restrict__ grad_alpha,
    float* __restrict__ grad_entries, int k, int tile, int tw, int th, int h,
    int w) {
  extern __shared__ float smem[];
  float* sh = smem;                        // kBatch * kAttr entry attributes
  float* red = smem + kBatch * kAttr;      // per warp: kBatch * kAttr sums
  const int n_warps = blockDim.x >> 5;

  const int ct = blockIdx.x;
  const int t_per_cam = tw * th;
  const int cam = ct / t_per_cam;
  const int t_id = ct - cam * t_per_cam;
  const int n_pix = tile * tile;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int x = (t_id % tw) * tile + p % tile;
  const int y = (t_id / tw) * tile + p / tile;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;

  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, g_t = 0.0f, t_fin = 1.0f;
  float g_out = 0.0f;                      // g . out
  if (p < n_pix) {
    t_fin = tfin[static_cast<size_t>(ct) * n_pix + p];
    if (x < w && y < h) {
      const size_t pix = (static_cast<size_t>(cam) * h + y) * w + x;
      g0 = grad_rgb[pix * 3 + 0];
      g1 = grad_rgb[pix * 3 + 1];
      g2 = grad_rgb[pix * 3 + 2];
      g_t = -grad_alpha[pix];              // alpha = 1 - T_fin
      g_out = g0 * rgb[pix * 3 + 0] + g1 * rgb[pix * 3 + 1] +
              g2 * rgb[pix * 3 + 2];
    }
  }
  const float gt_term = g_t * t_fin;
  float T = 1.0f;                          // transmittance before entry j
  float r = 0.0f, g = 0.0f, b = 0.0f;      // colour up to entry j

  const int count = min(max(counts[ct], 0), k);
  const int n_batches = min(done[ct], (count + kBatch - 1) / kBatch);
  const float* src = entries + static_cast<size_t>(ct) * k * kAttr;
  float* dst = grad_entries + static_cast<size_t>(ct) * k * kAttr;

  for (int bt = 0; bt < n_batches; ++bt) {
    const int start = bt * kBatch;
    const int n = min(kBatch, count - start);
    // the previous batch's readers of sh and red are done
    __syncthreads();
    const float* bsrc = src + static_cast<size_t>(start) * kAttr;
    for (int i = p; i < n * kAttr; i += blockDim.x) sh[i] = bsrc[i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* a = sh + j * kAttr;
      const Falloff f = entry_falloff(a, px, py);
      float v[kAttr];
#pragma unroll
      for (int q = 0; q < kAttr; ++q) v[q] = 0.0f;
      if (f.ok) {
        const float al = fminf(f.raw, kAlphaMax);
        const float w_j = al * T;
        // the forward's accumulation, operation for operation
        r += a[5] * w_j;
        g += a[6] * w_j;
        b += a[7] * w_j;
        v[5] = w_j * g0;
        v[6] = w_j * g1;
        v[7] = w_j * g2;
        if (f.raw < kAlphaMax) {
          const float inv_1m = 1.0f / fmaxf(1.0f - al, 1e-3f);
          const float cdotg = a[5] * g0 + a[6] * g1 + a[7] * g2;
          const float s = g_out - (g0 * r + g1 * g + g2 * b);
          const float dal = T * cdotg - s * inv_1m - gt_term * inv_1m;
          const float dsig = -dal * f.raw;
          v[0] = dsig * -(a[2] * f.dx + a[3] * f.dy);
          v[1] = dsig * -(a[4] * f.dy + a[3] * f.dx);
          v[2] = dsig * (0.5f * f.dx * f.dx);
          v[3] = dsig * (f.dx * f.dy);
          v[4] = dsig * (0.5f * f.dy * f.dy);
          v[8] = dal * f.expsig;
        }
        T *= 1.0f - al;
      }
      float* rd = red + (warp * kBatch + j) * kAttr;
      if (__any_sync(0xffffffffu, f.ok)) {
#pragma unroll
        for (int q = 0; q < kAttr; ++q) {
          const float sum = warp_sum(v[q]);
          if (lane == 0) rd[q] = sum;
        }
      } else if (lane < kAttr) {
        rd[lane] = 0.0f;
      }
    }
    __syncthreads();
    float* bdst = dst + static_cast<size_t>(start) * kAttr;
    for (int i = p; i < n * kAttr; i += blockDim.x) {
      float sum = 0.0f;
      for (int q = 0; q < n_warps; ++q) sum += red[q * kBatch * kAttr + i];
      bdst[i] = sum;
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// (or the error of raising the block's shared-memory limit) so the caller
// can raise on a refused launch.
extern "C" int composite_bwd(const float* entries, const int* counts,
                             const int* done, const float* rgb,
                             const float* tfin,
                             const float* grad_rgb, const float* grad_alpha,
                             float* grad_entries, int n_tiles, int k,
                             int tile, int tw, int th, int h, int w,
                             void* stream) {
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const int threads = (tile * tile + 31) / 32 * 32;
  const size_t smem =
      static_cast<size_t>(kBatch) * kAttr * (1 + threads / 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_bwd_kernel<<<n_tiles, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      entries, counts, done, rgb, tfin, grad_rgb, grad_alpha, grad_entries, k,
      tile, tw, th, h, w);
  return static_cast<int>(cudaGetLastError());
}
