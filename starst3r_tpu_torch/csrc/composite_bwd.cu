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
//   - one block per (camera, tile), one thread per pixel, each warp on an
//     8x4 block of the tile's pixels, as the forward (composite_common.cuh);
//     phantom lanes (outside the tile) and pixels outside the image carry
//     zero pixel gradients;
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
//   - the batches are double-buffered in shared memory with cp.async, and
//     each warp walks only the entries whose cull box meets its footprint
//     (the forward's per-warp masks, built the same way): an entry outside
//     the box is culled at every pixel of the warp and adds nothing;
//   - the 9 per-entry sums over the tile's pixels: for each entry it walks,
//     a warp whose lanes passed the culls reduces them with warp shuffles
//     and parks them in shared memory; a warp none of whose lanes passed
//     clears its bit in the entry's set of warps instead. One pass after
//     the batch adds, per gradient element, the sums of the warps still in
//     the entry's set (in warp order) and writes the batch's gradients
//     with coalesced stores. No zero is stored for a warp that did not
//     contribute. One block owns its tile's slots, so no global atomics;
//     slots the walk does not reach keep the zeros of the caller's
//     torch.zeros output;
//   - on the rasterizer's route (composite_bwd_packed) the batches are
//     staged from the projected table through the binning's indices, as
//     the forward's packed route stages them (composite_common.cuh::
//     PackedRows), and the epilogue stores each slot's sums at the slot,
//     as on the entries route (an entry no warp contributed to keeps the
//     caller's zero): the same bits as the entries route's gradient. The
//     caller sums each table row's slots with the row-sum kernel
//     (gather_rows_bwd.cu) through a CSR of the binning's indices, in a
//     fixed order, which is the JAX package's scatter-free backward of its
//     packed gather (rasterize.py::_gather_packed, through Bins.bw_idx):
//     a training step gives the same bits every time;
//   - the falloff and the culls come from composite_common.cuh, the same
//     function the forward calls, so the backward culls exactly the
//     entries the forward culled.
//
// Bound on this card: float32 arithmetic on the CUDA cores. Every (pixel,
// entry) pair inside an entry's cull box takes the falloff and the culls,
// 16 operations, and every entry walked its box; a pair that passes the
// culls takes 53 more: the transmittance, colour prefix and alpha gradient
// 20, the 9 gradient terms 24, the reduction's adds 9. Or the bytes (the
// entries walked and their gradients, the pixel gradients, rgb, T_fin),
// whichever is larger (chip_smoke.py counts both from the run's data; on
// the packed route an entry walked reads its 4-byte index and its 36-byte
// row, and each contributing entry stores its 36 bytes at its slot).
//
// Layouts: entries (C*T, K, 9) float32, or packed (C*N, 9) and gidx
// (C*T, K) int32; counts, done (C*T,) int32; rgb (C, H, W, 3) the forward's
// output; tfin (C*T, tile*tile) float32 from the forward; grad_rgb
// (C, H, W, 3) and grad_alpha (C, H, W) float32 in image layout. Output,
// on both routes: the per-slot gradient (C*T, K, 9) float32, zero-filled
// by the caller.

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

// Dynamic shared memory, in 4-byte words: two batch buffers, the per-warp
// sums, the per-warp masks, the per-entry warp sets and the source's index
// ring (16-byte aligned: every part before it is a multiple of 16 bytes).
__host__ __device__ constexpr size_t smem_words(int n_warps, int ring) {
  return 2 * kBatch * kAttr + static_cast<size_t>(n_warps) * kBatch * kAttr +
         static_cast<size_t>(n_warps) * kWords + kBatch + ring;
}

template <class Rows>
__global__ void composite_bwd_kernel(
    Rows rows, const int* __restrict__ counts,
    const int* __restrict__ done, const float* __restrict__ rgb,
    const float* __restrict__ tfin,
    const float* __restrict__ grad_rgb, const float* __restrict__ grad_alpha,
    int k, int tile, int tw, int th, int h, int w) {
  extern __shared__ __align__(16) float smem[];
  const int n_warps = blockDim.x >> 5;
  float* sh = smem;                              // 2 x kBatch * kAttr
  float* red = smem + 2 * kBatch * kAttr;        // per warp: kBatch * kAttr
  unsigned* mask = reinterpret_cast<unsigned*>(
      red + static_cast<size_t>(n_warps) * kBatch * kAttr);
  unsigned* warp_bits = mask + n_warps * kWords; // per entry: warps in it
  int* ring = reinterpret_cast<int*>(warp_bits + kBatch);

  const int ct = blockIdx.x;
  const int t_per_cam = tw * th;
  const int cam = ct / t_per_cam;
  const int t_id = ct - cam * t_per_cam;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Layout lay = thread_layout(tile);
  const int ox = (t_id % tw) * tile, oy = (t_id / tw) * tile;
  const int x = ox + lay.lx;
  const int y = oy + lay.ly;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;

  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, g_t = 0.0f, t_fin = 1.0f;
  float g_out = 0.0f;                      // g . out
  if (lay.inside) {
    t_fin = tfin[static_cast<size_t>(ct) * tile * tile + lay.ly * tile +
                 lay.lx];
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
  float* my_red = red + static_cast<size_t>(warp) * kBatch * kAttr;

  rows.begin(ct, count, n_batches, sh, ring);
  for (int bt = 0; bt < n_batches; ++bt) {
    const int start = bt * kBatch;
    const int n = min(kBatch, count - start);
    const float* cur = sh + (bt & 1) * kBatch * kAttr;
    // the buffer staged into here held batch bt - 1, whose readers (its
    // masks and its walk) finished before the barrier ahead of its pass;
    // after advance the batch has landed, and the previous pass is done
    // with red, the masks, the warp sets and its indices
    rows.advance(bt, sh + ((bt + 1) & 1) * kBatch * kAttr);
    build_masks(cur, n, tile, static_cast<float>(ox), static_cast<float>(oy),
                lay.warps_x, n_warps, mask, warp_bits);
    __syncthreads();
    for_each_entry(mask + warp * kWords, [&](int j) {
      const float* a = cur + j * kAttr;
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
      if (__any_sync(0xffffffffu, f.ok)) {
        float* rd = my_red + j * kAttr;
#pragma unroll
        for (int q = 0; q < kAttr; ++q) {
          const float sum = warp_sum(v[q]);
          if (lane == 0) rd[q] = sum;
        }
      } else if (lane == 0) {
        atomicAnd(warp_bits + j, ~(1u << warp));
      }
    });
    __syncthreads();
    for (int i = threadIdx.x; i < n * kAttr; i += blockDim.x) {
      const int j = i / kAttr;
      unsigned bits = warp_bits[j];
      if (Rows::kSkipsEmpty && bits == 0u) continue;
      float sum = 0.0f;
      while (bits != 0u) {
        const int q = __ffs(bits) - 1;
        bits &= bits - 1u;
        sum += red[(static_cast<size_t>(q) * kBatch) * kAttr + i];
      }
      rows.put(bt, j, i - j * kAttr, i, sum);
    }
  }
}

template <class Rows>
int launch(Rows rows, const int* counts, const int* done, const float* rgb,
           const float* tfin, const float* grad_rgb, const float* grad_alpha,
           int n_tiles, int k, int tile, int tw, int th, int h, int w,
           void* stream) {
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const int n_warps = warps_for(tile);
  const size_t smem = smem_words(n_warps, Rows::kRingWords) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel<Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_bwd_kernel<Rows><<<n_tiles, 32 * n_warps, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      rows, counts, done, rgb, tfin, grad_rgb, grad_alpha, k, tile, tw, th,
      h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); return cudaGetLastError()
// (or the error of raising the block's shared-memory limit) so the caller
// can raise on a refused launch.
//
// The entries route: entries (C*T, K, 9) as the standalone gather
// (gather_entries.cu) writes them; grad_entries (C*T, K, 9) zero-filled by
// the caller.
extern "C" int composite_bwd(const float* entries, const int* counts,
                             const int* done, const float* rgb,
                             const float* tfin,
                             const float* grad_rgb, const float* grad_alpha,
                             float* grad_entries, int n_tiles, int k,
                             int tile, int tw, int th, int h, int w,
                             void* stream) {
  EntryRows rows{};
  rows.entries = entries;
  rows.grad = grad_entries;
  rows.k = k;
  return launch(rows, counts, done, rgb, tfin, grad_rgb, grad_alpha, n_tiles,
                k, tile, tw, th, h, w, stream);
}

// The packed route, the rasterizer's: rows staged from packed (C*N, 9)
// through gidx (C*T, K) as the forward's packed route stages them, and
// each slot's gradient stored into grad_slots (C*T, K, 9), zero-filled by
// the caller, which sums it into the table's rows.
extern "C" int composite_bwd_packed(const float* packed, const int* gidx,
                                    const int* counts, const int* done,
                                    const float* rgb, const float* tfin,
                                    const float* grad_rgb,
                                    const float* grad_alpha,
                                    float* grad_slots, int n_tiles, int k,
                                    int tile, int tw, int th, int h, int w,
                                    void* stream) {
  PackedRows rows{};
  rows.packed = packed;
  rows.gidx = gidx;
  rows.grad = grad_slots;
  rows.k = k;
  return launch(rows, counts, done, rgb, tfin, grad_rgb, grad_alpha, n_tiles,
                k, tile, tw, th, h, w, stream);
}
