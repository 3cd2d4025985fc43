// What the forward (composite_fwd.cu) and backward (composite_bwd.cu)
// compositing kernels must compute identically: the constants, one entry's
// Gaussian falloff and cull at one pixel, the entry's cull box, the layout
// of the warps over the tile, and the asynchronous staging of a batch.
//
// The culls (sigma < 0, alpha <= 1/255) are jumps: a near-degenerate conic
// puts sigma within rounding of 0, where one rounding decides between an
// opaque splat and none. So sigma is rounded operation by operation in the
// order of the plain PyTorch version (splat/composite.py), with no FMA
// contraction, and both kernels call this one function: the backward culls
// exactly the entries the forward culled.

#pragma once

#include <cstddef>
#include <cstdint>

namespace composite {

constexpr int kAttr = 9;          // mx, my, conic a, b, c, r, g, b, opacity
constexpr int kBatch = 128;       // entries per batch (the TPU kernel's chunk)
constexpr int kWords = kBatch / 32;   // 32-bit words of a per-warp entry mask
constexpr float kSigmaMax = 50.0f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;
constexpr float kTExit = 1e-6f;

struct Falloff {
  float dx, dy;     // pixel centre minus the projected mean
  float expsig;     // exp(-clip(sigma, 0, 50))
  float raw;        // opacity * expsig, before the 0.999 clip
  bool ok;          // passed the culls: sigma >= 0 and raw > 1/255
};

// a: the entry's 9 attributes; (px, py): the pixel centre.
__device__ __forceinline__ Falloff entry_falloff(const float* a, float px,
                                                 float py) {
  Falloff f;
  f.dx = px - a[0];
  f.dy = py - a[1];
  const float sigma = __fadd_rn(
      __fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(a[2], f.dx), f.dx),
                                __fmul_rn(__fmul_rn(a[4], f.dy), f.dy))),
      __fmul_rn(__fmul_rn(a[3], f.dx), f.dy));
  f.expsig = expf(-fminf(fmaxf(sigma, 0.0f), kSigmaMax));
  f.raw = a[8] * f.expsig;
  f.ok = sigma >= 0.0f && f.raw > kAlphaMin;
  return f;
}

// ---------------------------------------------------------------------------
// Cull box: the tile-local pixel rectangle [x0, x1] x [y0, y1] (inclusive;
// empty when x0 > x1) outside of which entry_falloff culls the entry. For a
// positive-definite conic Q = [[a, b], [b, c]] the culls pass only inside
// the ellipse sigma < s = ln(255 op), whose half-extents are
// sqrt(2 s c / det) and sqrt(2 s a / det), det = a c - b^2. The box holds
// every pixel whose ROUNDED sigma passes, not only the exact ellipse:
//   - with det > kBoxDetMin * a c, sigma >= (det / 4ac)(a dx^2 + c dy^2),
//     so entry_falloff's rounding (a few ulp of a dx^2 + c dy^2) moves
//     sigma by under 12 ulp * 4ac / det, 7.2e-4 of sigma; expf's and the
//     opacity product's rounding move the threshold by ~1e-6. s is raised
//     by kBoxAbs and then by 1%, the extents by 0.1%, and the box by one
//     pixel and by kBoxPadRel of the centre's offset (the rounding of the
//     box's own arithmetic);
//   - op <= 1/255 (or NaN): raw <= op, never passes: empty;
//   - a non-finite attribute, a conic that is not positive definite or is
//     near-degenerate, or s so large that the sigma clip at 50 keeps raw
//     above 1/255: the whole tile.
// Inside the box entry_falloff still decides. splat/composite.py's
// cull_boxes_plain is this function in torch, operation for operation.
constexpr float kBoxDetMin = 1e-3f;
constexpr float kBoxAbs = 1e-5f;
constexpr float kBoxRaise = 1.01f;    // s * (1 + kBoxRel), kBoxRel = 1e-2
constexpr float kBoxGrow = 1.001f;    // extents * (1 + kBoxRel / 10)
constexpr float kBoxPadRel = 1e-5f;
constexpr float kBoxSigmaMax = 49.0f;

struct Box {
  int x0, x1, y0, y1;
};

__device__ __forceinline__ bool finite(float v) {
  return fabsf(v) <= 3.402823466e38f;   // false for +-inf and NaN
}

// The tile-local pixels i with |i - c| <= r, clipped to [0, tile - 1]
// (empty when lo > hi); the bounds are clipped to [-1, tile] before they
// become integers.
__device__ __forceinline__ void pixel_range(float c, float r, int tile,
                                            int& lo, int& hi) {
  const float edge = static_cast<float>(tile);
  lo = max(static_cast<int>(ceilf(fminf(fmaxf(__fsub_rn(c, r), -1.0f),
                                        edge))), 0);
  hi = min(static_cast<int>(floorf(fmaxf(fminf(__fadd_rn(c, r), edge),
                                         -1.0f))), tile - 1);
}

// a: the entry's attributes; (ox, oy): the tile's first pixel in the image.
__device__ __forceinline__ Box cull_box(const float* a, float ox, float oy,
                                        int tile) {
  const Box empty{0, -1, 0, -1};
  const Box whole{0, tile - 1, 0, tile - 1};
  const float mx = a[0], my = a[1], ca = a[2], cb = a[3], cc = a[4];
  const float op = a[8];
  if (!(op > kAlphaMin)) return empty;
  if (!(finite(mx) && finite(my) && finite(ca) && finite(cb) &&
        finite(cc) && finite(op)))
    return whole;
  const float ac = __fmul_rn(ca, cc);
  const float det = __fsub_rn(ac, __fmul_rn(cb, cb));
  if (!(ca > 0.0f && cc > 0.0f && det > __fmul_rn(kBoxDetMin, ac)))
    return whole;
  const float s = __fmul_rn(
      __fadd_rn(logf(__fmul_rn(255.0f, op)), kBoxAbs), kBoxRaise);
  if (!(s < kBoxSigmaMax)) return whole;
  const float two_s = __fmul_rn(2.0f, s);
  const float ex =
      __fmul_rn(sqrtf(__fdiv_rn(__fmul_rn(two_s, cc), det)), kBoxGrow);
  const float ey =
      __fmul_rn(sqrtf(__fdiv_rn(__fmul_rn(two_s, ca), det)), kBoxGrow);
  // tile-local pixel i has its centre at ox + i + 0.5
  const float cx = __fsub_rn(__fsub_rn(mx, ox), 0.5f);
  const float cy = __fsub_rn(__fsub_rn(my, oy), 0.5f);
  const float rx =
      __fadd_rn(__fadd_rn(ex, 1.0f), __fmul_rn(kBoxPadRel, fabsf(cx)));
  const float ry =
      __fadd_rn(__fadd_rn(ey, 1.0f), __fmul_rn(kBoxPadRel, fabsf(cy)));
  Box b;
  pixel_range(cx, rx, tile, b.x0, b.x1);
  pixel_range(cy, ry, tile, b.y0, b.y1);
  if (b.x0 > b.x1 || b.y0 > b.y1) return empty;
  return b;
}

// ---------------------------------------------------------------------------
// Warp footprints. Each warp owns a kWarpW x kWarpH block of the tile's
// pixels (lane l at (l % kWarpW, l / kWarpW)), so a small splat's box meets
// few warps. The warps cover ceil(tile / kWarpW) x ceil(tile / kWarpH)
// blocks; a lane whose pixel falls outside the tile (tiles that are not a
// multiple of the footprint) is a phantom: it runs with its warp, takes no
// part in the early-exit vote and writes nothing.
constexpr int kWarpW = 8;
constexpr int kWarpH = 4;
constexpr int kMaxWarps = 32;         // tile <= 32: 4 x 8 footprints

struct Layout {
  int warps_x;      // footprints across the tile
  int lx, ly;       // this thread's tile-local pixel
  bool inside;      // the pixel lies in the tile
};

__host__ __device__ __forceinline__ int warps_for(int tile) {
  return ((tile + kWarpW - 1) / kWarpW) * ((tile + kWarpH - 1) / kWarpH);
}

__device__ __forceinline__ Layout thread_layout(int tile) {
  Layout l;
  l.warps_x = (tile + kWarpW - 1) / kWarpW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  l.lx = (warp % l.warps_x) * kWarpW + lane % kWarpW;
  l.ly = (warp / l.warps_x) * kWarpH + lane / kWarpW;
  l.inside = l.lx < tile && l.ly < tile;
  return l;
}

// The per-warp entry masks of a staged batch: bit j of
// mask[q * kWords + j / 32] is set when entry j's cull box meets warp q's
// footprint. One lane per entry computes the box; a ballot per warp q turns
// the 32 lanes' overlap tests into one mask word. Every thread of the block
// must call it. When `warp_bits` is not null, warp_bits[j] gets the set of
// warps (bit q) whose footprint entry j's box meets.
__device__ __forceinline__ void build_masks(const float* sh, int n, int tile,
                                            float ox, float oy, int warps_x,
                                            int n_warps, unsigned* mask,
                                            unsigned* warp_bits) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int base = warp * 32; base < kBatch; base += n_warps * 32) {
    const int j = base + lane;
    Box b{0, -1, 0, -1};
    if (j < n) b = cull_box(sh + j * kAttr, ox, oy, tile);
    unsigned mine = 0;
    for (int q = 0; q < n_warps; ++q) {
      const int fx = (q % warps_x) * kWarpW, fy = (q / warps_x) * kWarpH;
      const bool hit = b.x0 < fx + kWarpW && b.x1 >= fx &&
                       b.y0 < fy + kWarpH && b.y1 >= fy;
      const unsigned word = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) mask[q * kWords + (base >> 5)] = word;
      mine |= static_cast<unsigned>(hit) << q;
    }
    if (warp_bits != nullptr) warp_bits[j] = mine;
  }
}

// Walk the set bits of a warp's mask in ascending entry order (front to
// back); the mask is in shared memory, so the loop is warp-uniform.
template <typename F>
__device__ __forceinline__ void for_each_entry(const unsigned* warp_mask,
                                               F&& f) {
#pragma unroll 1
  for (int wd = 0; wd < kWords; ++wd) {
    unsigned bits = warp_mask[wd];
    while (bits != 0u) {
      const int j = (wd << 5) + __ffs(bits) - 1;
      bits &= bits - 1u;
      f(j);
    }
  }
}

// ---------------------------------------------------------------------------
// Asynchronous staging (cp.async, sm_80+): every thread copies its share of
// a batch from device to shared memory without passing through registers,
// and commits its copies as one group; cp_async_wait<N> waits until at
// most N of the thread's groups are still in flight. `copy_words` copies n
// contiguous 4-byte words: 16-byte copies where the source is 16-byte
// aligned (tile ct's batch at `start` begins (ct * K + start) * 36 bytes
// into the entries and (ct * K + start) * 4 bytes into the indices: aligned
// whenever K % 4 == 0), 4-byte ones otherwise and for the tail. `dst` must
// be 16-byte aligned.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void copy_words(float* dst, const float* src,
                                           int n_words) {
  int i = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0u) {
    const int n4 = n_words >> 2;
    for (; i < n4; i += blockDim.x) cp_async16(dst + 4 * i, src + 4 * i);
    i = (n4 << 2) + static_cast<int>(threadIdx.x);
  }
  for (; i < n_words; i += blockDim.x) cp_async4(dst + i, src + i);
}

__device__ __forceinline__ void stage_batch(float* dst, const float* src,
                                            int n) {
  copy_words(dst, src, n * kAttr);
  cp_async_commit();
}

// The row gather as a staging step: row idx[j] of the (rows, 9) table
// `packed` to dst + 9 j, for j < n, with `idx` already in shared memory.
// A 36-byte row at a 36-byte stride is only 4-byte aligned (and always
// spans two 32-byte sectors), so 4-byte copies, the batch's n * 9 of them
// spread over the block's threads; neighbouring threads copy neighbouring
// words of a row. Issues the copies and does not commit them.
__device__ __forceinline__ void copy_rows(float* dst, const float* packed,
                                          const int* idx, int n) {
  for (int i = threadIdx.x; i < n * kAttr; i += blockDim.x) {
    const int j = i / kAttr;
    cp_async4(dst + i, packed + static_cast<size_t>(idx[j]) * kAttr +
                           (i - j * kAttr));
  }
}

// ---------------------------------------------------------------------------
// Where a tile's batches come from. Both kernels are templates on this, so
// the two routes share every line of the masks, the walk, the early exit
// and the per-pixel arithmetic; only the staging, and the backward's
// epilogue (`put`), differ. A source stages batch 0 in `begin` and, in
// `advance(b, next)`, makes batch b land where every thread of the block
// sees it while batch b + 1 is staged into `next` (the other buffer, whose
// readers finished before a barrier). Batch j holds min(128, count - 128 j)
// entries; `n_batches` is the most the kernel walks. Every thread calls
// `begin` and `advance`.
//
// EntryRows: the gathered entries (C*T, K, 9), tile ct's batch at `start`
// the n * 9 contiguous floats at (ct * K + start) * 9.
struct EntryRows {
  static constexpr int kRingWords = 0;   // shared ints it needs
  static constexpr bool kSkipsEmpty = false;
  const float* entries;
  float* grad;            // the backward's (C*T, K, 9) output, or null
  int k;
  size_t tile;            // the tile's first float in entries and grad
  const float* src;
  int count, n_batches;

  __device__ __forceinline__ void begin(int ct, int count_, int n_batches_,
                                        float* buf, int* /*ring*/) {
    count = count_;
    n_batches = n_batches_;
    tile = static_cast<size_t>(ct) * k * kAttr;
    src = entries + tile;
    if (n_batches > 0) stage_batch(buf, src, min(kBatch, count));
  }

  __device__ __forceinline__ void advance(int b, float* next) {
    const int start = (b + 1) * kBatch;
    if (b + 1 < n_batches) {
      stage_batch(next, src + static_cast<size_t>(start) * kAttr,
                  min(kBatch, count - start));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  // the backward's epilogue: element i (entry j, attribute q) of batch b's
  // gradients, stored whether or not any warp contributed
  __device__ __forceinline__ void put(int b, int /*j*/, int /*q*/, int i,
                                     float sum) {
    grad[tile + static_cast<size_t>(b) * kBatch * kAttr + i] = sum;
  }
};

// PackedRows: rows of the projected table `packed` (C*N, 9) through the
// binning's indices gidx (C*T, K), slot k < count of tile ct being row
// gidx[ct * K + k] (slots at or past count are never read: the binning's
// ent_valid is exactly k < count). Indices are staged two batches ahead
// into a ring of three 128-int buffers in shared memory, so the row copies
// of batch b + 1 are issued from indices that landed with batch b and no
// thread waits on a global load before it walks: in advance(b), batch b's
// rows and batch b + 1's indices land (one group, issued a batch earlier),
// then batch b + 2's indices and batch b + 1's rows are issued as one
// group. The backward's epilogue stores each slot's sums at the slot, as
// EntryRows' does, into a (C*T, K, 9) per-slot gradient; the caller sums
// each table row's slots in a fixed order (the row-sum kernel,
// gather_rows_bwd.cu), so no two blocks ever write one address.
struct PackedRows {
  static constexpr int kRingWords = 3 * kBatch;
  static constexpr bool kSkipsEmpty = true;
  const float* packed;
  const int* gidx;
  float* grad;            // the backward's (C*T, K, 9) output, or null
  int k;
  size_t tile;            // the tile's first float in grad
  const int* idx;
  int* ring;
  int count, n_batches;

  __device__ __forceinline__ int batch_size(int b) const {
    return min(kBatch, count - b * kBatch);
  }

  __device__ __forceinline__ void stage_index(int b) {
    copy_words(reinterpret_cast<float*>(ring + (b % 3) * kBatch),
               reinterpret_cast<const float*>(idx + b * kBatch),
               batch_size(b));
  }

  __device__ __forceinline__ void begin(int ct, int count_, int n_batches_,
                                        float* buf, int* ring_) {
    count = count_;
    n_batches = n_batches_;
    ring = ring_;
    tile = static_cast<size_t>(ct) * k * kAttr;
    idx = gidx + static_cast<size_t>(ct) * k;
    if (n_batches <= 0) return;
    stage_index(0);
    cp_async_commit();
    if (n_batches > 1) stage_index(1);
    cp_async_commit();
    // the first batch's indices: the one wait on a global load before a
    // walk, once per tile
    cp_async_wait<1>();
    __syncthreads();
    copy_rows(buf, packed, ring, batch_size(0));
    cp_async_commit();
  }

  __device__ __forceinline__ void advance(int b, float* next) {
    cp_async_wait<0>();
    __syncthreads();
    // ring slot (b + 2) % 3 held batch b - 1's indices, whose last reader
    // (the row copies of b - 1, issued in advance(b - 2)) finished before
    // the barrier above
    if (b + 1 < n_batches) {
      if (b + 2 < n_batches) stage_index(b + 2);
      copy_rows(next, packed, ring + ((b + 1) % 3) * kBatch,
                batch_size(b + 1));
      cp_async_commit();
    }
  }

  // the backward's epilogue: element i (entry j, attribute q) of batch b's
  // gradients at its slot, for the entries some warp contributed to; an
  // entry with an empty warp set keeps the caller's zero, the sum of no
  // warps that EntryRows stores
  __device__ __forceinline__ void put(int b, int /*j*/, int /*q*/, int i,
                                      float sum) {
    grad[tile + static_cast<size_t>(b) * kBatch * kAttr + i] = sum;
  }
};

}  // namespace composite
