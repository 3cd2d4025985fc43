// The global alignment's correspondence losses and their gradient, in one
// pass, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's losses
// (starst3r_tpu/alignment/ga.py: _loss_3d, _loss_2d, _loss_dust3r on
// _core_pts3d) are jnp code that XLA fuses. On the card their autograd chain
// was the GA step's largest part: batched 3x3 GEMMs and GEMVs of the
// einsums, six row gathers and their row sums, ~280-310 of a replayed
// step's 708-762 launches.
// Here one forward computes
//   loss = main / wsum + loss_dust3r_w * (cf > 0 ? reg / max(cf, 1e-8) : 0)
// with main the weighted annealed robust loss of the correspondences (phase
// 1: 3D distance of the two endpoints; phase 2: reprojection of endpoint 2
// through proj = K @ w2c[:3] of camera 1) and reg the dust3r fallback over
// (pair, core point), and its gradient with respect to K (C, 9), cam2w
// (C, 16), proj (C, 12, phase 2) and the core depth (C, S). The autograd
// Function's backward scales that gradient by the incoming scalar
// (alignment/ga_loss.py).
//
// Bound on this card: bytes. Each correspondence's static data (two
// cameras, two depth rows, two pixels, two depth offsets, a weight) is read
// once by each of its two sides, the depth and camera tables are small and
// cached, and the per-item work is a few dozen float32 operations and two
// powf. At the GA's sizes (1-17 MB) the two launches' latency, not the
// bandwidth, sets the time.
//
// Design. Two launches, no atomics, a fixed summation order:
//   1. items: blocks of 256 threads in three groups.
//      - Side 1 and side 2: the correspondences sorted (stably) by the
//        depth row of that side, img * S + idx, which is the order
//        make_state builds for the row gathers; so each camera's
//        correspondences are one run, and each depth row's a sub-run. Every
//        block owns `chunk` consecutive items of one camera (coff_e and
//        bstart_e: each camera's first item and first block), computes each
//        item whole (both endpoints), the gradient for its own side's
//        camera and depth row, and sums the camera part (17 slots: fx, cx,
//        fy, cy; cam2w rows 0-2; the loss on side 1; in phase 2 side 1's
//        slots 0-11 are proj's gradient) over its items: each thread its
//        items in turn, a shuffle tree over each warp, then the warps in
//        order. The depth row's cotangent goes to ct_e at the item's sorted
//        position.
//      - Fallback (only where cf > 0): a block per (camera c, 256 core
//        points); each point is unprojected once and walks the pairs whose
//        first camera is c in a fixed order against Tp @ preds21, summing
//        its gradient; per pair, the gradient of that pair's second camera
//        is summed over the block (per-pair partials), and per block the
//        camera c part (17 slots).
//   2. finalize: a thread per depth row sums its two runs of ct in order
//      (and adds the fallback's value); a warp per output entry of K,
//      cam2w, proj and the loss sums its partials, lane-strided then a
//      shuffle tree, and adds the parts in a fixed order.
// Which item lands in which partial, and the order of every add, depend
// only on (M, S, C, P), the plan and the static order, so two launches give
// the same bits, and a CUDA graph that replays them the eager launch's
// bits. alignment/ga_loss.py::ga_loss_in_order repeats the same arithmetic
// and order in PyTorch. Built with -fmad=false (kernels.py), so every
// product and sum rounds as that PyTorch code rounds it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 17;  // fx, cx, fy, cy; cam2w rows 0-2; the loss
constexpr int kLoss = 16;
constexpr int kPairSlots = 12;  // cam2w rows 0-2 of a pair's camera 2
constexpr float kEps = 1e-3f;     // meta_gamma_loss's eps
constexpr float kOffset = 1e-12f;  // added to each difference before the norm
constexpr float kZMin = 1e-8f;    // _loss_2d's depth clamp

// the static inputs, the scratch and the outputs, as alignment/ga_loss.py
// lays them out (its _int_layout, _float_layout, _scratch_layout,
// _grad_layout)
struct Dims {
  int C, S, M, P, nb, nj, chunk;
};

struct Ints {
  const int4* ids[2];  // (cam1, cam2, row1, row2) in each side's order
  const int* off[2];   // each side's depth-row runs, C * S + 1
  const int* coff[2];  // each camera's first item, C + 1
  const int* bstart[2];  // each camera's first block, C + 1
  const int* porder1;  // pairs by their first camera
  const int* poff1;
  const int* porder2;  // pairs by their second camera
  const int* poff2;
  const int* pimg2;
};

struct Floats {
  const float4* vals[2];  // (pix1, pix2), (doff1, doff2, w, 0): 2 a item
  const float* core_pix;  // (S, 2)
  const float* preds;     // (P, S, 3)
  const float* fw;        // (P, S)
  const float* scal;      // wsum, 1 / wsum, cf, max(cf, 1e-8), w_d / that
};

struct Scratch {
  float* part[2];  // (nb, kSlots) each side's block partials
  float* fbc;      // (C, nj, kSlots) the fallback's camera partials
  float* fbp;      // (nj, P, kPairSlots) its pair partials
  float* fbd;      // (C * S) its depth gradient
  float* ct[2];    // (M) each side's depth cotangent, in its order
};

struct Outs {
  float* K;      // (C, 9)
  float* cam;    // (C, 16)
  float* proj;   // (C, 12), phase 2
  float* depth;  // (C * S)
  float* loss;   // ()
};

struct Gammas {
  float gamma, gd, gd_m1, eps_gd, wd;
};

__host__ __device__ inline Ints int_layout(const int* p, const Dims& d) {
  Ints o;
  const int64_t cs = static_cast<int64_t>(d.C) * d.S;
  o.ids[0] = reinterpret_cast<const int4*>(p);
  o.ids[1] = reinterpret_cast<const int4*>(p + 4 * int64_t(d.M));
  const int* q = p + 8 * int64_t(d.M);
  o.off[0] = q;
  o.off[1] = q + (cs + 1);
  q += 2 * (cs + 1);
  o.coff[0] = q;
  o.bstart[0] = q + (d.C + 1);
  o.coff[1] = q + 2 * (d.C + 1);
  o.bstart[1] = q + 3 * (d.C + 1);
  q += 4 * (d.C + 1);
  o.porder1 = q;
  o.poff1 = q + d.P;
  o.porder2 = o.poff1 + (d.C + 1);
  o.poff2 = o.porder2 + d.P;
  o.pimg2 = o.poff2 + (d.C + 1);
  return o;
}

__host__ __device__ inline Floats float_layout(const float* p,
                                               const Dims& d) {
  Floats o;
  o.vals[0] = reinterpret_cast<const float4*>(p);
  o.vals[1] = reinterpret_cast<const float4*>(p + 8 * int64_t(d.M));
  const float* q = p + 16 * int64_t(d.M);
  o.core_pix = q;
  q += 2 * int64_t(d.S);
  o.preds = q;
  q += 3 * int64_t(d.P) * d.S;
  o.fw = q;
  q += int64_t(d.P) * d.S;
  o.scal = q;
  return o;
}

__host__ __device__ inline Scratch scratch_layout(float* p, const Dims& d) {
  Scratch o;
  o.part[0] = p;
  p += int64_t(d.nb) * kSlots;
  o.part[1] = p;
  p += int64_t(d.nb) * kSlots;
  o.fbc = p;
  p += int64_t(d.C) * d.nj * kSlots;
  o.fbp = p;
  p += int64_t(d.nj) * d.P * kPairSlots;
  o.fbd = p;
  p += int64_t(d.C) * d.S;
  o.ct[0] = p;
  o.ct[1] = p + d.M;
  return o;
}

__host__ __device__ inline Outs grad_layout(float* p, float* loss,
                                            const Dims& d, int phase) {
  Outs o;
  o.K = p;
  o.cam = p + 9 * int64_t(d.C);
  o.proj = p + 25 * int64_t(d.C);
  o.depth = o.proj + (phase == 2 ? 12 * int64_t(d.C) : 0);
  o.loss = loss;
  return o;
}

struct Cam {
  float fx, cx, fy, cy;
  float T[12];  // cam2w rows 0-2
};

__device__ __forceinline__ void load_cam(const float* K, const float* cam2w,
                                         int c, Cam& m) {
  const float* k = K + 9 * c;
  m.fx = __ldg(k);
  m.cx = __ldg(k + 2);
  m.fy = __ldg(k + 4);
  m.cy = __ldg(k + 5);
  const float* t = cam2w + 16 * c;
#pragma unroll
  for (int i = 0; i < 12; ++i) m.T[i] = __ldg(t + i);
}

// the ray through pixel (px, py) at depth z: q = (a z, b z, z) with
// a = (px - cx) / fx, b = (py - cy) / fy, and p = R q + t
struct Ray {
  float a, b, q[3], p[3];
};

__device__ __forceinline__ void unproject(const Cam& m, float px, float py,
                                          float z, Ray& r) {
  r.a = (px - m.cx) / m.fx;
  r.b = (py - m.cy) / m.fy;
  r.q[0] = r.a * z;
  r.q[1] = r.b * z;
  r.q[2] = z;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r.p[i] = ((m.T[4 * i] * r.q[0] + m.T[4 * i + 1] * r.q[1]) +
              m.T[4 * i + 2] * r.q[2]) +
             m.T[4 * i + 3];
  }
}

// unproject's backward for the gradient gp of p: adds the camera's part to
// acc (slots 0-15) and returns the gradient of z
__device__ __forceinline__ float unproject_bwd(const Cam& m, const Ray& r,
                                               const float gp[3],
                                               float* acc) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[4 + 4 * i + j] += gp[i] * r.q[j];
    acc[4 + 4 * i + 3] += gp[i];
  }
  float gq[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gq[j] = (m.T[j] * gp[0] + m.T[4 + j] * gp[1]) + m.T[8 + j] * gp[2];
  }
  const float z = r.q[2];
  const float ga = gq[0] * z, gb = gq[1] * z;
  acc[0] += -(ga * r.a) / m.fx;
  acc[1] += -(ga / m.fx);
  acc[2] += -(gb * r.b) / m.fy;
  acc[3] += -(gb / m.fy);
  return (gq[2] + gq[0] * r.a) + gq[1] * r.b;
}

// each warp's shuffle tree to lane 0, then thread i < N adds the warps'
// sums in warp order and writes out[i]; every thread of the block calls it
template <int N>
__device__ __forceinline__ void block_sum(const float (&v)[N], float* smem,
                                          float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
    }
    if (lane == 0) smem[warp * N + i] = x;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = smem[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += smem[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// the annealed exponent g = alpha * 1 + (1 - alpha) * gamma, as
// utils/schedules.py::meta_gamma_loss computes it in float32
__device__ __forceinline__ float exponent(float alpha, float gamma) {
  return alpha * 1.0f + (1.0f - alpha) * gamma;
}

// one correspondence of side E (0: side 1, 1: side 2) in phase PHASE: adds
// its side's camera part (and, on side 1, its weighted loss) to acc, and
// returns its side's depth cotangent
template <int PHASE, int E>
__device__ __forceinline__ float corr_item(
    const int4 id, const float4 px, const float4 ex, const float* K,
    const float* cam2w, const float* depth, const float* proj, float g,
    float g_m1, float eps_g, float coef_main, float* acc) {
  const float w = ex.z;
  if constexpr (PHASE == 1) {
    Cam m1, m2;
    load_cam(K, cam2w, id.x, m1);
    load_cam(K, cam2w, id.y, m2);
    Ray r1, r2;
    unproject(m1, px.x, px.y, __ldg(depth + id.z) * ex.x, r1);
    unproject(m2, px.z, px.w, __ldg(depth + id.w) * ex.y, r2);
    float v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) v[i] = (r1.p[i] - r2.p[i]) + kOffset;
    const float dist = sqrtf((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]);
    const float base = dist + kEps;
    if (E == 0) acc[kLoss] += w * (powf(base, g) - eps_g);
    const float coef = (coef_main * w) * (g * powf(base, g_m1));
    const float h = coef / dist;
    float gp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) gp[i] = E == 0 ? h * v[i] : -(h * v[i]);
    const float gz = unproject_bwd(E == 0 ? m1 : m2, E == 0 ? r1 : r2, gp,
                                   acc);
    return gz * (E == 0 ? ex.x : ex.y);
  } else {
    Cam m2;
    load_cam(K, cam2w, id.y, m2);
    Ray r2;
    unproject(m2, px.z, px.w, __ldg(depth + id.w) * ex.y, r2);
    const float* P = proj + 12 * id.x;
    float Pm[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) Pm[i] = __ldg(P + i);
    float hm[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      hm[i] = ((Pm[4 * i] * r2.p[0] + Pm[4 * i + 1] * r2.p[1]) +
               Pm[4 * i + 2] * r2.p[2]) +
              Pm[4 * i + 3];
    }
    const bool small = fabsf(hm[2]) < kZMin;
    const float zc = small ? kZMin : hm[2];
    const float u = hm[0] / zc, vv = hm[1] / zc;
    const float e0 = (u - px.x) + kOffset, e1 = (vv - px.y) + kOffset;
    const float dist = sqrtf(e0 * e0 + e1 * e1);
    const float base = dist + kEps;
    if (E == 0) acc[kLoss] += w * (powf(base, g) - eps_g);
    const float coef = (coef_main * w) * (g * powf(base, g_m1));
    const float h = coef / dist;
    const float ge0 = h * e0, ge1 = h * e1;
    float gh[3];
    gh[0] = ge0 / zc;
    gh[1] = ge1 / zc;
    gh[2] = small ? 0.0f : -ge0 * (u / zc) + -ge1 * (vv / zc);
    if (E == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[4 * i + j] += gh[i] * r2.p[j];
        acc[4 * i + 3] += gh[i];
      }
      return 0.0f;
    } else {
      float gp[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gp[j] = (Pm[j] * gh[0] + Pm[4 + j] * gh[1]) + Pm[8 + j] * gh[2];
      }
      return unproject_bwd(m2, r2, gp, acc) * ex.y;
    }
  }
}

template <int PHASE, int E>
__device__ void side_block(int b, const Dims& d, const Ints& ii,
                           const Floats& ff, const Scratch& sc,
                           const float* K, const float* cam2w,
                           const float* depth, const float* proj, float g,
                           float g_m1, float eps_g, float* smem) {
  const int* bstart = ii.bstart[E];
  // the camera whose blocks hold b: the last c with bstart[c] <= b
  int lo_c = 0, hi_c = d.C;  // bstart[lo_c] <= b < bstart[hi_c] if b lives
  if (b >= bstart[d.C]) return;  // past the last camera's blocks: no items
  while (hi_c - lo_c > 1) {
    const int mid = (lo_c + hi_c) >> 1;
    if (bstart[mid] <= b) lo_c = mid; else hi_c = mid;
  }
  const int c = lo_c;
  const int lo = ii.coff[E][c] + (b - bstart[c]) * d.chunk;
  const int end = ii.coff[E][c + 1];
  const int hi = lo + d.chunk < end ? lo + d.chunk : end;
  const float coef_main = ff.scal[1];
  float acc[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) acc[i] = 0.0f;
  const bool has_ct = PHASE == 1 || E == 1;
  for (int k = lo + threadIdx.x; k < hi; k += kThreads) {
    const int4 id = __ldg(ii.ids[E] + k);
    const float4 px = __ldg(ff.vals[E] + 2 * int64_t(k));
    const float4 ex = __ldg(ff.vals[E] + 2 * int64_t(k) + 1);
    const float gz = corr_item<PHASE, E>(id, px, ex, K, cam2w, depth, proj,
                                         g, g_m1, eps_g, coef_main, acc);
    if (has_ct) sc.ct[E][k] = gz;
  }
  block_sum<kSlots>(acc, smem, sc.part[E] + int64_t(b) * kSlots);
}

__device__ void fallback_block(int c, int j, const Dims& d, const Ints& ii,
                               const Floats& ff, const Scratch& sc,
                               const float* K, const float* cam2w,
                               const float* depth, const Gammas& gm,
                               float* smem) {
  const int s = j * kThreads + threadIdx.x;
  const bool live = s < d.S;
  const float coef_fb = ff.scal[4];
  Cam m;
  Ray r;
  float gpt[3] = {0.0f, 0.0f, 0.0f};
  float lacc = 0.0f;
  if (live) {
    load_cam(K, cam2w, c, m);
    unproject(m, __ldg(ff.core_pix + 2 * s), __ldg(ff.core_pix + 2 * s + 1),
              __ldg(depth + int64_t(c) * d.S + s), r);
  }
  for (int k = ii.poff1[c]; k < ii.poff1[c + 1]; ++k) {
    const int p = ii.porder1[k];
    float pacc[kPairSlots];
#pragma unroll
    for (int i = 0; i < kPairSlots; ++i) pacc[i] = 0.0f;
    if (live) {
      const float* T2 = cam2w + 16 * ii.pimg2[p];
      const float* rp = ff.preds + 3 * (int64_t(p) * d.S + s);
      const float r0 = __ldg(rp), r1 = __ldg(rp + 1), r2 = __ldg(rp + 2);
      float v[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float tgt = ((__ldg(T2 + 4 * i) * r0 + __ldg(T2 + 4 * i + 1) *
                            r1) + __ldg(T2 + 4 * i + 2) * r2) +
                          __ldg(T2 + 4 * i + 3);
        v[i] = (r.p[i] - tgt) + kOffset;
      }
      const float dist = sqrtf((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]);
      const float base = dist + kEps;
      const float wf = __ldg(ff.fw + int64_t(p) * d.S + s);
      lacc += wf * (powf(base, gm.gd) - gm.eps_gd);
      const float coef = (coef_fb * wf) * (gm.gd * powf(base, gm.gd_m1));
      const float h = coef / dist;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float gv = h * v[i];
        gpt[i] += gv;
        pacc[4 * i] = -gv * r0;
        pacc[4 * i + 1] = -gv * r1;
        pacc[4 * i + 2] = -gv * r2;
        pacc[4 * i + 3] = -gv;
      }
    }
    block_sum<kPairSlots>(
        pacc, smem, sc.fbp + (int64_t(j) * d.P + p) * kPairSlots);
  }
  float acc[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) acc[i] = 0.0f;
  if (live) {
    sc.fbd[int64_t(c) * d.S + s] = unproject_bwd(m, r, gpt, acc);
    acc[kLoss] = lacc;
  }
  block_sum<kSlots>(acc, smem, sc.fbc + (int64_t(c) * d.nj + j) * kSlots);
}

template <int PHASE>
__global__ void __launch_bounds__(kThreads)
    ga_loss_items(Dims d, const int* istat, const float* fstat,
                  float* scratch, const float* K, const float* cam2w,
                  const float* depth, const float* proj, const float* alpha,
                  Gammas gm) {
  __shared__ float smem[kWarps * kSlots];
  const Ints ii = int_layout(istat, d);
  const Floats ff = float_layout(fstat, d);
  const Scratch sc = scratch_layout(scratch, d);
  const int b = blockIdx.x;
  if (b < 2 * d.nb) {
    const float g = exponent(__ldg(alpha), gm.gamma);
    const float g_m1 = g - 1.0f;
    const float eps_g = powf(kEps, g);
    if (b < d.nb) {
      side_block<PHASE, 0>(b, d, ii, ff, sc, K, cam2w, depth, proj, g, g_m1,
                           eps_g, smem);
    } else {
      side_block<PHASE, 1>(b - d.nb, d, ii, ff, sc, K, cam2w, depth, proj,
                           g, g_m1, eps_g, smem);
    }
    return;
  }
  if (!(ff.scal[2] > 0.0f)) return;  // no fallback weight: reg is 0
  const int f = b - 2 * d.nb;
  fallback_block(f / d.nj, f % d.nj, d, ii, ff, sc, K, cam2w, depth, gm,
                 smem);
}

// lane-strided sums of at(0..n-1) (lane l: at(l), at(l + 32), ... in turn
// from 0), then a shuffle tree; the sum is lane 0's
template <typename F>
__device__ __forceinline__ float warp_sum(int n, F at) {
  float s = 0.0f;
  for (int i = threadIdx.x & 31; i < n; i += 32) s += at(i);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// K's entry -> its slot (fx, cx, fy, cy), or -1 for the entries no loss
// reads
__device__ __forceinline__ int k_slot(int e) {
  return e == 0 ? 0 : e == 2 ? 1 : e == 4 ? 2 : e == 5 ? 3 : -1;
}

template <int PHASE>
__global__ void __launch_bounds__(kThreads)
    ga_loss_finalize(Dims d, const int* istat, const float* fstat,
                     const float* scratch_c, float* grads, float* loss,
                     float wd, int depth_blocks) {
  const Ints ii = int_layout(istat, d);
  const Floats ff = float_layout(fstat, d);
  const Scratch sc = scratch_layout(const_cast<float*>(scratch_c), d);
  const Outs out = grad_layout(grads, loss, d, PHASE);
  const bool fallback = ff.scal[2] > 0.0f;
  if (static_cast<int>(blockIdx.x) < depth_blocks) {
    const int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x;
    if (r >= int64_t(d.C) * d.S) return;
    float total = 0.0f;
    if (PHASE == 1) {
      float s1 = 0.0f;
      for (int k = ii.off[0][r]; k < ii.off[0][r + 1]; ++k) s1 += sc.ct[0][k];
      float s2 = 0.0f;
      for (int k = ii.off[1][r]; k < ii.off[1][r + 1]; ++k) s2 += sc.ct[1][k];
      total = s1 + s2;
    } else {
      for (int k = ii.off[1][r]; k < ii.off[1][r + 1]; ++k) {
        total += sc.ct[1][k];
      }
    }
    if (fallback) total = total + sc.fbd[r];
    out.depth[r] = total;
    return;
  }
  const int warp = (blockIdx.x - depth_blocks) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int C = d.C;
  const int n_k = 9 * C, n_cam = 16 * C, n_proj = PHASE == 2 ? 12 * C : 0;
  const int n_out = n_k + n_cam + n_proj;
  if (warp > n_out) return;
  // the side partials of camera c, slot `slot`
  auto side = [&](int e, int c, int slot) {
    const float* part = sc.part[e];
    const int b0 = ii.bstart[e][c];
    return warp_sum(ii.bstart[e][c + 1] - b0, [&](int i) {
      return part[int64_t(b0 + i) * kSlots + slot];
    });
  };
  auto fb_cam = [&](int c, int slot) {
    return warp_sum(d.nj, [&](int i) {
      return sc.fbc[(int64_t(c) * d.nj + i) * kSlots + slot];
    });
  };
  float value = 0.0f;
  if (warp == n_out) {  // the loss
    const float main = warp_sum(ii.bstart[0][C], [&](int i) {
      return sc.part[0][int64_t(i) * kSlots + kLoss];
    });
    float reg = 0.0f;
    if (fallback) {
      reg = warp_sum(C * d.nj, [&](int i) {
        return sc.fbc[int64_t(i) * kSlots + kLoss];
      }) / ff.scal[3];
    }
    if (lane == 0) *out.loss = main / ff.scal[0] + wd * reg;
    return;
  }
  if (warp < n_k) {
    const int c = warp / 9, slot = k_slot(warp % 9);
    if (slot >= 0) {
      value = PHASE == 1 ? side(0, c, slot) + side(1, c, slot)
                         : side(1, c, slot);
      if (fallback) value = value + fb_cam(c, slot);
    }
    if (lane == 0) out.K[warp] = value;
  } else if (warp < n_k + n_cam) {
    const int o = warp - n_k, c = o / 16, e = o % 16;
    if (e < 12) {
      const int slot = 4 + e;
      value = PHASE == 1 ? side(0, c, slot) + side(1, c, slot)
                         : side(1, c, slot);
      if (fallback) {
        value = value + fb_cam(c, slot);
        const int k0 = ii.poff2[c];
        value = value + warp_sum((ii.poff2[c + 1] - k0) * d.nj, [&](int i) {
          const int p = ii.porder2[k0 + i / d.nj], jj = i % d.nj;
          return sc.fbp[(int64_t(jj) * d.P + p) * kPairSlots + e];
        });
      }
    }
    if (lane == 0) out.cam[o] = value;
  } else {
    const int o = warp - n_k - n_cam, c = o / 12, e = o % 12;
    value = side(0, c, e);
    if (lane == 0) out.proj[o] = value;
  }
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

template <int PHASE>
cudaError_t run(const Dims& d, const float* K, const float* cam2w,
                const float* depth, const float* proj, const float* alpha,
                const int* istat, const float* fstat, float* scratch,
                float* grads, float* loss, const Gammas& gm,
                cudaStream_t stream) {
  const int64_t item_blocks = 2 * int64_t(d.nb) + int64_t(d.C) * d.nj;
  const int64_t depth_blocks =
      (int64_t(d.C) * d.S + kThreads - 1) / kThreads;
  const int64_t n_out = (PHASE == 2 ? 37 : 25) * int64_t(d.C) + 1;
  const int64_t out_blocks = (n_out + kWarps - 1) / kWarps;
  if (item_blocks > 0x7fffffff || depth_blocks + out_blocks > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  if (item_blocks > 0) {
    ga_loss_items<PHASE><<<static_cast<unsigned>(item_blocks), kThreads, 0,
                           stream>>>(d, istat, fstat, scratch, K, cam2w,
                                     depth, proj, alpha, gm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ga_loss_finalize<PHASE>
      <<<static_cast<unsigned>(depth_blocks + out_blocks), kThreads, 0,
         stream>>>(d, istat, fstat, scratch, grads, loss, gm.wd,
                   static_cast<int>(depth_blocks));
  return cudaGetLastError();
}

}  // namespace

// Launches the two kernels on `stream` (PyTorch's current stream). The
// static inputs istat / fstat, the scratch and the gradient are laid out as
// alignment/ga_loss.py lays them out for (C, S, M, P) and the plan (ipt
// items a thread, nb blocks a side, nj fallback blocks a camera); istat
// and fstat must be 16-byte aligned. Returns the CUDA error code,
// cudaErrorInvalidValue for a shape or plan the kernels do not take.
extern "C" int ga_loss(const float* K, const float* cam2w, const float* depth,
                       const float* proj, const float* alpha,
                       const int* istat, const float* fstat, float* scratch,
                       float* grads, float* loss, int phase, int C, int S,
                       int M, int P, int ipt, int nb, int nj, float gamma,
                       float gd, float gd_m1, float eps_gd, float wd,
                       void* stream) {
  if ((phase != 1 && phase != 2) || C < 1 || S < 1 || M < 0 || P < 0 ||
      !pow2(ipt) || ipt > 64 || nb < C ||
      int64_t(nb - C) * ipt * kThreads < M || nj != (S + kThreads - 1) /
      kThreads || (phase == 2 && proj == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Dims d{C, S, M, P, nb, nj, ipt * kThreads};
  const Gammas gm{gamma, gd, gd_m1, eps_gd, wd};
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      phase == 1 ? run<1>(d, K, cam2w, depth, proj, alpha, istat, fstat,
                          scratch, grads, loss, gm, s)
                 : run<2>(d, K, cam2w, depth, proj, alpha, istat, fstat,
                          scratch, grads, loss, gm, s);
  return static_cast<int>(err);
}
