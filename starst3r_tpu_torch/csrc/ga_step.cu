// The global alignment's step around its fused loss (ga_loss.cu), for
// Hopper (sm_90a): the reparameterisation before the loss, and its
// backward with the masked Adam step after it.
//
// Replaces no Pallas kernel: the JAX package's step
// (starst3r_tpu/alignment/ga.py: _make_K_cam_depth, jax.grad of the
// losses, optax's Adam, the quaternion renormalisation and the NaN freeze)
// is jnp code that XLA fuses into its jitted chunk. On the card the port's
// step was PyTorch ops around the fused loss: the reparameterisation's
// forward (the focal clamp, K, the scale, two quaternion normalisations,
// the MST chain as C - 1 separate 4 x 4 products, the centring, the
// inverse, proj = K @ w2c[:3], the core depth), autograd's backward of all
// that, and Adam written per leaf with a `where` and a copy for each of 18
// state tensors: ~425 launches of a few hundred to 18k floats each, so a
// replayed step was ~0.6 ms of launch gaps (alignment/ga.py::_Phase).
//
// Bound on this card: launches and latency. The work is a few thousand
// float32 operations a camera and a few dozen a core point (C = 4-10
// cameras, S = 560-4,096 core points; with the lora basis, k more a point),
// a few hundred kB at most: far below a microsecond of bandwidth, so what
// is left is each launch's fixed cost and the chains of dependent loads.
// So each half is one launch, and the serial parts are short:
//   ga_reparam: one block per (camera, 256 core points) writes the core
//     values and the depth, and one more block the cameras: a thread per
//     camera computes its intrinsics, scale, rotation and relative pose;
//     one warp composes the MST chain in topological order, an entry a
//     lane; a thread per camera centres it and writes K, cam2w, w2c and
//     proj; thread 0 alpha.
//   ga_update: one thread-block cluster of 8 blocks of 512 threads.
//     (0) every block: a thread per camera computes its forward values into
//     shared memory; (A) the cluster's threads share each camera's core
//     points (thread t its points s = t, t + 4096, ... in turn, loaded 4 at
//     a time, the next batch before this one runs): each point's Adam step,
//     and the depth's gradient summed over the camera's points (a shuffle
//     tree over each warp, the 128 warps added in order by block 0); (B,
//     lora) each coefficient's gradient, a group of threads a share of the
//     points in turn, the groups in order. After the cluster's barrier
//     (no atomics), block 0 alone: (C) a thread per camera: the backward
//     through proj, the inverse, the centring and the focal; (D) one warp:
//     the chain's backward, the edges in reverse, an entry a lane; then one
//     thread the sums across cameras (the global scale's, split evenly
//     among the tied smallest sizes as torch.min's backward splits it; the
//     shared intrinsics' means); (E) a thread per camera: the quaternion's
//     backward through the rotation and both normalisations, each leaf's
//     masked Adam step, the renormalised quaternion, the freeze; thread 0
//     the last loss, the flag, the count.
// Every sum has a fixed order, so two launches, and a CUDA graph replaying
// them, give the same bits. alignment/ga_step.py::reparam_in_order and
// update_in_order repeat this arithmetic and order in PyTorch. Built with
// -fmad=false (kernels.py), so every product and sum rounds as that
// PyTorch code rounds it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;        // ga_reparam: core points a block
constexpr int kUpdateThreads = 512;  // threads of a ga_update block
constexpr int kRanks = 8;            // ga_update's blocks: one cluster
constexpr int kSumThreads = kUpdateThreads * kRanks;
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kStatics = 8;  // W, H, base focal, median, fmin, fmax, free, 0
constexpr int kWork = 112;   // the update's per-camera slots (below)
constexpr int kBatch = 4;    // core points a thread loads at once in stage A
// the shared memory a block keeps per-camera values in (the update's work
// slots, the reparameterisation's relative poses and chain) where they fit;
// past it they stay in the step buffer
constexpr int kSmemFloats = 12 * 1024;
constexpr float kQEps = 1e-12f;  // quat_normalize's eps

// flags
constexpr int kShared = 1, kExpDepth = 2, kMul = 4, kOptPP = 8,
              kOptDepth = 16;

// the update's per-camera work slots: the forward's scalars, the depth's
// sums, the backward's values, and the camera's CamFwd (below)
constexpr int wZ = 0, wMs = 1, wGs = 2, wAGs = 3, wAZ = 4, wAMs = 5,
              wGChain = 6, wGGs = 18, wGLf = 19, wGPp = 20, wGSz = 22,
              wGRel = 23, wSz = 35, wMn = 36, wFwd = 48;

struct Dims {
  int C, S, k, flags, niter;
};

// the step buffer, as alignment/ga_step.py::_fwd_layout lays it out
struct Buf {
  float *K, *cam2w, *w2c, *proj, *depth, *alpha, *rel, *chain, *core,
      *gcore, *work, *wpart, *gcc, *lpart;
};

__host__ __device__ inline Buf buf_layout(float* p, const Dims& d) {
  const int64_t C = d.C, S = d.S, k = d.k;
  Buf b;
  b.K = p;
  p += 9 * C;
  b.cam2w = p;
  p += 16 * C;
  b.w2c = p;
  p += 16 * C;
  b.proj = p;
  p += 12 * C;
  b.depth = p;
  p += C * S;
  b.alpha = p;
  p += 4;  // alpha and 3 of padding
  b.rel = p;
  p += 12 * C;
  b.chain = p;
  p += 12 * C;
  b.core = p;
  p += C * S;
  b.gcore = p;
  p += k ? C * S : 0;
  b.work = p;
  p += C * kWork;
  b.wpart = p;  // each warp's three partial sums of the depth's terms
  p += C * kSumWarps * 3;
  b.gcc = p;
  p += C * k;
  b.lpart = p;
  return b;
}

// the leaves of ga.GAParams, in order
struct Leaves {
  float* p[6];
};

struct State {
  float* p[6];
  float* mu[6];
  float* nu[6];
  long long* count;
  bool* stopped;
  float* last_loss;
};

struct Hyper {
  float lr_end, dlr, b1, omb1, b2, omb2, eps, pi;
};

// the block's rank in its thread-block cluster, and the cluster's barrier
// (release, then acquire: every block's writes before it are seen by every
// block after it), in PTX: cooperative_groups' header would double the
// source's build time
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the larger / smaller, NaN where either is (torch.maximum's, minimum's)
__device__ __forceinline__ float tmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

// a camera's values of the reparameterisation before the MST chain
struct CamFwd {
  float e, m1, f, ppx, ppy, sz, mn, gs, zq, z, ms;
  float WF[2], h[2], A[2], to[3];
  float q0[4], n1, q1[4], n2, q2[4], R[9], t[3];
};

__device__ void camera_forward(const Leaves& lv, const float* fstat,
                               const Dims& d, int c, CamFwd& v) {
  const float* st = fstat + kStatics * c;
  const float *pps = lv.p[0], *lf = lv.p[1], *q = lv.p[2], *t = lv.p[3],
              *ls = lv.p[4];
  float lfc, ppc0, ppc1;
  if (d.flags & kShared) {
    float s = lf[0], s0 = pps[0], s1 = pps[1];
    for (int i = 1; i < d.C; ++i) {
      s = s + lf[i];
      s0 = s0 + pps[2 * i];
      s1 = s1 + pps[2 * i + 1];
    }
    lfc = s / static_cast<float>(d.C);
    ppc0 = s0 / static_cast<float>(d.C);
    ppc1 = s1 / static_cast<float>(d.C);
  } else {
    lfc = lf[c];
    ppc0 = pps[2 * c];
    ppc1 = pps[2 * c + 1];
  }
  v.e = expf(lfc);
  v.m1 = tmax(v.e, st[4]);
  v.f = tmin(v.m1, st[5]);
  v.ppx = ppc0 * st[0];
  v.ppy = ppc1 * st[1];
  v.sz = expf(ls[c]);
  float mn = expf(ls[0]);
  for (int i = 1; i < d.C; ++i) mn = tmin(mn, expf(ls[i]));
  v.mn = mn;
  v.gs = 1.0f / mn;
  v.zq = v.sz * st[3];
  v.z = (v.zq * v.f) / st[2];
  v.ms = st[3] * v.sz;
  v.WF[0] = st[0] / v.f;
  v.WF[1] = st[1] / v.f;
  v.h[0] = 0.5f - ppc0;
  v.h[1] = 0.5f - ppc1;
  v.A[0] = v.WF[0] * v.h[0];
  v.A[1] = v.WF[1] * v.h[1];
  v.to[0] = v.z * v.A[0];
  v.to[1] = v.z * v.A[1];
  v.to[2] = v.z;
  float ss = 0.0f;
  for (int i = 0; i < 4; ++i) {
    v.q0[i] = q[4 * c + i];
    ss = i == 0 ? v.q0[0] * v.q0[0] : ss + v.q0[i] * v.q0[i];
  }
  v.n1 = rsqrtf(ss + kQEps);
  for (int i = 0; i < 4; ++i) {
    v.q1[i] = v.q0[i] * v.n1;
    ss = i == 0 ? v.q1[0] * v.q1[0] : ss + v.q1[i] * v.q1[i];
  }
  v.n2 = rsqrtf(ss + kQEps);
  for (int i = 0; i < 4; ++i) v.q2[i] = v.q1[i] * v.n2;
  const float w = v.q2[0], x = v.q2[1], y = v.q2[2], z = v.q2[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  v.R[0] = 1.0f - 2.0f * (yy + zz);
  v.R[1] = 2.0f * (xy - wz);
  v.R[2] = 2.0f * (xz + wy);
  v.R[3] = 2.0f * (xy + wz);
  v.R[4] = 1.0f - 2.0f * (xx + zz);
  v.R[5] = 2.0f * (yz - wx);
  v.R[6] = 2.0f * (xz - wy);
  v.R[7] = 2.0f * (yz + wx);
  v.R[8] = 1.0f - 2.0f * (xx + yy);
  for (int i = 0; i < 3; ++i) v.t[i] = t[3 * c + i];
}

// entry e < 12 of out = A @ B of two poses (3 x 4 rows, last row 0 0 0 1)
__device__ __forceinline__ float compose_entry(const float* A,
                                               const float* B, int e) {
  const int i = e / 4, j = e % 4;
  float s = (A[4 * i] * B[j] + A[4 * i + 1] * B[4 + j]) +
            A[4 * i + 2] * B[8 + j];
  if (j == 3) s = s + A[4 * i + 3];
  return s;
}

// the core value of (camera c, point s) before the depth mode
__device__ __forceinline__ float core_value(const Leaves& lv,
                                            const float* basis,
                                            const float* cc, const Dims& d,
                                            int c, int s) {
  if (d.k == 0) {
    const float v = lv.p[5][int64_t(c) * d.S + s];
    return (d.flags & kExpDepth) ? expf(v) : v;
  }
  const float* b = basis + (int64_t(c) * d.S + s) * d.k;
  float acc = b[0] * cc[0];
  for (int i = 1; i < d.k; ++i) acc = acc + b[i] * cc[i];
  return acc;
}

__device__ __forceinline__ float depth0(float core, float z, float ms,
                                        int flags) {
  return (flags & kMul) ? z * core : z + (core - 1.0f) * ms;
}

// the cameras' block of ga_reparam; `sm` holds the relative poses and the
// chain where they fit
__device__ void reparam_cameras(const Leaves& lv, const long long* count,
                                const float* fstat, const int* istat,
                                const Buf& b, const Dims& d, float* sm) {
  const bool in_smem = 24 * d.C <= kSmemFloats;
  float* rel = in_smem ? sm : b.rel;
  float* chain = in_smem ? sm + 12 * d.C : b.chain;
  for (int c = threadIdx.x; c < d.C; c += blockDim.x) {
    CamFwd v;
    camera_forward(lv, fstat, d, c, v);
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        rel[12 * c + 4 * i + j] = v.R[3 * i + j];
        b.rel[12 * c + 4 * i + j] = v.R[3 * i + j];
      }
      rel[12 * c + 4 * i + 3] = v.t[i];
      b.rel[12 * c + 4 * i + 3] = v.t[i];
    }
  }
  __syncthreads();
  // the chain, one warp: an entry a lane, the edges in topological order
  const int lane = threadIdx.x;
  if (lane < 12) {
    const int root = istat[0], E = istat[1];
    chain[12 * root + lane] = rel[12 * root + lane];
    for (int e = 0; e < E; ++e) {
      __syncwarp(0xfffu);
      const int p = istat[2 + e], ch = istat[2 + E + e];
      chain[12 * ch + lane] = compose_entry(chain + 12 * p, rel + 12 * ch,
                                            lane);
    }
  }
  if (threadIdx.x == 0) {
    const float frac = static_cast<float>(*count) /
                       static_cast<float>(d.niter > 1 ? d.niter : 1);
    *b.alpha = 1.0f - frac;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d.C; c += blockDim.x) {
    CamFwd v;
    camera_forward(lv, fstat, d, c, v);
    const float* ch = chain + 12 * c;
    if (in_smem) {
      for (int i = 0; i < 12; ++i) b.chain[12 * c + i] = ch[i];
    }
    float nt[3], ti[3];
    for (int a = 0; a < 3; ++a) {
      const float u = (ch[4 * a] * v.to[0] + ch[4 * a + 1] * v.to[1]) +
                      ch[4 * a + 2] * v.to[2];
      nt[a] = v.gs * (ch[4 * a + 3] - u);
    }
    for (int i = 0; i < 3; ++i) {
      ti[i] = -((ch[i] * nt[0] + ch[4 + i] * nt[1]) + ch[8 + i] * nt[2]);
    }
    float* K = b.K + 9 * c;
    K[0] = v.f;
    K[1] = 0.0f;
    K[2] = v.ppx;
    K[3] = 0.0f;
    K[4] = v.f;
    K[5] = v.ppy;
    K[6] = 0.0f;
    K[7] = 0.0f;
    K[8] = 1.0f;
    float* T = b.cam2w + 16 * c;
    float* W = b.w2c + 16 * c;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        T[4 * i + j] = ch[4 * i + j];
        W[4 * i + j] = ch[4 * j + i];
      }
      T[4 * i + 3] = nt[i];
      W[4 * i + 3] = ti[i];
    }
    for (int j = 0; j < 4; ++j) {
      T[12 + j] = j == 3 ? 1.0f : 0.0f;
      W[12 + j] = j == 3 ? 1.0f : 0.0f;
    }
    float* P = b.proj + 12 * c;
    for (int j = 0; j < 4; ++j) {
      P[j] = v.f * W[j] + v.ppx * W[8 + j];
      P[4 + j] = v.f * W[4 + j] + v.ppy * W[8 + j];
      P[8 + j] = W[8 + j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ga_reparam_kernel(Leaves lv, const long long* count, const float* fstat,
                      const int* istat, float* buf, Dims d, int nj) {
  // the (exp of the) lora coefficients, or the cameras' block's poses
  extern __shared__ float cc[];
  const Buf b = buf_layout(buf, d);
  if (static_cast<int>(blockIdx.x) == d.C * nj) {
    reparam_cameras(lv, count, fstat, istat, b, d, cc);
    return;
  }
  const int c = blockIdx.x / nj, j = blockIdx.x % nj;
  __shared__ float zs[3];  // z, ms, gs of the block's camera
  if (threadIdx.x == 0) {
    CamFwd v;
    camera_forward(lv, fstat, d, c, v);
    zs[0] = v.z;
    zs[1] = v.ms;
    zs[2] = v.gs;
  }
  for (int i = threadIdx.x; i < d.k; i += blockDim.x) {
    const float x = lv.p[5][int64_t(c) * d.k + i];
    cc[i] = (d.flags & kExpDepth) ? expf(x) : x;
  }
  __syncthreads();
  const int s = j * kThreads + threadIdx.x;
  if (s >= d.S) return;
  const float core =
      core_value(lv, fstat + int64_t(kStatics) * d.C, cc, d, c, s);
  const int64_t r = int64_t(c) * d.S + s;
  b.core[r] = core;
  b.depth[r] = zs[2] * depth0(core, zs[0], zs[1], d.flags);
}

struct Step {
  float lr, bc1, bc2;
  bool stop;
};

// Adam's step on one entry's values (x, mu, nu), masked, in optax's order
__device__ __forceinline__ void adam_values(float& x, float& mu, float& nu,
                                            float g, float mask,
                                            const Step& st,
                                            const Hyper& hp) {
  g = g * mask;
  mu = hp.omb1 * g + hp.b1 * mu;
  nu = hp.omb2 * (g * g) + hp.b2 * nu;
  x = x + (-st.lr) * ((mu / st.bc1) / (sqrtf(nu / st.bc2) + hp.eps));
}

// Adam's step on entry i of a leaf, written unless the step is frozen
__device__ __forceinline__ void adam(float* x, float* mu, float* nu,
                                     int64_t i, float g, float mask,
                                     const Step& st, const Hyper& hp) {
  float x1 = x[i], mu1 = mu[i], nu1 = nu[i];
  adam_values(x1, mu1, nu1, g, mask, st, hp);
  if (!st.stop) {
    x[i] = x1;
    mu[i] = mu1;
    nu[i] = nu1;
  }
}

// stage C: camera c's backward up to the MST chain
__device__ void camera_backward(const float* fstat, const float* grads,
                                const Buf& b, float* work, const Dims& d,
                                int phase, int c) {
  float* wk = work + int64_t(kWork) * c;
  const CamFwd& v = *reinterpret_cast<const CamFwd*>(wk + wFwd);
  const float* st = fstat + kStatics * c;
  const float* gK = grads + 9 * c;
  const float* gC = grads + 9 * int64_t(d.C) + 16 * c;
  const float* gP = grads + 25 * int64_t(d.C) + 12 * c;
  const float* ch = b.chain + 12 * c;
  float dd[3], nt[3];
  for (int a = 0; a < 3; ++a) {
    const float u = (ch[4 * a] * v.to[0] + ch[4 * a + 1] * v.to[1]) +
                    ch[4 * a + 2] * v.to[2];
    dd[a] = ch[4 * a + 3] - u;
    nt[a] = v.gs * dd[a];
  }
  float gK00 = gK[0], gK02 = gK[2], gK11 = gK[4], gK12 = gK[5];
  float gRc[9], gnt[3];
  for (int a = 0; a < 3; ++a) {
    for (int bb = 0; bb < 3; ++bb) gRc[3 * a + bb] = gC[4 * a + bb];
    gnt[a] = gC[4 * a + 3];
  }
  if (phase == 2) {
    const float* W = b.w2c + 16 * c;
    auto dot4 = [&](const float* p, const float* w) {
      return ((p[0] * w[0] + p[1] * w[1]) + p[2] * w[2]) + p[3] * w[3];
    };
    gK00 = gK00 + dot4(gP, W);
    gK02 = gK02 + dot4(gP, W + 8);
    gK11 = gK11 + dot4(gP + 4, W + 4);
    gK12 = gK12 + dot4(gP + 4, W + 8);
    float gW[12];
    for (int j = 0; j < 4; ++j) {
      gW[j] = v.f * gP[j];
      gW[4 + j] = v.f * gP[4 + j];
      gW[8 + j] = (v.ppx * gP[j] + v.ppy * gP[4 + j]) + gP[8 + j];
    }
    float gvv[3];
    for (int i = 0; i < 3; ++i) gvv[i] = -gW[4 * i + 3];
    for (int a = 0; a < 3; ++a) {
      for (int bb = 0; bb < 3; ++bb) {
        gRc[3 * a + bb] = gRc[3 * a + bb] + (gW[4 * bb + a] + gvv[bb] * nt[a]);
      }
    }
    for (int a = 0; a < 3; ++a) {
      gnt[a] = gnt[a] + ((ch[4 * a] * gvv[0] + ch[4 * a + 1] * gvv[1]) +
                         ch[4 * a + 2] * gvv[2]);
    }
  }
  const float ggs =
      ((gnt[0] * dd[0] + gnt[1] * dd[1]) + gnt[2] * dd[2]) + wk[wAGs];
  float gdd[3], gu[3];
  for (int a = 0; a < 3; ++a) {
    gdd[a] = gnt[a] * v.gs;
    gu[a] = -gdd[a];
  }
  for (int a = 0; a < 3; ++a) {
    for (int bb = 0; bb < 3; ++bb) {
      gRc[3 * a + bb] = gRc[3 * a + bb] + gu[a] * v.to[bb];
    }
  }
  float gto[3];
  for (int bb = 0; bb < 3; ++bb) {
    gto[bb] = (ch[bb] * gu[0] + ch[4 + bb] * gu[1]) + ch[8 + bb] * gu[2];
  }
  const float gz =
      ((gto[0] * v.A[0] + gto[1] * v.A[1]) + gto[2]) + wk[wAZ];
  const float gA0 = gto[0] * v.z, gA1 = gto[1] * v.z;
  const float gWF0 = gA0 * v.h[0], gWF1 = gA1 * v.h[1];
  const float gh0 = gA0 * v.WF[0], gh1 = gA1 * v.WF[1];
  const float gzq = gz / st[2];
  float gf = gK00 + gK11;
  gf = gf + (-(gWF0 * (v.WF[0] / v.f)));
  gf = gf + (-(gWF1 * (v.WF[1] / v.f)));
  gf = gf + gzq * v.zq;
  float gsz = (gzq * v.f) * st[3];
  if (!(d.flags & kMul)) gsz = gsz + wk[wAMs] * st[3];
  const float gm1 =
      v.m1 > st[5] ? 0.0f : (v.m1 == st[5] ? gf / 2.0f : gf);
  const float ge =
      v.e < st[4] ? 0.0f : (v.e == st[4] ? gm1 / 2.0f : gm1);
  for (int a = 0; a < 3; ++a) {
    for (int bb = 0; bb < 3; ++bb) {
      wk[wGChain + 4 * a + bb] = gRc[3 * a + bb];
    }
    wk[wGChain + 4 * a + 3] = gdd[a];
  }
  wk[wGGs] = ggs;
  wk[wGLf] = ge * v.e;
  wk[wGPp] = gK02 * st[0] + (-gh0);
  wk[wGPp + 1] = gK12 * st[1] + (-gh1);
  wk[wGSz] = gsz;
}

// stage D, one warp: the chain's backward (an entry a lane, the edges in
// reverse), then lane 0: the sums across cameras
__device__ void chain_backward(const int* istat, const Buf& b,
                               float* work, const Dims& d) {
  const int root = istat[0], E = istat[1], lane = threadIdx.x;
  if (lane < 12) {
    for (int e = E - 1; e >= 0; --e) {
      const int p = istat[2 + e], ch = istat[2 + E + e];
      const float* A = b.chain + 12 * p;
      const float* B = b.rel + 12 * ch;
      const float* gO = work + int64_t(kWork) * ch + wGChain;
      float* gA = work + int64_t(kWork) * p + wGChain;
      float* gr = work + int64_t(kWork) * ch + wGRel;
      const int r = lane / 4, c = lane % 4;
      // the relative pose's gradient A^T gO, and the parent's A += gO B^T
      gr[lane] = (A[r] * gO[c] + A[4 + r] * gO[4 + c]) + A[8 + r] * gO[8 + c];
      const float* g = gO + 4 * r;
      gA[lane] = gA[lane] + (c < 3 ? ((g[0] * B[4 * c] + g[1] * B[4 * c + 1]) +
                                      g[2] * B[4 * c + 2]) +
                                         g[3] * B[4 * c + 3]
                                   : g[3]);
      __syncwarp(0xfffu);
    }
  }
  __syncwarp();
  if (lane != 0) return;
  float* wr = work + int64_t(kWork) * root;
  for (int i = 0; i < 12; ++i) wr[wGRel + i] = wr[wGChain + i];
  // the global scale: 1 / min(sizes), its gradient split evenly among the
  // cameras tied for the smallest size
  float ggs = work[wGGs];
  for (int c = 1; c < d.C; ++c) ggs = ggs + work[int64_t(kWork) * c + wGGs];
  const float gs = work[wGs], mn = work[wMn];
  const float gmn = -ggs * (gs * gs);
  int tied = 0;
  for (int c = 0; c < d.C; ++c) tied += work[int64_t(kWork) * c + wSz] == mn;
  const float share = gmn / static_cast<float>(tied);
  for (int c = 0; c < d.C; ++c) {
    float* wk = work + int64_t(kWork) * c;
    if (wk[wSz] == mn) wk[wGSz] = wk[wGSz] + share;
  }
  if (d.flags & kShared) {
    float s = work[wGLf], s0 = work[wGPp], s1 = work[wGPp + 1];
    for (int c = 1; c < d.C; ++c) {
      const float* wk = work + int64_t(kWork) * c;
      s = s + wk[wGLf];
      s0 = s0 + wk[wGPp];
      s1 = s1 + wk[wGPp + 1];
    }
    s = s / static_cast<float>(d.C);
    s0 = s0 / static_cast<float>(d.C);
    s1 = s1 / static_cast<float>(d.C);
    for (int c = 0; c < d.C; ++c) {
      float* wk = work + int64_t(kWork) * c;
      wk[wGLf] = s;
      wk[wGPp] = s0;
      wk[wGPp + 1] = s1;
    }
  }
}

// stage E: camera c's leaves, their gradients and Adam's step
__device__ void camera_leaves(const State& sv, const float* fstat,
                              const float* work, const Dims& d, int phase,
                              int c, const Step& step, const Hyper& hp) {
  const float* wk = work + int64_t(kWork) * c;
  const CamFwd& v = *reinterpret_cast<const CamFwd*>(wk + wFwd);
  const float free = fstat[kStatics * c + 6];
  const float* gr = wk + wGRel;
  // the rotation's gradient to the quaternion leaf's
  float dR[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) dR[3 * i + j] = 2.0f * gr[4 * i + j];
  }
  const float w = v.q2[0], x = v.q2[1], y = v.q2[2], z = v.q2[3];
  const float gxx = -(dR[4] + dR[8]);
  const float gyy = -(dR[0] + dR[8]);
  const float gzz = -(dR[0] + dR[4]);
  const float gxy = dR[1] + dR[3], gwz = dR[3] - dR[1];
  const float gxz = dR[2] + dR[6], gwy = dR[2] - dR[6];
  const float gyz = dR[5] + dR[7], gwx = dR[7] - dR[5];
  float g[4];
  g[0] = (gwx * x + gwy * y) + gwz * z;
  g[1] = (((gxx * x) * 2.0f + gwx * w) + gxy * y) + gxz * z;
  g[2] = (((gyy * y) * 2.0f + gwy * w) + gxy * x) + gyz * z;
  g[3] = (((gzz * z) * 2.0f + gwz * w) + gxz * x) + gyz * y;
  // through q_out = q_in * n, n = rsqrt(sum(q_in^2) + eps): the second
  // normalisation, then the first
  auto normalised_bwd = [&](const float (&qin)[4], float n) {
    const float dot =
        ((g[0] * qin[0] + g[1] * qin[1]) + g[2] * qin[2]) + g[3] * qin[3];
    const float gS = dot * (((n * n) * n) * -0.5f);
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = g[i] * n + (qin[i] * gS) * 2.0f;
  };
  normalised_bwd(v.q1, v.n2);
  normalised_bwd(v.q0, v.n1);
  const float m_pp =
      phase == 1 ? 0.0f : free * ((d.flags & kOptPP) ? 1.0f : 0.0f);
  const float m_lf = phase == 1 ? 0.0f : free;
  // the camera's 11 entries (pps 2, log_focal, quat 4, trans 3,
  // log_size): loaded together so their latencies overlap, stepped, then
  // written
  constexpr int kLeaf[11] = {0, 0, 1, 2, 2, 2, 2, 3, 3, 3, 4};
  constexpr int kWidth[5] = {2, 1, 4, 3, 1};
  constexpr int kCol[11] = {0, 1, 0, 0, 1, 2, 3, 0, 1, 2, 0};
  const float gl[11] = {wk[wGPp], wk[wGPp + 1], wk[wGLf], g[0], g[1], g[2],
                        g[3], gr[3], gr[7], gr[11], wk[wGSz] * v.sz};
  const float ml[11] = {m_pp, m_pp, m_lf, free, free, free, free,
                        free, free, free, free};
  float xv[11], mv[11], nv[11];
#pragma unroll
  for (int i = 0; i < 11; ++i) {
    const int64_t at = int64_t(kWidth[kLeaf[i]]) * c + kCol[i];
    xv[i] = sv.p[kLeaf[i]][at];
    mv[i] = sv.mu[kLeaf[i]][at];
    nv[i] = sv.nu[kLeaf[i]][at];
  }
#pragma unroll
  for (int i = 0; i < 11; ++i) {
    adam_values(xv[i], mv[i], nv[i], gl[i], ml[i], step, hp);
  }
  const float nq = rsqrtf(
      (((xv[3] * xv[3] + xv[4] * xv[4]) + xv[5] * xv[5]) + xv[6] * xv[6]) +
      kQEps);
#pragma unroll
  for (int i = 3; i < 7; ++i) xv[i] = xv[i] * nq;
  if (!step.stop) {
#pragma unroll
    for (int i = 0; i < 11; ++i) {
      const int64_t at = int64_t(kWidth[kLeaf[i]]) * c + kCol[i];
      sv.p[kLeaf[i]][at] = xv[i];
      sv.mu[kLeaf[i]][at] = mv[i];
      sv.nu[kLeaf[i]][at] = nv[i];
    }
  }
}

// stage A's points of one camera, kBatch a thread (s = base + u T, T the
// cluster's threads):
// their values, loaded ahead of the batch before so the latencies overlap
struct Batch {
  float gd[kBatch], core[kBatch], x[kBatch], mu[kBatch], nu[kBatch];
};

__device__ __forceinline__ void load_batch(Batch& bt, const State& sv,
                                           const float* gD, const Buf& b,
                                           const Dims& d, int64_t row,
                                           int base) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int s = base + u * kSumThreads;
    if (s < d.S) {
      bt.gd[u] = gD[row + s];
      bt.core[u] = b.core[row + s];
      if (!d.k) {
        bt.x[u] = sv.p[5][row + s];
        bt.mu[u] = sv.mu[5][row + s];
        bt.nu[u] = sv.nu[5][row + s];
      }
    }
  }
}

// stage A on one batch: the depth's terms added to acc in turn, each
// point's gradient to the core values (lora) or its Adam step
__device__ __forceinline__ void run_batch(Batch& bt, const State& sv,
                                          const Buf& b, const Dims& d,
                                          int64_t row, int base,
                                          const float* wk, float m_cd,
                                          const Step& step, const Hyper& hp,
                                          float (&acc)[3]) {
  const bool mul = d.flags & kMul;
  const float z = wk[wZ], ms = wk[wMs], gs = wk[wGs];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int s = base + u * kSumThreads;
    if (s >= d.S) break;
    const float d0 = depth0(bt.core[u], z, ms, d.flags);
    const float gd0 = bt.gd[u] * gs;
    acc[0] += bt.gd[u] * d0;
    acc[1] += mul ? gd0 * bt.core[u] : gd0;
    if (!mul) acc[2] += gd0 * (bt.core[u] - 1.0f);
    const float gcore = gd0 * (mul ? z : ms);
    if (d.k) {
      b.gcore[row + s] = gcore;
    } else {
      adam_values(bt.x[u], bt.mu[u], bt.nu[u],
                  (d.flags & kExpDepth) ? gcore * bt.core[u] : gcore, m_cd,
                  step, hp);
      if (!step.stop) {
        sv.p[5][row + s] = bt.x[u];
        sv.mu[5][row + s] = bt.mu[u];
        sv.nu[5][row + s] = bt.nu[u];
      }
    }
  }
}

// One cluster of kRanks blocks. Every rank computes the cameras' forward
// values and runs stages A and B on its share of the core points; after
// the cluster's barrier, rank 0 adds the ranks' partial sums in order and
// runs stages C, D and E alone.
__global__ void __launch_bounds__(kUpdateThreads)
    ga_update_kernel(State sv, const float* loss, const float* grads,
                     const float* fstat, const int* istat, float* buf,
                     Dims d, int phase, Hyper hp) {
  extern __shared__ float sm[];  // the per-camera work slots, if they fit
  const int rank = cluster_rank();
  const Buf b = buf_layout(buf, d);
  float* work = kWork * d.C <= kSmemFloats ? sm : b.work;
  Leaves lv;
  for (int i = 0; i < 6; ++i) lv.p[i] = sv.p[i];
  const long long count = *sv.count;
  const float lossv = *loss;
  Step step;
  const float frac = static_cast<float>(count) /
                     static_cast<float>(d.niter > 1 ? d.niter : 1);
  step.lr = hp.lr_end + (hp.dlr * (1.0f + cosf(hp.pi * frac))) / 2.0f;
  const float n = static_cast<float>(count + 1);
  step.bc1 = 1.0f - powf(hp.b1, n);
  step.bc2 = 1.0f - powf(hp.b2, n);
  step.stop = *sv.stopped || !isfinite(lossv);
  const float* gD = grads + (phase == 2 ? 37 : 25) * int64_t(d.C);
  const int lane = threadIdx.x & 31;
  const int gt = rank * kUpdateThreads + threadIdx.x;  // in the cluster
  const int gwarp = gt >> 5;

  // (0) each camera's forward values (past kSmemFloats the work slots are
  // the step buffer's, written alike by every rank)
  for (int c = threadIdx.x; c < d.C; c += blockDim.x) {
    CamFwd v;
    camera_forward(lv, fstat, d, c, v);
    float* wk = work + int64_t(kWork) * c;
    wk[wZ] = v.z;
    wk[wMs] = v.ms;
    wk[wGs] = v.gs;
    wk[wSz] = v.sz;
    wk[wMn] = v.mn;
    *reinterpret_cast<CamFwd*>(wk + wFwd) = v;
  }
  __syncthreads();

  // (A) the depth's terms summed over each camera's points (each thread of
  // the cluster its points s = t, t + T, ... in turn, kBatch at a time, the
  // next batch loaded before this one runs; each warp's tree to the step
  // buffer, the warps added in order below); each point's Adam step
  // (without the lora basis)
  {
    const int per_cam = (d.S + kBatch * kSumThreads - 1) /
                        (kBatch * kSumThreads);
    const int nq = d.C * per_cam;
    float acc[3] = {0.0f, 0.0f, 0.0f};
    auto place = [&](int q, int& c, int64_t& row, int& base) {
      c = q / per_cam;
      row = int64_t(c) * d.S;
      base = gt + (q % per_cam) * kBatch * kSumThreads;
    };
    auto finish = [&](int q) {  // after chunk q: its camera's sums if last
      if (q % per_cam != per_cam - 1) return;
      float* part = b.wpart + (int64_t(q / per_cam) * kSumWarps + gwarp) * 3;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float v = acc[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_down_sync(0xffffffffu, v, off);
        }
        if (lane == 0) part[i] = v;
        acc[i] = 0.0f;
      }
    };
    auto m_cd = [&](int c) {
      return phase == 2 ? fstat[kStatics * c + 6] *
                              ((d.flags & kOptDepth) ? 1.0f : 0.0f)
                        : 0.0f;
    };
    Batch ba, bb;
    int c, base;
    int64_t row;
    place(0, c, row, base);
    load_batch(ba, sv, gD, b, d, row, base);
    for (int q = 0; q < nq; q += 2) {
      int c1 = 0, base1 = 0;
      int64_t row1 = 0;
      if (q + 1 < nq) {
        place(q + 1, c1, row1, base1);
        load_batch(bb, sv, gD, b, d, row1, base1);
      }
      place(q, c, row, base);
      run_batch(ba, sv, b, d, row, base, work + int64_t(kWork) * c,
                m_cd(c), step, hp, acc);
      finish(q);
      if (q + 1 < nq) {
        if (q + 2 < nq) {
          place(q + 2, c, row, base);
          load_batch(ba, sv, gD, b, d, row, base);
        }
        run_batch(bb, sv, b, d, row1, base1, work + int64_t(kWork) * c1,
                  m_cd(c1), step, hp, acc);
        finish(q + 1);
      }
    }
  }

  // (B) the lora coefficients' gradients: G = max(T / k, 1) groups of the
  // cluster's threads, group g adding basis * gradient over s = g, g + G,
  // ... in turn, for each camera
  const int G = d.k ? (kSumThreads / d.k > 1 ? kSumThreads / d.k : 1) : 1;
  if (d.k) {
    cluster_sync();  // every rank's gradient of the core values is written
    const int64_t tasks = int64_t(d.C) * G * d.k;
    for (int64_t task = gt; task < tasks; task += kSumThreads) {
      const int c = static_cast<int>(task / (int64_t(G) * d.k));
      const int rem = static_cast<int>(task % (int64_t(G) * d.k));
      const int kk = rem % d.k, g = rem / d.k;
      const float* basis = fstat + int64_t(kStatics) * d.C +
                           int64_t(c) * d.S * d.k;
      const float* gc = b.gcore + int64_t(c) * d.S;
      float acc = 0.0f;
      for (int s = g; s < d.S; s += G) {
        acc += basis[int64_t(s) * d.k + kk] * gc[s];
      }
      b.lpart[task] = acc;
    }
  }
  cluster_sync();  // every rank's partial sums are written
  if (rank != 0) return;

  for (int i = threadIdx.x; i < 3 * d.C; i += blockDim.x) {
    const float* part = b.wpart + int64_t(i / 3) * kSumWarps * 3 + i % 3;
    float s = part[0];
    for (int w = 1; w < kSumWarps; ++w) s = s + part[3 * w];
    work[int64_t(kWork) * (i / 3) + wAGs + i % 3] = s;
  }
  for (int64_t i = threadIdx.x; i < int64_t(d.C) * d.k; i += blockDim.x) {
    const float* part = b.lpart + (i / d.k) * G * d.k + i % d.k;
    float s = part[0];
    for (int g = 1; g < G; ++g) s = s + part[int64_t(g) * d.k];
    b.gcc[i] = s;
  }
  __syncthreads();

  // (C) each camera's backward up to the chain
  for (int c = threadIdx.x; c < d.C; c += blockDim.x) {
    camera_backward(fstat, grads, b, work, d, phase, c);
  }
  __syncthreads();
  // (D) the chain's backward and the sums across cameras
  if (threadIdx.x < 32) chain_backward(istat, b, work, d);
  __syncthreads();
  // (E) each camera's leaves; the lora coefficients
  for (int c = threadIdx.x; c < d.C; c += blockDim.x) {
    camera_leaves(sv, fstat, work, d, phase, c, step, hp);
  }
  for (int64_t i = threadIdx.x; i < int64_t(d.C) * d.k; i += blockDim.x) {
    const int c = static_cast<int>(i / d.k);
    const float m_cd = phase == 2 ? fstat[kStatics * c + 6] *
                                        ((d.flags & kOptDepth) ? 1.0f : 0.0f)
                                  : 0.0f;
    float g = b.gcc[i];
    if (d.flags & kExpDepth) g = g * expf(sv.p[5][i]);
    adam(sv.p[5], sv.mu[5], sv.nu[5], i, g, m_cd, step, hp);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (!step.stop) *sv.last_loss = lossv;
    *sv.stopped = step.stop;
    *sv.count = count + 1;
  }
}

bool dims_ok(int C, int S, int k, int niter) {
  return C >= 1 && S >= 1 && k >= 0 && niter >= 0 &&
         int64_t(C) * ((S + kThreads - 1) / kThreads) + 1 < 0x7fffffff &&
         k <= kSmemFloats;
}

}  // namespace

// Launches ga_reparam on `stream` (PyTorch's current stream): `leaves` is a
// host array of the six parameter leaves' device pointers (ga.GAParams'
// order), `count` the step counter (int64), fstat / istat the phase's
// statics and edges and `buf` the step buffer, as alignment/ga_step.py lays
// them out for (C, S, k). Returns the CUDA error code,
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ga_reparam(const void* const* leaves, const long long* count,
                          const float* fstat, const int* istat, float* buf,
                          int C, int S, int k, int flags, int niter,
                          void* stream) {
  if (!dims_ok(C, S, k, niter)) return static_cast<int>(cudaErrorInvalidValue);
  Leaves lv;
  for (int i = 0; i < 6; ++i) {
    lv.p[i] = static_cast<float*>(const_cast<void*>(leaves[i]));
  }
  const Dims d{C, S, k, flags, niter};
  const int nj = (S + kThreads - 1) / kThreads;
  const int poses = 24 * C <= kSmemFloats ? 24 * C : 0;
  const size_t smem = (k > poses ? k : poses) * sizeof(float);
  ga_reparam_kernel<<<C * nj + 1, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      lv, count, fstat, istat, buf, d, nj);
  return static_cast<int>(cudaGetLastError());
}

// Launches ga_update on `stream`: `state` is a host array of 21 device
// pointers (the six params, mu and nu leaves, the count (int64), the stop
// flag (bool), the last loss), `loss` and `grads` the fused loss's
// outputs (grads laid out as alignment/ga_loss.py::_grad_layout); the
// hyperparameters are float32 values (lr_end, lr_base - lr_end, b1, 1 - b1,
// b2, 1 - b2, Adam's eps, pi). Returns the CUDA error code.
extern "C" int ga_update(const void* const* state, const float* loss,
                         const float* grads, const float* fstat,
                         const int* istat, float* buf, int C, int S, int k,
                         int flags, int phase, int niter, float lr_end,
                         float dlr, float b1, float omb1, float b2,
                         float omb2, float eps, float pi, void* stream) {
  if (!dims_ok(C, S, k, niter) || (phase != 1 && phase != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  State sv;
  for (int i = 0; i < 6; ++i) {
    sv.p[i] = static_cast<float*>(const_cast<void*>(state[i]));
    sv.mu[i] = static_cast<float*>(const_cast<void*>(state[6 + i]));
    sv.nu[i] = static_cast<float*>(const_cast<void*>(state[12 + i]));
  }
  sv.count = static_cast<long long*>(const_cast<void*>(state[18]));
  sv.stopped = static_cast<bool*>(const_cast<void*>(state[19]));
  sv.last_loss = static_cast<float*>(const_cast<void*>(state[20]));
  const Dims d{C, S, k, flags, niter};
  const Hyper hp{lr_end, dlr, b1, omb1, b2, omb2, eps, pi};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRanks);
  cfg.blockDim = dim3(kUpdateThreads);
  cfg.dynamicSmemBytes =
      (kWork * C <= kSmemFloats ? kWork * C : 0) * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, ga_update_kernel, sv,
                                             loss, grads, fstat, istat, buf,
                                             d, phase, hp));
}
