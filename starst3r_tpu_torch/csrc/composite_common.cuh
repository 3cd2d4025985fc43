// What the forward (composite_fwd.cu) and backward (composite_bwd.cu)
// compositing kernels must compute identically: the constants, and one
// entry's Gaussian falloff and cull at one pixel.
//
// The culls (sigma < 0, alpha <= 1/255) are jumps: a near-degenerate conic
// puts sigma within rounding of 0, where one rounding decides between an
// opaque splat and none. So sigma is rounded operation by operation in the
// order of the plain PyTorch version (splat/composite.py), with no FMA
// contraction, and both kernels call this one function: the backward culls
// exactly the entries the forward culled.

#pragma once

namespace composite {

constexpr int kAttr = 9;          // mx, my, conic a, b, c, r, g, b, opacity
constexpr int kBatch = 128;       // entries per batch (the TPU kernel's chunk)
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

}  // namespace composite
