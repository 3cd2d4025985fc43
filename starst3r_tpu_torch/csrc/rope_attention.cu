// MASt3R's attention with its 2D RoPE applied as Q and K load, for Hopper
// (sm_90a):
//   O = softmax((rope(Q, cos_q, sin_q) . rope(K, cos_k, sin_k)^T) D^-1/2) V
// q (B, Tq, H, D), k and v (B, Tk, H, D), each with its own batch, token and
// head strides and a unit last stride (the `qkv` linear's (B, T, 3, H, D)
// views, or the projections' (B, T, H, D)); the rotary tables (Tq, D) and
// (Tk, D) float32; O (B, Tq, H, D) contiguous.
//
// Replaces no Pallas kernel: the JAX package leaves attention to XLA
// (`jax.nn.dot_product_attention` after `ops/rope.py::apply_rope_2d`). On
// the card the port's composition of the two (`ops/rope.py::apply_rope_2d`,
// then `ops/attention.py::sdpa`) writes the rotated q and k in float32 and
// bfloat16, and the (B, H, Tq, Tk) scores five times over; this kernel
// keeps all of them on the chip.
//
// The rotation is `apply_rope_2d`'s, operation for operation: within each
// half of the head, channel j of the first quarter pairs with j + D/4,
//   out[j]       = x[j] cos[j] + (-x[j + D/4]) sin[j]
//   out[j + D/4] = x[j + D/4] cos[j + D/4] + x[j] sin[j + D/4]
// each product and the sum rounded to float32 on its own (no FMA), then
// rounded to the input's type: the rotated q and k equal the plain
// version's bit for bit.
//
// Bound on this card: operations. At 512 x 384 an encoder call is
// 16 images x 16 heads x 768^2 x 64 x 4 = 38.7 GFLOP (0.039 ms at 989
// TFLOP/s) against 101 MB of q, k, v and o (0.030 ms at 3.35 TB/s).
//
// Design (bfloat16, D = 64): FA2-shaped. A block of 8 warps takes 128 query
// rows of one (batch, head), a warp 16 rows on mma.sync m16n8k16 (bfloat16
// operands, float32 sums). K and V stream in tiles of 64 keys, double
// buffered in shared memory by cp.async (one tile loads while the other is
// used), and each K tile's rows of the cos and sin tables load with it
// (they are (T, D) and shared by every batch and head, so they come from
// L2); once a tile lands the whole block rotates it in place. Q is rotated
// the same way once, its tables read straight from device memory, and held
// in registers. The rotation reads the tables in float32: they are 4 of
// the 6 bytes a key brings per channel, which is what a block pays for
// rotating each key tile itself; 128 query rows a block share that cost
// (64 rows a block ran 23% slower at 768 tokens, and two blocks an SM
// hold 128 registers a thread). The softmax is online
// in float32 with the scale and log2 e folded into one exp2f argument; P is
// rounded to bfloat16 only as the PV product's operand, O is divided by
// the row sum in float32 and stored in bfloat16. Keys past Tk are zero in
// shared memory and -inf in the scores; rows past Tq are not stored.
// Shared tiles are XOR-swizzled by 16-byte chunk so ldmatrix reads no bank
// twice.
//
// float32 (D = 24, 32: the `tiny` preset; 64: a bfloat16 preset's network
// run in float32, as a yardstick of its rounding): no tensor cores. A
// thread owns one query row (rotated in registers), the block's 64 rows
// share each key tile in shared memory (rotated as it is stored); the
// softmax is the same online float32 update, per tile of 32 keys, each
// thread's scores in its column of shared memory. Its loops over keys are
// not unrolled, which keeps its build short.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kD = 64;              // the bfloat16 route's head size
constexpr int kBM = 128;            // query rows a block
constexpr int kBN = 64;             // keys a tile
constexpr int kThreads = kBM * 2;   // 8 warps of 16 query rows
constexpr int kChunks = kD / 8;     // 16-byte chunks a row

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* cos_q;  // nullptr: no rotation
  const float* sin_q;
  const float* cos_k;
  const float* sin_k;
  void* o;
  int heads, tq, tk;
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
  float scale_log2;  // D^-1/2 log2(e)
};

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bfloat16; d float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// `apply_rope_2d`'s pair, each product and the sum rounded on its own
__device__ __forceinline__ void rotate_pair(float x, float y, float c_lo,
                                            float s_lo, float c_hi,
                                            float s_hi, float& lo,
                                            float& hi) {
  lo = __fadd_rn(__fmul_rn(x, c_lo), __fmul_rn(-y, s_lo));
  hi = __fadd_rn(__fmul_rn(y, c_hi), __fmul_rn(x, s_hi));
}

// element offset of (row, 16-byte chunk) in a swizzled 64 x 64 tile
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kD + ((chunk ^ (row & 7)) << 3);
}

// ------------------------------------------------------- bfloat16, D = 64

// rows [row0, row0 + kRows) of a (T, D) view at `base` (row stride
// `stride`) into a swizzled tile; rows past `rows` are zero
template <int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          long long stride, int row0,
                                          int rows, int tid) {
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < rows;
    const __nv_bfloat16* src =
        base + (ok ? static_cast<long long>(row0 + r) * stride : 0) + c * 8;
    cp_async16(tile + swz(r, c), src, ok);
  }
}

// a staged table tile: 64 rows of 16 float4 units, unit u of row r at
// u ^ (bit 3 of u, moved to bit 2) ^ (r & 1), so that the 8 threads of a
// quarter warp in `rotate_tile` (2 rows x 4 pair-chunks) read 8 banks
__device__ __forceinline__ int table_unit(int r, int u) {
  return r * (kD / 4) + (u ^ (((u >> 3) & 1) << 2) ^ (r & 1));
}

// rows [row0, row0 + 64) of a (T, D) float32 table into a staged tile
__device__ __forceinline__ void load_table(float* tab, const float* base,
                                           int row0, int rows, int tid) {
#pragma unroll
  for (int it = 0; it < kBN * (kD / 4) / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i / (kD / 4), u = i % (kD / 4);
    const bool ok = row0 + r < rows;
    const float* src =
        base + (ok ? static_cast<long long>(row0 + r) * kD : 0) + u * 4;
    cp_async16(tab + table_unit(r, u) * 4, src, ok);
  }
}

// rotate a landed tile in place: a thread takes 8 channel pairs of one row
// (j0 .. j0 + 7 with j0 + 16 ..), j0 in {0, 8, 32, 40}. The tables are the
// (T, D) ones in device memory (kStaged false: Q, once a block) or this
// tile's rows staged by `load_table` (the K tiles)
template <bool kStaged, int kRows>
__device__ __forceinline__ void rotate_tile(__nv_bfloat16* tile,
                                            const float* __restrict__ cs,
                                            const float* __restrict__ sn,
                                            int row0, int rows, int tid) {
#pragma unroll
  for (int it = 0; it < kRows * 4 / kThreads; ++it) {
    const int i = tid + it * kThreads, r = i >> 2, c = i & 3;
    if (row0 + r >= rows) continue;
    const int lo = (c >> 1) * 4 + (c & 1), hi = lo + 2;  // chunks
    uint4* plo = reinterpret_cast<uint4*>(tile + swz(r, lo));
    uint4* phi = reinterpret_cast<uint4*>(tile + swz(r, hi));
    const uint4 xlo = *plo, xhi = *phi;
    float cl[8], sl[8], ch[8], sh[8];
    const int units[4] = {2 * lo, 2 * lo + 1, 2 * hi, 2 * hi + 1};
    float* dst_c[4] = {cl, cl + 4, ch, ch + 4};
    float* dst_s[4] = {sl, sl + 4, sh, sh + 4};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float4 vc, vs;
      if (kStaged) {
        vc = reinterpret_cast<const float4*>(cs)[table_unit(r, units[k])];
        vs = reinterpret_cast<const float4*>(sn)[table_unit(r, units[k])];
      } else {
        const long long t = static_cast<long long>(row0 + r) * (kD / 4);
        vc = __ldg(reinterpret_cast<const float4*>(cs) + t + units[k]);
        vs = __ldg(reinterpret_cast<const float4*>(sn) + t + units[k]);
      }
      *reinterpret_cast<float4*>(dst_c[k]) = vc;
      *reinterpret_cast<float4*>(dst_s[k]) = vs;
    }
    const unsigned wl[4] = {xlo.x, xlo.y, xlo.z, xlo.w};
    const unsigned wh[4] = {xhi.x, xhi.y, xhi.z, xhi.w};
    unsigned ol[4], oh[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a0, a1, b0, b1;
      rotate_pair(bf16_lo(wl[e]), bf16_lo(wh[e]), cl[2 * e], sl[2 * e],
                  ch[2 * e], sh[2 * e], a0, b0);
      rotate_pair(bf16_hi(wl[e]), bf16_hi(wh[e]), cl[2 * e + 1],
                  sl[2 * e + 1], ch[2 * e + 1], sh[2 * e + 1], a1, b1);
      ol[e] = pack_bf16(a0, a1);
      oh[e] = pack_bf16(b0, b1);
    }
    *plo = make_uint4(ol[0], ol[1], ol[2], ol[3]);
    *phi = make_uint4(oh[0], oh[1], oh[2], oh[3]);
  }
}

// dynamic shared memory of a block: Q, two K and two V tiles (bfloat16),
// one staged cos and one sin tile (float32)
constexpr int kTile = kBN * kD;
constexpr int kSmemBytes = (kBM * kD + 4 * kTile) * 2 + 2 * kTile * 4;

__global__ void __launch_bounds__(kThreads, 2)
    rope_attention_bf16_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + kBM * kD;   // two tiles
  __nv_bfloat16* sv = sk + 2 * kTile;  // two tiles
  float* tc = reinterpret_cast<float*>(sv + 2 * kTile);
  float* ts = tc + kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * kBM;
  const auto* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.qb +
                   h * p.qh;
  const auto* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.kb +
                   h * p.kh;
  const auto* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.vb +
                   h * p.vh;
  const bool rope = p.cos_q != nullptr;
  const int tiles = (p.tk + kBN - 1) / kBN;

  load_tile<kBM>(sq, qg, p.qt, q0, p.tq, tid);
  load_tile<kBN>(sk, kg, p.kt, 0, p.tk, tid);
  load_tile<kBN>(sv, vg, p.vt, 0, p.tk, tid);
  if (rope) {
    load_table(tc, p.cos_k, 0, p.tk, tid);
    load_table(ts, p.sin_k, 0, p.tk, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (rope) {
    rotate_tile<false, kBM>(sq, p.cos_q, p.sin_q, q0, p.tq, tid);
    rotate_tile<true, kBN>(sk, tc, ts, 0, p.tk, tid);
  }
  __syncthreads();

  // this warp's 16 rows of Q as mma A operands, one per 16 channels
  unsigned qa[4][4];
  {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      ldmatrix_x4(qa[kc], sq + swz(r, kc * 2 + (lane >> 4)));
  }

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // rows g, g + 8 (scaled, log2)
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the sums

  for (int j = 0; j < tiles; ++j) {
    const int cur = j & 1;
    __nv_bfloat16* knext = sk + (cur ^ 1) * kTile;
    if (j + 1 < tiles) {  // the next tile loads while this one is used
      load_tile<kBN>(knext, kg, p.kt, (j + 1) * kBN, p.tk, tid);
      load_tile<kBN>(sv + (cur ^ 1) * kTile, vg, p.vt, (j + 1) * kBN, p.tk,
                     tid);
      if (rope) {
        load_table(tc, p.cos_k, (j + 1) * kBN, p.tk, tid);
        load_table(ts, p.sin_k, (j + 1) * kBN, p.tk, tid);
      }
      cp_async_commit();
    }
    const __nv_bfloat16* ktile = sk + cur * kTile;
    const __nv_bfloat16* vtile = sv + cur * kTile;

    // S = Q K^T: 16 rows x 64 keys a warp, key block n of 8 in s[n]
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kf[4];
        const int mi = lane >> 3;
        ldmatrix_x4(kf, ktile + swz(np * 16 + (mi >> 1) * 8 + (lane & 7),
                                    kc * 2 + (mi & 1)));
        mma_bf16(s[2 * np], qa[kc], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa[kc], kf[2], kf[3]);
      }
    }
    if ((j + 1) * kBN > p.tk) {  // the ragged last tile
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * kBN + n * 8 + tig * 2 + (e & 1) >= p.tk) s[n][e] = -INFINITY;
    }

    // the online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      x0 = fmaxf(x0, fmaxf(s[n][0], s[n][1]));
      x1 = fmaxf(x1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, w));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, w));
    }
    const float n0 = fmaxf(m0, x0 * p.scale_log2);
    const float n1 = fmaxf(m1, x1 * p.scale_log2);
    const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
    unsigned pa[4][4];  // P as the PV product's A operand, 16 keys each
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(fmaf(s[n][0], p.scale_log2, -n0));
      const float p1 = exp2f(fmaf(s[n][1], p.scale_log2, -n0));
      const float p2 = exp2f(fmaf(s[n][2], p.scale_log2, -n1));
      const float p3 = exp2f(fmaf(s[n][3], p.scale_log2, -n1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: V's 16 keys x 8 channels through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        unsigned vf[4];
        const int mi = lane >> 3;
        ldmatrix_x4_trans(vf,
                          vtile + swz(kk * 16 + (mi & 1) * 8 + (lane & 7),
                                      dp * 2 + (mi >> 1)));
        mma_bf16(o[2 * dp], pa[kk], vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa[kk], vf[2], vf[3]);
      }
    }

    if (j + 1 < tiles) {
      cp_async_wait_all();
      __syncthreads();  // the next tile landed; this one is read
      if (rope)
        rotate_tile<true, kBN>(knext, tc, ts, (j + 1) * kBN, p.tk, tid);
      __syncthreads();
    }
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  auto* og = static_cast<__nv_bfloat16*>(p.o);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (r0 < p.tq)
      *reinterpret_cast<unsigned*>(
          og + ((static_cast<long long>(b) * p.tq + r0) * p.heads + h) * kD +
          col) = pack_bf16(o[n][0] / l0, o[n][1] / l0);
    if (r1 < p.tq)
      *reinterpret_cast<unsigned*>(
          og + ((static_cast<long long>(b) * p.tq + r1) * p.heads + h) * kD +
          col) = pack_bf16(o[n][2] / l1, o[n][3] / l1);
  }
}

// ------------------------------------------------ float32, D = 24, 32, 64

constexpr int kRows32 = 64;  // query rows (threads) a block
constexpr int kKeys32 = 32;  // keys a tile

template <int D>
__global__ void __launch_bounds__(kRows32)
    rope_attention_f32_kernel(const Params p) {
  constexpr int Q4 = D / 4;
  __shared__ float sk[kKeys32][D];
  __shared__ float sv[kKeys32][D];
  __shared__ float ss[kKeys32][kRows32];  // a thread's scores: its column
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int row = blockIdx.x * kRows32 + tid;
  const bool live = row < p.tq;
  const float* qg = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* kg = static_cast<const float*>(p.k) + b * p.kb + h * p.kh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vb + h * p.vh;
  const bool rope = p.cos_q != nullptr;

  float q[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    q[d] = live ? qg[static_cast<long long>(row) * p.qt + d] : 0.f;
  if (rope && live) {
    const float* cs = p.cos_q + static_cast<long long>(row) * D;
    const float* sn = p.sin_q + static_cast<long long>(row) * D;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const int j = (i / Q4) * 2 * Q4 + i % Q4;
      rotate_pair(q[j], q[j + Q4], cs[j], sn[j], cs[j + Q4], sn[j + Q4],
                  q[j], q[j + Q4]);
    }
  }

  float o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < p.tk; k0 += kKeys32) {
    const int n_keys = min(kKeys32, p.tk - k0);
    __syncthreads();  // the previous tile is read
    for (int i = tid; i < n_keys * (D / 2); i += kRows32) {
      const int r = i / (D / 2), c = i % (D / 2);
      const int j = (c / Q4) * 2 * Q4 + c % Q4;
      const long long t = k0 + r;
      float x = kg[t * p.kt + j], y = kg[t * p.kt + j + Q4];
      if (rope) {
        const float* cs = p.cos_k + t * D;
        const float* sn = p.sin_k + t * D;
        rotate_pair(x, y, cs[j], sn[j], cs[j + Q4], sn[j + Q4], x, y);
      }
      sk[r][j] = x;
      sk[r][j + Q4] = y;
      sv[r][j] = vg[t * p.vt + j];
      sv[r][j + Q4] = vg[t * p.vt + j + Q4];
    }
    __syncthreads();
    float x = -INFINITY;
    for (int n = 0; n < n_keys; ++n) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc = fmaf(q[d], sk[n][d], acc);
      ss[n][tid] = acc;
      x = fmaxf(x, acc);
    }
    const float mn = fmaxf(m, x * p.scale_log2);
    const float c = exp2f(m - mn);
    m = mn;
    l *= c;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] *= c;
    for (int n = 0; n < n_keys; ++n) {
      const float pn = exp2f(fmaf(ss[n][tid], p.scale_log2, -mn));
      l += pn;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = fmaf(pn, sv[n][d], o[d]);
    }
  }
  if (!live) return;
  float* og = static_cast<float*>(p.o) +
              ((static_cast<long long>(b) * p.tq + row) * p.heads + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) og[d] = o[d] / l;
}

}  // namespace

// dtype 0: bfloat16 (D = 64), 1: float32 (D = 24, 32 or 64). Table pointers
// null: no rotation. Launches on `stream` (PyTorch's current stream);
// returns cudaGetLastError(), or cudaErrorInvalidValue for a (dtype, D) it
// has no instantiation of.
extern "C" int rope_attention(const void* q, const void* k, const void* v,
                              const float* cos_q, const float* sin_q,
                              const float* cos_k, const float* sin_k,
                              void* o, int dtype, int batch, int heads,
                              int tq, int tk, int d, long long qb,
                              long long qt, long long qh, long long kb,
                              long long kt, long long kh, long long vb,
                              long long vt, long long vh, float scale_log2,
                              void* stream) {
  const Params p{q,  k,     v,     cos_q, sin_q, cos_k, sin_k, o,  heads,
                 tq, tk,    qb,    qt,    qh,    kb,    kt,    kh, vb,
                 vt, vh,    scale_log2};
  auto s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0 || tq == 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0 && d == kD) {
    const dim3 grid((tq + kBM - 1) / kBM, batch * heads);
    cudaFuncSetAttribute(rope_attention_bf16_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    rope_attention_bf16_kernel<<<grid, kThreads, kSmemBytes, s>>>(p);
  } else if (dtype == 1 && (d == 24 || d == 32 || d == 64)) {
    const dim3 grid((tq + kRows32 - 1) / kRows32, batch * heads);
    if (d == 24)
      rope_attention_f32_kernel<24><<<grid, kRows32, 0, s>>>(p);
    else if (d == 32)
      rope_attention_f32_kernel<32><<<grid, kRows32, 0, s>>>(p);
    else
      rope_attention_f32_kernel<64><<<grid, kRows32, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
