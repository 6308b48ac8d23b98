// FlashAttention-2 backward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see ../_build.py and ../ops.py).
//
// Replaces the blockwise backward of the JAX package's custom VJP,
// repro/models/flash.py:134-223 (_flash_bwd; plain JAX, no Pallas kernel)
//   -> flash_attention_bwd_launch.
// For batch b, head h (q, k and v share H: the caller repeats the kv heads
// for GQA), query row i and key j, from the forward's residuals q, k, v,
// out, lse and the output's cotangent dout:
//   s[i, j]  = scale * (q[i] . k[j])               (float32)
//   s_c      = tanh(s / cap) * cap, dt = 1 - tanh^2 (when cap > 0; else
//              s_c = s and dt = 1)
//   p[i, j]  = exp(s_c - lse[i]) where the key is visible (the ragged Skv
//              edge, causal, window, as in the forward, positions
//              q_offset + i and j) and lse[i] is finite, else 0
//   delta[i] = dout[i] . out[i]                     (float32)
//   ds[i, j] = p * (dout[i] . v[j] - delta[i]) * dt
//   dq[i] = scale * sum_j ds k[j],  dk[j] = scale * sum_i ds q[i],
//   dv[j] = sum_i p dout[i]
// accumulated in float32 and written in the inputs' dtype (float32 or
// bfloat16, all alike).  Every tensor but lse and delta is addressed
// through (b, h, s) element strides with a unit stride along D, so the
// model's (B, S, H, D) tensors are read and written as (B, H, S, D) views.
//
// Two passes, as FA-2 and the JAX code: a dq pass, one CTA per (b·h, 64 q
// rows), loops over the kv tiles its rows can see and also writes delta;
// a dk/dv pass, one CTA per (b·h, 64 keys), launched after it on the same
// stream, loops over the q tiles that can see its keys and reads that
// delta.  Tiles past the causal diagonal or outside the window are
// skipped whole.  Every output element is summed by one thread in a fixed
// order: no atomics, so the gradient is the same bits on every run (the
// restart drill compares losses bit for bit).
//
// Bound on this card: operations.  At smollm-135m's train shape (B 8,
// H 9, S 2048, D 64, causal) the backward needs 2·B·H·(S(S+1)/2)·D·5 ≈
// 9.7e10 flops (five products of the visible pairs: s recomputed, dp, dq,
// dk, dv), 0.098 ms at the 989 TFLOP/s of the bf16 tensor cores, while
// its tensors move ≈ 0.15 GB (0.045 ms at 3.35 TB/s).
//
// bfloat16: flash_bwd_dq_tc_kernel and flash_bwd_dkdv_tc_kernel, the
// forward's tensor-core structure (flash_attn.cu; primitives in
// flash_mma.cuh).  4 warps of 16 rows a CTA; the streamed side comes in a
// 2-stage cp.async ring of 64-row tiles; every product is mma.sync
// m16n8k16 with float32 sums and the same fragment patterns as the
// forward's: S = Q·Kᵀ and dP = dO·Vᵀ (dq pass) or Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ (dk/dv pass) from ldmatrix, and P (Pᵀ) and dS (dSᵀ) fed
// from the accumulators as A operands, rounded to bf16, against
// ldmatrix.trans fragments of K (dq += dS·K), dO (dV += Pᵀ·dO) and Q
// (dK += dSᵀ·Q).  The rows' own operands (Q and dO; K and V) stay in
// registers for the whole loop.  Rounding P and dS to bf16 is the one
// numeric difference from the float32 tiles of the plain version, as P's
// is in the forward; with bf16 inputs it is what the JAX package's
// set_tile_dtype(bfloat16) does, so the tile flag changes nothing here.
//
// float32: flash_bwd_dq_kernel and flash_bwd_dkdv_kernel, scalar FMAs on
// the CUDA cores as the float32 forward: 4 threads own one row and split
// D (float4 c of a thread holds d = 16c + 4·lane .. +3), sum each dot
// product with two xor shuffles, and stream the other side's rows through
// shared memory in float32 tiles of 32; expf and tanhf as the plain
// version.  tile_bf16 rounds p, ds and the operands they multiply to
// bfloat16 first, as repro/models/flash.py's TILE_DTYPE does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: scalar kernels on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kLanes = 4;            // threads sharing one row
constexpr int kRows = 64;            // rows a CTA owns (q or k)
constexpr int kThreads = kRows * kLanes;
constexpr int kTile = 32;            // streamed rows in shared memory

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int Skv,
                                        int causal, int window) {
  bool ok = k_pos < Skv;
  if (causal) ok = ok && q_pos >= k_pos;
  if (window > 0) ok = ok && (q_pos - k_pos) < window;
  return ok;
}

// rows [row0, row0 + kTile) x D of a strided operand -> shared memory
// (times `mul`); rows at or past `limit` are 0
template <int D>
__device__ __forceinline__ void load_rows(float (*dst)[D], const float* src,
                                          long long stride, int row0,
                                          int limit, float mul) {
  for (int t = threadIdx.x; t < kTile * D; t += kThreads) {
    const int r = t / D;
    const int d = t - r * D;
    const int row = row0 + r;
    dst[r][d] = row < limit ? src[(long long)row * stride + d] * mul : 0.f;
  }
}

// the scores' (s_c, dt) and p of one pair, from the raw dot product
__device__ __forceinline__ float pair_p(float s, float lse, bool ok,
                                        float cap, float& dt) {
  dt = 1.f;
  if (cap > 0.f) {
    const float th = tanhf(s / cap);
    s = th * cap;
    dt = 1.f - th * th;
  }
  return (ok && lse != -INFINITY) ? expf(s - lse) : 0.f;
}

// ---------------------------------------------------------------------------
// pass 1: dq (and delta), one CTA per (b·h, kRows q rows)
// ---------------------------------------------------------------------------

template <int D, bool TILE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, float* __restrict__ dq, int H,
                    int Sq, int Skv, Strides sq, Strides sk, Strides sv,
                    Strides so, Strides sdo, Strides sdq, int causal,
                    int window, float cap, float scale, int q_offset) {
  static_assert(D % 16 == 0 && D <= 128, "D: a multiple of 16, at most 128");
  constexpr int kV4 = D / 16;
  __shared__ __align__(16) float k_tile[kTile][D];
  __shared__ __align__(16) float v_tile[kTile][D];

  // the longest causal q tiles first: they set the tail of the grid
  const int n_qt = gridDim.x;
  const int qt = causal ? (n_qt - 1 - (int)blockIdx.x) : (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int q0 = qt * kRows;
  const int qi = q0 + row;
  const int q_pos = q_offset + qi;
  const bool valid = qi < Sq;

  const float* qb = q + b * sq.b + h * sq.h + (long long)qi * sq.s;
  const float* ob = out + b * so.b + h * so.h + (long long)qi * so.s;
  const float* dob = dout + b * sdo.b + h * sdo.h + (long long)qi * sdo.s;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[kV4][4], dor[kV4][4], acc[kV4][4];
  float dsum = 0.f;
#pragma unroll
  for (int c = 0; c < kV4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * c + 4 * lane + e;
      qr[c][e] = valid ? qb[d] * scale : 0.f;
      dor[c][e] = valid ? dob[d] : 0.f;
      dsum = fmaf(dor[c][e], valid ? ob[d] : 0.f, dsum);
      acc[c][e] = 0.f;
    }
  }
  const float dlt = quad_sum(dsum);
  const long long row_idx = (long long)bh * Sq + qi;
  if (valid && lane == 0) delta[row_idx] = dlt;
  const float lse_i = valid ? lse[row_idx] : -INFINITY;

  // the kv range any row of this tile can see
  int k_lo = 0;
  int k_hi = Skv;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  if (causal) k_hi = min(Skv, max(0, q_offset + q0 + kRows));
  k_lo = (k_lo / kTile) * kTile;

  for (int k0 = k_lo; k0 < k_hi; k0 += kTile) {
    __syncthreads();                 // the previous tile is consumed
    load_rows<D>(k_tile, kb, sk.s, k0, Skv, 1.f);
    load_rows<D>(v_tile, vb, sv.s, k0, Skv, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kV4; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&k_tile[j][16 * c + 4 * lane]);
        const float4 vv =
            *reinterpret_cast<const float4*>(&v_tile[j][16 * c + 4 * lane]);
        s = fmaf(qr[c][0], kk.x, s);
        s = fmaf(qr[c][1], kk.y, s);
        s = fmaf(qr[c][2], kk.z, s);
        s = fmaf(qr[c][3], kk.w, s);
        dp = fmaf(dor[c][0], vv.x, dp);
        dp = fmaf(dor[c][1], vv.y, dp);
        dp = fmaf(dor[c][2], vv.z, dp);
        dp = fmaf(dor[c][3], vv.w, dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      float dt;
      const bool ok = valid && visible(q_pos, k0 + j, Skv, causal, window);
      const float p = pair_p(s, lse_i, ok, cap, dt);
      float ds = p * (dp - dlt);
      if (cap > 0.f) ds *= dt;
      if (TILE) ds = round_bf16(ds);
#pragma unroll
      for (int c = 0; c < kV4; ++c) {
        float4 kk =
            *reinterpret_cast<const float4*>(&k_tile[j][16 * c + 4 * lane]);
        if (TILE) {
          kk.x = round_bf16(kk.x);
          kk.y = round_bf16(kk.y);
          kk.z = round_bf16(kk.z);
          kk.w = round_bf16(kk.w);
        }
        acc[c][0] = fmaf(ds, kk.x, acc[c][0]);
        acc[c][1] = fmaf(ds, kk.y, acc[c][1]);
        acc[c][2] = fmaf(ds, kk.z, acc[c][2]);
        acc[c][3] = fmaf(ds, kk.w, acc[c][3]);
      }
    }
  }

  if (!valid) return;
  float* dqb = dq + b * sdq.b + h * sdq.h + (long long)qi * sdq.s;
#pragma unroll
  for (int c = 0; c < kV4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqb[16 * c + 4 * lane + e] = acc[c][e] * scale;
  }
}

// ---------------------------------------------------------------------------
// pass 2: dk and dv, one CTA per (b·h, kRows keys)
// ---------------------------------------------------------------------------

template <int D, bool TILE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int H,
                      int Sq, int Skv, Strides sq,
                      Strides sk, Strides sv, Strides sdo, Strides sdk,
                      Strides sdv, int causal, int window, float cap,
                      float scale, int q_offset) {
  static_assert(D % 16 == 0 && D <= 128, "D: a multiple of 16, at most 128");
  constexpr int kV4 = D / 16;
  __shared__ __align__(16) float q_tile[kTile][D];    // q · scale
  __shared__ __align__(16) float do_tile[kTile][D];
  __shared__ float lse_tile[kTile];
  __shared__ float delta_tile[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int k0 = blockIdx.x * kRows;
  const int kj = k0 + row;
  const bool valid = kj < Skv;

  const float* kb = k + b * sk.b + h * sk.h + (long long)kj * sk.s;
  const float* vb = v + b * sv.b + h * sv.h + (long long)kj * sv.s;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (long long)bh * Sq;
  const float* deltab = delta + (long long)bh * Sq;

  float kr[kV4][4], vr[kV4][4], dk_acc[kV4][4], dv_acc[kV4][4];
#pragma unroll
  for (int c = 0; c < kV4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * c + 4 * lane + e;
      kr[c][e] = valid ? kb[d] : 0.f;
      vr[c][e] = valid ? vb[d] : 0.f;
      dk_acc[c][e] = 0.f;
      dv_acc[c][e] = 0.f;
    }
  }

  // the q rows that can see any key of this tile
  int q_lo = 0;
  int q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, max(0, k0 + kRows - 1 + window - q_offset));
  q_lo = (q_lo / kTile) * kTile;

  for (int q0 = q_lo; q0 < q_hi; q0 += kTile) {
    __syncthreads();                 // the previous tile is consumed
    load_rows<D>(q_tile, qb, sq.s, q0, Sq, scale);
    load_rows<D>(do_tile, dob, sdo.s, q0, Sq, 1.f);
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      lse_tile[threadIdx.x] = qi < Sq ? lseb[qi] : -INFINITY;
      delta_tile[threadIdx.x] = qi < Sq ? deltab[qi] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kV4; ++c) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&q_tile[i][16 * c + 4 * lane]);
        const float4 dd =
            *reinterpret_cast<const float4*>(&do_tile[i][16 * c + 4 * lane]);
        s = fmaf(qq.x, kr[c][0], s);
        s = fmaf(qq.y, kr[c][1], s);
        s = fmaf(qq.z, kr[c][2], s);
        s = fmaf(qq.w, kr[c][3], s);
        dp = fmaf(dd.x, vr[c][0], dp);
        dp = fmaf(dd.y, vr[c][1], dp);
        dp = fmaf(dd.z, vr[c][2], dp);
        dp = fmaf(dd.w, vr[c][3], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const int qi = q0 + i;
      float dt;
      const bool ok = valid && qi < Sq
          && visible(q_offset + qi, kj, Skv, causal, window);
      float p = pair_p(s, lse_tile[i], ok, cap, dt);
      float ds = p * (dp - delta_tile[i]);
      if (cap > 0.f) ds *= dt;
      if (TILE) {
        p = round_bf16(p);
        ds = round_bf16(ds);
      }
#pragma unroll
      for (int c = 0; c < kV4; ++c) {
        float4 qq =
            *reinterpret_cast<const float4*>(&q_tile[i][16 * c + 4 * lane]);
        float4 dd =
            *reinterpret_cast<const float4*>(&do_tile[i][16 * c + 4 * lane]);
        if (TILE) {
          qq.x = round_bf16(qq.x);
          qq.y = round_bf16(qq.y);
          qq.z = round_bf16(qq.z);
          qq.w = round_bf16(qq.w);
          dd.x = round_bf16(dd.x);
          dd.y = round_bf16(dd.y);
          dd.z = round_bf16(dd.z);
          dd.w = round_bf16(dd.w);
        }
        dv_acc[c][0] = fmaf(p, dd.x, dv_acc[c][0]);
        dv_acc[c][1] = fmaf(p, dd.y, dv_acc[c][1]);
        dv_acc[c][2] = fmaf(p, dd.z, dv_acc[c][2]);
        dv_acc[c][3] = fmaf(p, dd.w, dv_acc[c][3]);
        dk_acc[c][0] = fmaf(ds, qq.x, dk_acc[c][0]);
        dk_acc[c][1] = fmaf(ds, qq.y, dk_acc[c][1]);
        dk_acc[c][2] = fmaf(ds, qq.z, dk_acc[c][2]);
        dk_acc[c][3] = fmaf(ds, qq.w, dk_acc[c][3]);
      }
    }
  }

  if (!valid) return;
  float* dkb = dk + b * sdk.b + h * sdk.h + (long long)kj * sdk.s;
  float* dvb = dv + b * sdv.b + h * sdv.h + (long long)kj * sdv.s;
#pragma unroll
  for (int c = 0; c < kV4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * c + 4 * lane + e;
      dkb[d] = dk_acc[c][e];
      dvb[d] = dv_acc[c][e];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernels (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;   // the rows a CTA owns, 16 a warp
constexpr int kTcTile = 64;              // rows of a streamed tile

// Shared memory of both passes: six 64-row tiles of D bf16, rows padded
// by 8 elements (16 bytes: the 8 rows of an ldmatrix phase fall in 8
// bank groups), and the dk/dv pass's lse and delta of two q tiles.
template <int D>
struct BwdTc {
  static constexpr int kPitch = D + 8;
  static constexpr int kTile = kTcTile * kPitch;
  static constexpr int kBytes = 6 * kTile * 2 + 4 * kTcTile * 4;
};

// p and dS of one score, from its raw dot product s = q·k (unscaled),
// dp = dout·v, its query row's lse and delta; both 0 where !ok
__device__ __forceinline__ void tc_pair(float s, float dp, float lse,
                                        float dlt, bool ok, float cap,
                                        float scale, float& p, float& ds) {
  float sc = s * scale;
  float dt = 1.f;
  if (cap > 0.f) {
    const float th = tanhf(sc / cap);
    sc = th * cap;
    dt = 1.f - th * th;
  }
  p = (ok && lse != -INFINITY) ? ex2((sc - lse) * kLog2e) : 0.f;
  ds = p * (dp - dlt) * dt;
}

// A fragment (16 rows x k16) of accumulator tiles 2kk and 2kk + 1, to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// the warp's A fragments (its 16 rows x D) of a padded shared tile
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             uint32_t tile, int warp,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(f[kk], tile + (uint32_t)(((warp * 16 + (lane & 15)) * (D + 8)
                                          + kk * 16 + (lane >> 4) * 8) * 2));
}

// c[0 .. 7] (16 rows x 64 columns) += A (16 x D) · Xᵀ, X a 64-row tile
// (B fragments by ldmatrix, as K in the forward's S = Q·Kᵀ)
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[kTcTile / 8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        uint32_t tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nb2 = 0; nb2 < kTcTile / 16; ++nb2) {
      uint32_t f[4];
      const int row = nb2 * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int d = kk * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(f, tile + (uint32_t)((row * (D + 8) + d) * 2));
      mma_bf16(c[2 * nb2], a[kk], f[0], f[1]);
      mma_bf16(c[2 * nb2 + 1], a[kk], f[2], f[3]);
    }
  }
}

// c[0 .. D/8) (16 rows x D) += A (16 x 64, from the accumulators `x`,
// rounded to bf16) · X, X a 64-row tile (B fragments by ldmatrix.trans,
// as V in the forward's P·V)
template <int D>
__device__ __forceinline__ void mma_ab(float (&c)[D / 8][4],
                                       const float (&x)[kTcTile / 8][4],
                                       uint32_t tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < kTcTile / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int dn2 = 0; dn2 < D / 16; ++dn2) {
      uint32_t f[4];
      const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int d = dn2 * 16 + (lane >> 4) * 8;
      ldmatrix_x4_trans(f, tile + (uint32_t)((row * (D + 8) + d) * 2));
      mma_bf16(c[2 * dn2], a, f[0], f[1]);
      mma_bf16(c[2 * dn2 + 1], a, f[2], f[3]);
    }
  }
}

// rows g and g + 8 of a warp's 16 x D accumulator, times `mul`, as bf16
// pairs through the (b, h, s) strides; rows at or past `limit` skipped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long s,
                                           int row0, int limit,
                                           const float (&c)[D / 8][4],
                                           float mul, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= limit) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(&base[(long long)row * s + i * 8 + 2 * t]) =
          pack_bf16(c[i][2 * r] * mul, c[i][2 * r + 1] * mul);
  }
}

// pass 1: dq and delta, one CTA per (b·h, 64 q rows); Q and dO fragments
// in registers, K and V tiles streamed
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ out,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int H, int Sq,
                       int Skv, Strides sq, Strides sk, Strides sv,
                       Strides so, Strides sdo, Strides sdq, int causal,
                       int window, float cap, float scale, int q_offset) {
  static_assert(D % 16 == 0 && D <= 128, "D: a multiple of 16, at most 128");
  using Cfg = BwdTc<D>;
  constexpr int kNB = kTcTile / 8;
  constexpr int kDB = D / 8;
  constexpr uint32_t kTileBytes = Cfg::kTile * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = smem_addr(smem_raw);
  const uint32_t sDO = sQ + kTileBytes;
  const uint32_t sK = sDO + kTileBytes;            // 2 stages
  const uint32_t sV = sK + 2 * kTileBytes;         // 2 stages

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_qt = gridDim.y;
  const int qt = causal ? (n_qt - 1 - (int)blockIdx.y) : (int)blockIdx.y;
  const int q0 = qt * kTcRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w_row = q0 + warp * 16;                // the warp's first row

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const __nv_bfloat16* ob = out + b * so.b + h * so.h;
  const __nv_bfloat16* dob = dout + b * sdo.b + h * sdo.h;

  int k_lo = 0;
  int k_hi = Skv;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  if (causal) k_hi = min(Skv, max(0, q_offset + q0 + kTcRows));
  k_lo = (k_lo / kTcTile) * kTcTile;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kTcTile - 1) / kTcTile : 0;

  load_tile<D, kTcThreads, kTcRows>(sQ, qb, sq.s, q0, Sq, tid);
  load_tile<D, kTcThreads, kTcRows>(sDO, dob, sdo.s, q0, Sq, tid);
  if (n_tiles > 0) {
    load_tile<D, kTcThreads, kTcTile>(sK, kb, sk.s, k_lo, Skv, tid);
    load_tile<D, kTcThreads, kTcTile>(sV, vb, sv.s, k_lo, Skv, tid);
  }
  cp_async_commit();

  // delta of the warp's 16 rows (float32 sums over the lanes); this
  // thread keeps those of its rows g and g + 8, and their lse
  float dlt[2] = {0.f, 0.f};
  float lse_r[2];
  for (int r = 0; r < 16; ++r) {
    const int qi = w_row + r;
    float acc = 0.f;
    if (qi < Sq) {
      const __nv_bfloat16* o_row = ob + (long long)qi * so.s;
      const __nv_bfloat16* d_row = dob + (long long)qi * sdo.s;
      for (int d = lane; d < D; d += 32)
        acc = fmaf(__bfloat162float(d_row[d]), __bfloat162float(o_row[d]),
                   acc);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (r == g) dlt[0] = acc;
    if (r == g + 8) dlt[1] = acc;
    if (lane == 0 && qi < Sq) delta[(long long)bh * Sq + qi] = acc;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w_row + g + 8 * r;
    lse_r[r] = qi < Sq ? lse[(long long)bh * Sq + qi] : -INFINITY;
  }

  uint32_t qf[D / 16][4], df[D / 16][4];
  float acc[kDB][4];
#pragma unroll
  for (int i = 0; i < kDB; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * kTcTile;
    if (it + 1 < n_tiles) {          // the next tile into the other stage
      const uint32_t off = ((it + 1) & 1) * kTileBytes;
      load_tile<D, kTcThreads, kTcTile>(sK + off, kb, sk.s, k0 + kTcTile, Skv,
                                        tid);
      load_tile<D, kTcThreads, kTcTile>(sV + off, vb, sv.s, k0 + kTcTile, Skv,
                                        tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      load_a_frags<D>(qf, sQ, warp, lane);
      load_a_frags<D>(df, sDO, warp, lane);
    }
    const uint32_t stage = (it & 1) * kTileBytes;
    float s[kNB][4], dp[kNB][4];
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    mma_abt<D>(s, qf, sK + stage, lane);           // S = Q·Kᵀ
    mma_abt<D>(dp, df, sV + stage, lane);          // dP = dO·Vᵀ
    const bool cut = (k0 + kTcTile > Skv) || (w_row + 16 > Sq)
        || (causal && k0 + kTcTile - 1 > q_offset + w_row)
        || (window > 0 && q_offset + w_row + 15 - k0 >= window);
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        bool ok = true;
        if (cut) {
          const int qi = w_row + g + 8 * r;
          ok = qi < Sq && visible(q_offset + qi, k0 + i * 8 + 2 * t + (e & 1),
                                  Skv, causal, window);
        }
        float p;
        tc_pair(s[i][e], dp[i][e], lse_r[r], dlt[r], ok, cap, scale, p,
                s[i][e]);
      }
    }
    mma_ab<D>(acc, s, sK + stage, lane);           // dQ += dS·K
    __syncthreads();                 // this stage is free for tile it + 2
  }
  cp_async_wait<0>();
  store_rows<D>(dq + b * sdq.b + h * sdq.h, sdq.s, w_row, Sq, acc, scale, g,
                t);
}

// pass 2: dk and dv, one CTA per (b·h, 64 keys); K and V fragments in
// registers, Q and dO tiles (with their rows' lse and delta) streamed
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Sq,
                         int Skv, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdk, Strides sdv, int causal,
                         int window, float cap, float scale, int q_offset) {
  static_assert(D % 16 == 0 && D <= 128, "D: a multiple of 16, at most 128");
  using Cfg = BwdTc<D>;
  constexpr int kNB = kTcTile / 8;
  constexpr int kDB = D / 8;
  constexpr uint32_t kTileBytes = Cfg::kTile * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sK = smem_addr(smem_raw);
  const uint32_t sV = sK + kTileBytes;
  const uint32_t sQ = sV + kTileBytes;             // 2 stages
  const uint32_t sDO = sQ + 2 * kTileBytes;        // 2 stages
  float (*s_lse)[kTcTile] = reinterpret_cast<float (*)[kTcTile]>(
      smem_raw + 6 * kTileBytes);                  // [2][64]
  float (*s_dlt)[kTcTile] = s_lse + 2;             // [2][64]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kTcRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kw = k0 + warp * 16;                   // the warp's first key

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const __nv_bfloat16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (long long)bh * Sq;
  const float* dltb = delta + (long long)bh * Sq;

  // the q rows that can see any key of this tile
  int q_lo = 0;
  int q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, max(0, k0 + kTcRows - 1 + window - q_offset));
  q_lo = (q_lo / kTcTile) * kTcTile;
  const int n_tiles = q_hi > q_lo ? (q_hi - q_lo + kTcTile - 1) / kTcTile : 0;

  load_tile<D, kTcThreads, kTcRows>(sK, kb, sk.s, k0, Skv, tid);
  load_tile<D, kTcThreads, kTcRows>(sV, vb, sv.s, k0, Skv, tid);
  if (n_tiles > 0) {
    load_tile<D, kTcThreads, kTcTile>(sQ, qb, sq.s, q_lo, Sq, tid);
    load_tile<D, kTcThreads, kTcTile>(sDO, dob, sdo.s, q_lo, Sq, tid);
    if (tid < kTcTile) {
      const int qi = q_lo + tid;
      s_lse[0][tid] = qi < Sq ? lseb[qi] : -INFINITY;
      s_dlt[0][tid] = qi < Sq ? dltb[qi] : 0.f;
    }
  }
  cp_async_commit();

  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dk_acc[kDB][4], dv_acc[kDB][4];
#pragma unroll
  for (int i = 0; i < kDB; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_lo + it * kTcTile;
    if (it + 1 < n_tiles) {          // the next tile into the other stage
      const int nx = (it + 1) & 1;
      const uint32_t off = nx * kTileBytes;
      load_tile<D, kTcThreads, kTcTile>(sQ + off, qb, sq.s, q0 + kTcTile, Sq,
                                        tid);
      load_tile<D, kTcThreads, kTcTile>(sDO + off, dob, sdo.s, q0 + kTcTile,
                                        Sq, tid);
      if (tid < kTcTile) {
        const int qi = q0 + kTcTile + tid;
        s_lse[nx][tid] = qi < Sq ? lseb[qi] : -INFINITY;
        s_dlt[nx][tid] = qi < Sq ? dltb[qi] : 0.f;
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      load_a_frags<D>(kf, sK, warp, lane);
      load_a_frags<D>(vf, sV, warp, lane);
    }
    const int st = it & 1;
    const uint32_t stage = st * kTileBytes;
    float s[kNB][4], dp[kNB][4];
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    mma_abt<D>(s, kf, sQ + stage, lane);           // Sᵀ = K·Qᵀ
    mma_abt<D>(dp, vf, sDO + stage, lane);         // dPᵀ = V·dOᵀ
    const bool cut = (kw + 16 > Skv) || (q0 + kTcTile > Sq)
        || (causal && kw + 15 > q_offset + q0)
        || (window > 0 && q_offset + q0 + kTcTile - 1 - kw >= window);
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = i * 8 + 2 * t + (e & 1);     // the q row in the tile
        bool ok = true;
        if (cut)
          ok = q0 + c < Sq && visible(q_offset + q0 + c, kw + g + 8 * (e >> 1),
                                      Skv, causal, window);
        tc_pair(s[i][e], dp[i][e], s_lse[st][c], s_dlt[st][c], ok, cap,
                scale, s[i][e], dp[i][e]);
      }
    }
    mma_ab<D>(dv_acc, s, sDO + stage, lane);       // dV += Pᵀ·dO
    mma_ab<D>(dk_acc, dp, sQ + stage, lane);       // dK += dSᵀ·Q
    __syncthreads();                 // this stage is free for tile it + 2
  }
  cp_async_wait<0>();
  store_rows<D>(dk + b * sdk.b + h * sdk.h, sdk.s, kw, Skv, dk_acc, scale, g,
                t);
  store_rows<D>(dv + b * sdv.b + h * sdv.h, sdv.s, kw, Skv, dv_acc, 1.f, g,
                t);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int H, Sq, Skv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int causal, window;
  float cap, scale;
  int q_offset;
};

template <int D, bool TILE>
int launch_f32(const BwdArgs& a, long long bh, int passes, cudaStream_t s) {
  if (passes & 1) {
    const dim3 grid((unsigned)((a.Sq + kRows - 1) / kRows), (unsigned)bh);
    flash_bwd_dq_kernel<D, TILE><<<grid, kThreads, 0, s>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.out, (const float*)a.dout, a.lse, a.delta,
        (float*)a.dq, a.H, a.Sq, a.Skv, a.sq, a.sk, a.sv, a.so, a.sdo, a.sdq,
        a.causal, a.window, a.cap, a.scale, a.q_offset);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if ((passes & 2) && a.Skv > 0) {
    const dim3 grid((unsigned)((a.Skv + kRows - 1) / kRows), (unsigned)bh);
    flash_bwd_dkdv_kernel<D, TILE><<<grid, kThreads, 0, s>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, a.lse, a.delta, (float*)a.dk, (float*)a.dv,
        a.H, a.Sq, a.Skv, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.causal,
        a.window, a.cap, a.scale, a.q_offset);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const BwdArgs& a, long long bh, int passes, cudaStream_t s) {
  using Bf = __nv_bfloat16;
  constexpr int kBytes = BwdTc<D>::kBytes;
  static std::atomic<unsigned long long> raised_dq{0}, raised_dkdv{0};
  if (passes & 1) {
    const long long n_qt = (a.Sq + kTcRows - 1) / kTcRows;
    if (n_qt > 65535) return (int)cudaErrorInvalidValue;
    cudaError_t e =
        raise_smem_limit(flash_bwd_dq_tc_kernel<D>, kBytes, raised_dq);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dq_tc_kernel<D><<<dim3((unsigned)bh, (unsigned)n_qt),
                                kTcThreads, kBytes, s>>>(
        (const Bf*)a.q, (const Bf*)a.k, (const Bf*)a.v, (const Bf*)a.out,
        (const Bf*)a.dout, a.lse, a.delta, (Bf*)a.dq, a.H, a.Sq, a.Skv, a.sq,
        a.sk, a.sv, a.so, a.sdo, a.sdq, a.causal, a.window, a.cap, a.scale,
        a.q_offset);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if ((passes & 2) && a.Skv > 0) {
    const long long n_kt = (a.Skv + kTcRows - 1) / kTcRows;
    if (n_kt > 65535) return (int)cudaErrorInvalidValue;
    const cudaError_t e =
        raise_smem_limit(flash_bwd_dkdv_tc_kernel<D>, kBytes, raised_dkdv);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dkdv_tc_kernel<D><<<dim3((unsigned)bh, (unsigned)n_kt),
                                  kTcThreads, kBytes, s>>>(
        (const Bf*)a.q, (const Bf*)a.k, (const Bf*)a.v, (const Bf*)a.dout,
        a.lse, a.delta, (Bf*)a.dk, (Bf*)a.dv, a.H, a.Sq, a.Skv, a.sq, a.sk,
        a.sv, a.sdo, a.sdk, a.sdv, a.causal, a.window, a.cap, a.scale,
        a.q_offset);
  }
  return (int)cudaGetLastError();
}

// float32 (dtype 0) takes the scalar kernels, bfloat16 (1) the tensor-core
// ones; D in {16, 64, 80, 128}
template <int D>
int launch_d(const BwdArgs& a, int tile_bf16, int dtype, long long bh,
             int passes, cudaStream_t s) {
  if (dtype == 1) return launch_tc<D>(a, bh, passes, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return tile_bf16 ? launch_f32<D, true>(a, bh, passes, s)
                   : launch_f32<D, false>(a, bh, passes, s);
}

}  // namespace

extern "C" {

// q, out, dout, dq (B, H, Sq, D) and k, v, dk, dv (B, H, Skv, D), each
// given by its (b, h, s) element strides with a unit stride along D; lse
// (the forward's) and delta (scratch, written by pass 1) contiguous
// (B, H, Sq) float32.  dtype: 0 float32, 1 bfloat16 (all eight alike;
// q, k, v and dout then with 16-byte aligned base pointers and (b, h, s)
// strides, for cp.async).  D in {16, 64, 80, 128}.  tile_bf16: the float32
// kernels' rounding (the bfloat16 ones always round).  passes: 1 the dq
// pass (with delta), 2 the dk/dv pass (reads delta), 3 both in that order.
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Sq, int Skv, int D, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, long long dosb,
    long long dosh, long long doss, long long dqsb, long long dqsh,
    long long dqss, long long dksb, long long dksh, long long dkss,
    long long dvsb, long long dvsh, long long dvss, int causal, int window,
    float cap, float scale, int q_offset, int tile_bf16, int dtype,
    int passes, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Skv < 0) return (int)cudaErrorInvalidValue;
  const long long bh = (long long)B * H;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, out, dout, (const float*)lse, (float*)delta,
                  dq, dk, dv, H, Sq, Skv,
                  {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                  {osb, osh, oss}, {dosb, dosh, doss}, {dqsb, dqsh, dqss},
                  {dksb, dksh, dkss}, {dvsb, dvsh, dvss},
                  causal, window, cap, scale, q_offset};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_d<16>(a, tile_bf16, dtype, bh, passes, s);
    case 64:
      return launch_d<64>(a, tile_bf16, dtype, bh, passes, s);
    case 80:
      return launch_d<80>(a, tile_bf16, dtype, bh, passes, s);
    case 128:
      return launch_d<128>(a, tile_bf16, dtype, bh, passes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
