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
// Two passes, as FA-2 and the JAX code: a dq pass, one CTA per (b·h, a
// tile of q rows), loops over the kv tiles its rows can see and also
// writes delta; a dk/dv pass, one CTA per (b·h, a tile of keys), launched
// after it on the same stream, loops over the q tiles that can see its
// keys and reads that delta.  Tiles past the causal diagonal or outside
// the window are skipped whole, and under a causal mask the CTAs with the
// most tiles are launched first (the last q tiles, the first key tiles),
// so the grid does not end in a tail of long CTAs.  Every output element
// is summed by one thread in a fixed order: no atomics, so the gradient
// is the same bits on every run (the restart drill compares losses bit
// for bit).
//
// Bound on this card: operations.  At smollm-135m's train shape (B 8,
// H 9, S 2048, D 64, causal) the backward needs 2·B·H·(S(S+1)/2)·D·5 ≈
// 9.7e10 flops (five products of the visible pairs: s recomputed, dp, dq,
// dk, dv), 0.098 ms at the 989 TFLOP/s of the bf16 tensor cores, while
// its tensors move ≈ 0.15 GB (0.045 ms at 3.35 TB/s).  The two passes do
// seven products (S and dP in both) and two exponentials a score, so the
// design's own floor is 1.4x that bound.
//
// bfloat16 (D = 16, 64, 80 and 128): flash_bwd_dq_wg_kernel and
// flash_bwd_dkdv_wg_kernel, warp-specialised for Hopper (primitives in
// sm90.cuh).  A CTA owns 128 rows (q rows, or keys) and has three
// warpgroups: a producer warp that TMA-loads the CTA's own two operands
// once (Q and dO, or K and V: they stay in shared memory for the CTA's
// life) and then keeps the other side's 64-row tiles (K and V, or Q and
// dO with their rows' lse·log2(e) and delta) in flight in a 2-stage ring
// on mbarriers; and two consumer warpgroups of 64 rows each (setmaxnreg:
// 24 registers for the producer, 240 for the consumers) that run wgmma
// m64nNk16 with float32 sums: S = Q·Kᵀ and dP = dO·Vᵀ (dq pass) or
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (dk/dv pass), both operands read from
// shared memory; then dQ += dS·K, or dV += Pᵀ·dO and dK += dSᵀ·Q, with P
// (Pᵀ) and dS (dSᵀ) rounded to bf16 as register A operands and the
// streamed tile as the MN-major B.  Each group is issued before the
// element work it overlaps: P is made while dP runs, dS while dV runs.
// An operand's rows are split where the TMA's swizzle spans end: 64-
// column blocks of 128-byte rows under the 128-byte swizzle (D = 128 is
// two), and for D = 80 (hubert-xlarge, zamba2-2.7b: 160-byte rows, past
// the 128-byte span) a 16-column tail of 32-byte rows under the 32-byte
// swizzle (D = 16, the SMOKE configs, is that tail alone).  Each operand
// has a tensor map for each box shape (64 x 64 at column 0, 16 x 64 at
// column 64), both loads completing on one mbarrier that counts the whole
// rows' bytes; the wgmma descriptors name each part's swizzle.  A product
// over D takes its four k16 steps in each block and one in the tail; a
// product whose N is D issues an n64 (n128) over the blocks and an n16
// over the tail, whose 8 sums a thread follow the block's in one
// accumulator.  At D = 80 a CTA holds 82 KB of shared memory and a dk/dv
// consumer 40 + 40 float32 sums besides S and dP: no spill under 240
// registers.  What bounds the kernels now: the element work between the
// products (an exponential a score, a MUFU op at 16 a clock an SM,
// besides the masks and the bf16 packing) serialises with each
// warpgroup's own products, and the two warpgroups overlap each other's
// only in part; the dq pass recomputes S and dP (the seven products
// above); the n16 tail products use the tensor cores at a quarter of an
// n64's width.  Rounding P and dS to bf16 is the one numeric difference
// from the float32 tiles of the plain version, as P's is in the forward;
// with bf16 inputs it is what the JAX package's set_tile_dtype(bfloat16)
// does, so the tile flag changes nothing here.
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

#include "sm90.cuh"

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
// bfloat16: warp-specialised wgmma kernels (TMA, mbarriers, setmaxnreg)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;      // a producer warpgroup, two consumers
constexpr int kWgRows = 128;         // the rows a CTA owns, 64 a consumer
constexpr int kWgTile = 64;          // rows of a streamed tile
constexpr int kWgStages = 2;         // the ring of streamed tiles
constexpr int kProducerRegs = 24;    // 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr int kEmptyArrivals = 8;    // one a consumer warp

// Shared memory, from a 1024-byte aligned base: the CTA's own two operands
// (128 rows each: K and V, or Q and dO), a ring of kWgStages pairs of
// streamed tiles (kWgTile rows each: Q and dO, or K and V); each operand
// is D / 64 swizzled blocks of 64 columns (128-byte rows, the 128-byte
// swizzle) and, where D is not a multiple of 64, a tail of the last 16
// columns (32-byte rows, the 32-byte swizzle: D = 80 is one block and a
// tail, D = 16 a tail alone); then 2 x kWgTile floats a stage (the dk/dv
// pass's lse·log2(e) and delta of the tile's q rows; the dq pass keeps its
// rows' delta there) and the mbarriers: full[stage], empty[stage] and one
// for the own operands.  Every block and tail starts 1024-byte aligned.
template <int D>
struct BwdWg {
  static_assert(D == 16 || D == 64 || D == 80 || D == 128,
                "the wgmma kernels take D 16, 64, 80 and 128");
  static constexpr int kBlocks = D / 64;
  static constexpr int kTail = D % 64;                        // 0 or 16
  static constexpr uint32_t kOwnBlock = kWgRows * 128;
  static constexpr uint32_t kOwn = kBlocks * kOwnBlock + kWgRows * kTail * 2;
  static constexpr uint32_t kTileBlock = kWgTile * 128;
  static constexpr uint32_t kTile = kBlocks * kTileBlock + kWgTile * kTail * 2;
  static constexpr uint32_t kRing = 2 * kOwn;
  static constexpr uint32_t kVec = kRing + kWgStages * 2 * kTile;
  static constexpr uint32_t kBar = kVec + kWgStages * 2 * kWgTile * 4;
  static constexpr uint32_t kBytes = kBar + (2 * kWgStages + 1) * 8;
  static constexpr int kLaunchBytes = (int)kBytes + 1024;   // + alignment
  static constexpr uint32_t kOwnTx = 2 * kWgRows * D * 2;   // bytes by TMA
  static constexpr uint32_t kTileTx = 2 * kWgTile * D * 2;
  static_assert(kTail == 0 || kTail == 16, "a tail is 16 columns");
  static_assert(kOwn % 1024 == 0 && kTile % 1024 == 0, "1024-byte tiles");
};

// x = A·Bᵀ of a consumer's 64 own rows (operand `own`) against a streamed
// kWgTile-row tile (operand `tile`), issued as one wgmma group
template <int D>
__device__ __forceinline__ void wg_issue_scores(float (&x)[kWgTile / 2],
                                                uint32_t own, uint32_t tile,
                                                int w) {
  using Cfg = BwdWg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(x, desc_k<D>(own, Cfg::kOwnBlock, 64 * w, kk),
                 desc_k<D>(tile, Cfg::kTileBlock, 0, kk), kk > 0);
  wgmma_commit();
}

// p of one score and p·dt (dt = 1 - tanh² under a cap, else 1), from its
// raw dot product s = q·k; lse2 is its row's lse·log2(e) (+inf where the
// row sees no key, so that p is 0); both 0 where !ok.  CAP and MASK are
// the tile's, so the loops over a tile carry no branch.
template <bool CAP, bool MASK>
__device__ __forceinline__ void wg_p(float s, float lse2, bool ok,
                                     const WgSoft& k, float& p, float& pdt) {
  if (CAP) {
    const float th = tanhf(s * k.sc);
    p = ex2(fmaf(th, k.cl, -lse2));
    if (MASK) p = ok ? p : 0.f;
    pdt = p * (1.f - th * th);
  } else {
    p = ex2(fmaf(s, k.sl, -lse2));
    if (MASK) p = ok ? p : 0.f;
    pdt = p;
  }
}

// The dk/dv pass's Pᵀ fragments (bf16) of a 64-key x kWgTile-q tile, and
// s := p·dt in place: key row kr0 + 8·r, q row q0 + c in the tile
template <bool CAP, bool MASK>
__device__ __forceinline__ void wg_pt_tile(float (&s)[kWgTile / 2],
                                           uint32_t (&pa)[kWgTile / 16][4],
                                           uint32_t lse_s, const WgSoft& k,
                                           int q0, int kr0, int t, int Sq,
                                           int Skv, int q_offset, int causal,
                                           int window) {
#pragma unroll
  for (int kq = 0; kq < kWgTile / 16; ++kq) {
    float p[8];
#pragma unroll
    for (int nb = 2 * kq; nb < 2 * kq + 2; ++nb) {   // n8 blocks of q rows
      const float2 l2 = lds_f2(lse_s + (8 * nb + 2 * t) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * nb + e;
        const int c = 8 * nb + 2 * t + (e & 1);
        bool ok = true;
        if (MASK)
          ok = q0 + c < Sq && visible(q_offset + q0 + c, kr0 + 8 * (e >> 1),
                                      Skv, causal, window);
        wg_p<CAP, MASK>(s[i], (e & 1) ? l2.y : l2.x, ok, k, p[i - 8 * kq],
                        s[i]);
      }
    }
    pa[kq][0] = pack_bf16(p[0], p[1]);
    pa[kq][1] = pack_bf16(p[2], p[3]);
    pa[kq][2] = pack_bf16(p[4], p[5]);
    pa[kq][3] = pack_bf16(p[6], p[7]);
  }
}

// The dq pass's s := p·dt in place over a 64-q x kWgTile-key tile: q row
// qr0 + 8·r (lse2[r]), key k0 + column
template <bool CAP, bool MASK>
__device__ __forceinline__ void wg_p_tile(float (&s)[kWgTile / 2],
                                          const float (&lse2)[2],
                                          const WgSoft& k, int qr0, int k0,
                                          int t, int Sq, int Skv,
                                          int q_offset, int causal,
                                          int window) {
#pragma unroll
  for (int i = 0; i < kWgTile / 2; ++i) {
    const int r = (i >> 1) & 1;
    bool ok = true;
    if (MASK) {
      const int qi = qr0 + 8 * r;
      ok = qi < Sq && visible(q_offset + qi,
                              k0 + (i >> 2) * 8 + 2 * t + (i & 1), Skv,
                              causal, window);
    }
    float p;
    wg_p<CAP, MASK>(s[i], lse2[r], ok, k, p, s[i]);
  }
}

// lse·log2(e), +inf for a row that sees no key (lse -inf) or lies past Sq
__device__ __forceinline__ float lse_log2(float lse, bool valid) {
  return valid && lse != -INFINITY ? lse * kLog2e : INFINITY;
}

// rows g and g + 8 of a warp's 16 x D share of a wgmma accumulator, times
// `mul`, as bf16 pairs through the (b, h, s) strides; rows at or past
// `limit` skipped
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, long long s,
                                          int row0, int limit,
                                          const float (&c)[D / 2], float mul,
                                          int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= limit) continue;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(&base[(long long)row * s + nb * 8 + 2 * t]) =
          pack_bf16(c[4 * nb + 2 * r] * mul, c[4 * nb + 2 * r + 1] * mul);
  }
}

// The producer warp: the CTA's own rows of two operands (maps own0 and
// own1 from row own_row), then n_tiles streamed kWgTile-row tiles of two
// operands (maps t0 and t1 from row tile_row) through the ring; with LSE
// also the tile's rows' lse·log2(e) and delta (+inf and 0 past Sq).
template <int D, bool LSE>
__device__ __forceinline__ void wg_produce(
    uint32_t base, const OperandMaps* own0, const OperandMaps* own1,
    const OperandMaps* t0, const OperandMaps* t1, int own_row, int tile_row,
    int n_tiles, int h, int b, const float* lse_row, const float* dlt_row,
    int Sq, int lane) {
  using Cfg = BwdWg<D>;
  const uint32_t bar = base + Cfg::kBar;
  const uint32_t own_bar = bar + 16 * kWgStages;
  if (n_tiles == 0) return;
  if (lane == 0) {
    mbar_expect_tx(own_bar, Cfg::kOwnTx);
    wg_load_rows<D, kWgRows>(base, own0, own_bar, Cfg::kOwnBlock, own_row, h,
                             b);
    wg_load_rows<D, kWgRows>(base + Cfg::kOwn, own1, own_bar, Cfg::kOwnBlock,
                             own_row, h, b);
    mbar_arrive(own_bar);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kWgStages;
    const uint32_t phase = (it / kWgStages) & 1;
    const int r0 = tile_row + it * kWgTile;
    mbar_wait(bar + 8 * (kWgStages + st), phase ^ 1);   // the stage is free
    const uint32_t full = bar + 8 * st;
    const uint32_t tile = base + Cfg::kRing + st * 2 * Cfg::kTile;
    if (lane == 0) {
      mbar_expect_tx(full, Cfg::kTileTx);
      wg_load_rows<D, kWgTile>(tile, t0, full, Cfg::kTileBlock, r0, h, b);
      wg_load_rows<D, kWgTile>(tile + Cfg::kTile, t1, full, Cfg::kTileBlock,
                               r0, h, b);
    }
    if (LSE) {
      float* vec = reinterpret_cast<float*>(
          __cvta_shared_to_generic(base + Cfg::kVec)) + st * 2 * kWgTile;
#pragma unroll
      for (int r = lane; r < kWgTile; r += 32) {
        const int qi = r0 + r;
        vec[r] = lse_log2(qi < Sq ? lse_row[qi] : 0.f, qi < Sq);
        vec[kWgTile + r] = qi < Sq ? dlt_row[qi] : 0.f;
      }
    }
    mbar_arrive(full);                 // 32 arrivals: lane 0's after its TMA
  }
}

// The barriers of the ring and of the own operands, by thread 0
__device__ __forceinline__ void wg_init_barriers(uint32_t bar) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(bar + 8 * st, 32);
      mbar_init(bar + 8 * (kWgStages + st), kEmptyArrivals);
    }
    mbar_init(bar + 16 * kWgStages, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// pass 1: dq and delta, one CTA per (b·h, 128 q rows).  Q and dO stay in
// shared memory; K and V stream through the ring in 64-row tiles.  Each
// consumer warpgroup owns 64 q rows: S = Q·Kᵀ and dP = dO·Vᵀ (wgmma, both
// operands in shared memory; P is made while dP runs), then dQ += dS·K
// (dS a register operand).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wg_kernel(const __grid_constant__ OperandMaps mq,
                       const __grid_constant__ OperandMaps mk,
                       const __grid_constant__ OperandMaps mv,
                       const __grid_constant__ OperandMaps mdo,
                       const __nv_bfloat16* __restrict__ out,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int H, int Sq,
                       int Skv, Strides so, Strides sdo, Strides sdq,
                       int causal, int window, float cap, float scale,
                       int q_offset) {
  using Cfg = BwdWg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + Cfg::kBar;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_qt = gridDim.y;
  const int qt = causal ? (n_qt - 1 - (int)blockIdx.y) : (int)blockIdx.y;
  const int q0 = qt * kWgRows;         // causal: the last (most work) first
  int k_lo = 0;
  int k_hi = Skv;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  if (causal) k_hi = min(Skv, max(0, q_offset + q0 + kWgRows));
  k_lo = (k_lo / kWgTile) * kWgTile;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kWgTile - 1) / kWgTile : 0;
  wg_init_barriers(bar);

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wg == 0) {                       // the producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 32)
      wg_produce<D, false>(base, &mq, &mdo, &mk, &mv, q0, k_lo, n_tiles, h,
                           b, nullptr, nullptr, Sq, lane);
    return;
  }
  regs_inc<kConsumerRegs>();
  const int w = wg - 1;                // the consumer: q rows q0 + 64w ..
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qa = q0 + 64 * w;
  const int w_row = qa + 16 * warp;    // the warp's first row

  // delta of the consumer's 64 rows: two threads a row, 16-byte loads
  float* s_dlt = reinterpret_cast<float*>(
      __cvta_shared_to_generic(base + Cfg::kVec)) + 64 * w;
  {
    const int r = ct >> 1;
    const int half = ct & 1;
    const int qi = qa + r;
    float acc = 0.f;
    if (qi < Sq) {
      const __nv_bfloat16* o_row =
          out + b * so.b + h * so.h + (long long)qi * so.s + half * (D / 2);
      const __nv_bfloat16* d_row =
          dout + b * sdo.b + h * sdo.h + (long long)qi * sdo.s + half * (D / 2);
      uint4 ov[D / 16], dv[D / 16];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        ov[c] = reinterpret_cast<const uint4*>(o_row)[c];
        dv[c] = reinterpret_cast<const uint4*>(d_row)[c];
      }
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov[c]);
        const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          acc = fmaf(df.x, of.x, acc);
          acc = fmaf(df.y, of.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      s_dlt[r] = acc;
      if (qi < Sq) delta[(long long)bh * Sq + qi] = acc;
    }
  }
  named_sync(1 + w, 128);
  float dlt[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w_row + g + 8 * r;
    dlt[r] = s_dlt[16 * warp + g + 8 * r];
    lse2[r] = lse_log2(qi < Sq ? lse[(long long)bh * Sq + qi] : 0.f, qi < Sq);
  }

  const WgSoft soft(scale, cap);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n_tiles > 0) mbar_wait(bar + 16 * kWgStages, 0);   // Q and dO landed

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kWgStages;
    const int k0 = k_lo + it * kWgTile;
    const uint32_t tile = base + Cfg::kRing + st * 2 * Cfg::kTile;
    mbar_wait(bar + 8 * st, (it / kWgStages) & 1);
    const bool skip = qa >= Sq || (causal && k0 > q_offset + qa + 63)
        || (window > 0 && q_offset + qa - (k0 + kWgTile - 1) >= window);
    if (!skip) {
      float s[kWgTile / 2], dp[kWgTile / 2];
#pragma unroll    // defined before the fence: no definition may sit
                  // between it and the wgmma (ptxas then serialises)
      for (int i = 0; i < kWgTile / 2; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      wg_issue_scores<D>(s, base, tile, w);                      // S = Q·Kᵀ
      wg_issue_scores<D>(dp, base + Cfg::kOwn, tile + Cfg::kTile, w);  // dP
      const bool cut = (k0 + kWgTile > Skv) || (w_row + 16 > Sq)
          || (causal && k0 + kWgTile - 1 > q_offset + w_row)
          || (window > 0 && q_offset + w_row + 15 - k0 >= window);
      wgmma_wait<1>();
      fence_regs(s);
      // s := p·dt, while dP runs
      tile_kind(cap > 0.f, cut, [&](auto c, auto m) {
        wg_p_tile<decltype(c)::value, decltype(m)::value>(
            s, lse2, soft, w_row + g, k0, t, Sq, Skv, q_offset, causal,
            window);
      });
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t da[kWgTile / 16][4];
#pragma unroll
      for (int kq = 0; kq < kWgTile / 16; ++kq) {
        float ds[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 8 * kq + j;
          ds[j] = s[i] * (dp[i] - dlt[(j >> 1) & 1]);
        }
        da[kq][0] = pack_bf16(ds[0], ds[1]);
        da[kq][1] = pack_bf16(ds[2], ds[3]);
        da[kq][2] = pack_bf16(ds[4], ds[5]);
        da[kq][3] = pack_bf16(ds[6], ds[7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < kWgTile / 16; ++kq)             // dQ += dS·K
        wgmma_rs<D>(acc, da[kq], tile, Cfg::kTileBlock, kq);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (kWgStages + st));
  }
  store_acc<D>(dq + b * sdq.b + h * sdq.h, sdq.s, w_row, Sq, acc, scale, g,
               t);
}

// pass 2: dk and dv, one CTA per (b·h, 128 keys).  K and V stay in shared
// memory; Q and dO stream through the ring in kWgTile-row tiles with their
// rows' lse and delta.  Each consumer warpgroup owns 64 keys: Sᵀ = K·Qᵀ
// and dPᵀ = V·dOᵀ (wgmma, both operands in shared memory), then
// dV += Pᵀ·dO, issued while dSᵀ is made, and dK += dSᵀ·Q (Pᵀ and dSᵀ
// register operands).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wg_kernel(const __grid_constant__ OperandMaps mq,
                         const __grid_constant__ OperandMaps mk,
                         const __grid_constant__ OperandMaps mv,
                         const __grid_constant__ OperandMaps mdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Sq,
                         int Skv, Strides sdk, Strides sdv, int causal,
                         int window, float cap, float scale, int q_offset) {
  using Cfg = BwdWg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + Cfg::kBar;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kWgRows;   // key tile 0 (most work) first
  int q_lo = 0;
  int q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, max(0, k0 + kWgRows - 1 + window - q_offset));
  q_lo = (q_lo / kWgTile) * kWgTile;
  const int n_tiles = q_hi > q_lo ? (q_hi - q_lo + kWgTile - 1) / kWgTile : 0;
  wg_init_barriers(bar);

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wg == 0) {                       // the producer warpgroup
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 32)
      wg_produce<D, true>(
          base, &mk, &mv, &mq, &mdo, k0, q_lo, n_tiles, h, b,
          lse + (long long)bh * Sq, delta + (long long)bh * Sq, Sq, lane);
    return;
  }
  regs_inc<kConsumerRegs>();
  const int w = wg - 1;                // the consumer: keys k0 + 64w ..
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ka = k0 + 64 * w;
  const int kw = ka + 16 * warp;       // the warp's first key

  const WgSoft soft(scale, cap);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (n_tiles > 0) mbar_wait(bar + 16 * kWgStages, 0);   // K and V landed

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kWgStages;
    const int q0 = q_lo + it * kWgTile;
    const uint32_t tile = base + Cfg::kRing + st * 2 * Cfg::kTile;
    mbar_wait(bar + 8 * st, (it / kWgStages) & 1);
    const bool skip = ka >= Skv || (causal && ka > q_offset + q0 + kWgTile - 1)
        || (window > 0 && q_offset + q0 - (ka + 63) >= window);
    if (!skip) {
      const uint32_t lse_s = base + Cfg::kVec + st * 2 * kWgTile * 4;
      const uint32_t dlt_s = lse_s + kWgTile * 4;
      float s[kWgTile / 2], dp[kWgTile / 2];
#pragma unroll    // defined before the fence: no definition may sit
                  // between it and the wgmma (ptxas then serialises)
      for (int i = 0; i < kWgTile / 2; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      wg_issue_scores<D>(s, base, tile, w);                      // Sᵀ
      wg_issue_scores<D>(dp, base + Cfg::kOwn, tile + Cfg::kTile, w);  // dPᵀ
      const bool cut = (kw + 16 > Skv) || (q0 + kWgTile > Sq)
          || (causal && kw + 15 > q_offset + q0)
          || (window > 0 && q_offset + q0 + kWgTile - 1 - kw >= window);
      wgmma_wait<1>();
      fence_regs(s);
      // Pᵀ's fragments and s := p·dt, while dPᵀ runs
      uint32_t pa[kWgTile / 16][4];
      tile_kind(cap > 0.f, cut, [&](auto c, auto m) {
        wg_pt_tile<decltype(c)::value, decltype(m)::value>(
            s, pa, lse_s, soft, q0, kw + g, t, Sq, Skv, q_offset, causal,
            window);
      });
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < kWgTile / 16; ++kq)             // dV += Pᵀ·dO
        wgmma_rs<D>(dv_acc, pa[kq], tile + Cfg::kTile, Cfg::kTileBlock,
                    kq);
      wgmma_commit();
      wgmma_wait<1>();                                   // dPᵀ landed
      fence_regs(dp);
      uint32_t da[kWgTile / 16][4];
#pragma unroll
      for (int kq = 0; kq < kWgTile / 16; ++kq) {
        float ds[8];
#pragma unroll
        for (int nb = 2 * kq; nb < 2 * kq + 2; ++nb) {
          const float2 d2 = lds_f2(dlt_s + (8 * nb + 2 * t) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * nb + e;
            ds[i - 8 * kq] = s[i] * (dp[i] - ((e & 1) ? d2.y : d2.x));
          }
        }
        da[kq][0] = pack_bf16(ds[0], ds[1]);
        da[kq][1] = pack_bf16(ds[2], ds[3]);
        da[kq][2] = pack_bf16(ds[4], ds[5]);
        da[kq][3] = pack_bf16(ds[6], ds[7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < kWgTile / 16; ++kq)             // dK += dSᵀ·Q
        wgmma_rs<D>(dk_acc, da[kq], tile, Cfg::kTileBlock, kq);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (kWgStages + st));
  }
  store_acc<D>(dk + b * sdk.b + h * sdk.h, sdk.s, kw, Skv, dk_acc, scale, g,
               t);
  store_acc<D>(dv + b * sdv.b + h * sdv.h, sdv.s, kw, Skv, dv_acc, 1.f, g, t);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, H, Sq, Skv;
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
int launch_wg(const BwdArgs& a, long long bh, int passes, cudaStream_t s) {
  using Bf = __nv_bfloat16;
  constexpr int kBytes = BwdWg<D>::kLaunchBytes;
  static std::atomic<unsigned long long> raised_dq{0}, raised_dkdv{0};
  OperandMaps mq, mk, mv, mdo;
  cudaError_t e = bf16_maps(&mq, a.q, a.B, a.H, a.Sq, D, a.sq);
  if (e == cudaSuccess) e = bf16_maps(&mk, a.k, a.B, a.H, a.Skv, D, a.sk);
  if (e == cudaSuccess) e = bf16_maps(&mv, a.v, a.B, a.H, a.Skv, D, a.sv);
  if (e == cudaSuccess) e = bf16_maps(&mdo, a.dout, a.B, a.H, a.Sq, D, a.sdo);
  if (e != cudaSuccess) return (int)e;
  // the dq pass reads out's rows with 16-byte loads for delta
  if ((uintptr_t)a.out % 16 != 0
      || (a.B > 1 && a.so.b % 8 != 0) || (a.H > 1 && a.so.h % 8 != 0)
      || (a.Sq > 1 && a.so.s % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (passes & 1) {
    const long long n_qt = (a.Sq + kWgRows - 1) / kWgRows;
    if (n_qt > 65535) return (int)cudaErrorInvalidValue;
    auto kernel = flash_bwd_dq_wg_kernel<D>;
    e = raise_smem_limit(kernel, kBytes, raised_dq);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((unsigned)bh, (unsigned)n_qt), kWgThreads, kBytes, s>>>(
        mq, mk, mv, mdo, (const Bf*)a.out, (const Bf*)a.dout, a.lse, a.delta,
        (Bf*)a.dq, a.H, a.Sq, a.Skv, a.so, a.sdo, a.sdq, a.causal, a.window,
        a.cap, a.scale, a.q_offset);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if ((passes & 2) && a.Skv > 0) {
    const long long n_kt = (a.Skv + kWgRows - 1) / kWgRows;
    if (n_kt > 65535) return (int)cudaErrorInvalidValue;
    auto kernel = flash_bwd_dkdv_wg_kernel<D>;
    e = raise_smem_limit(kernel, kBytes, raised_dkdv);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((unsigned)bh, (unsigned)n_kt), kWgThreads, kBytes, s>>>(
        mq, mk, mv, mdo, a.lse, a.delta, (Bf*)a.dk, (Bf*)a.dv, a.H, a.Sq,
        a.Skv, a.sdk, a.sdv, a.causal, a.window, a.cap, a.scale, a.q_offset);
  }
  return (int)cudaGetLastError();
}

// float32 (dtype 0) takes the scalar kernels, bfloat16 (1) the wgmma
// ones; D in {16, 64, 80, 128}
template <int D>
int launch_d(const BwdArgs& a, int tile_bf16, int dtype, long long bh,
             int passes, cudaStream_t s) {
  if (dtype == 1) return launch_wg<D>(a, bh, passes, s);
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
// q, k, v, out and dout then with 16-byte aligned base pointers and
// (b, h, s) strides of whole 16 bytes wherever the dimension has more
// than one index: the TMA tensor maps, which refuse another layout with
// cudaErrorInvalidValue, and the dq pass's 16-byte loads of out).  D in
// {16, 64, 80, 128}.  tile_bf16: the float32 kernels' rounding (the
// bfloat16 ones always round).  passes: 1 the dq pass (with delta), 2 the
// dk/dv pass (reads delta), 3 both in that order.
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
                  dq, dk, dv, B, H, Sq, Skv,
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
