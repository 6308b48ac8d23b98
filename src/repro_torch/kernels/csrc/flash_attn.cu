// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see ../_build.py and ../ops.py).
//
// Replaces the Pallas TPU kernel flash_attention_fwd_pallas of
// repro/kernels/flash_attn_kernel.py (:93; body _flash_fwd_kernel :43)
//   -> flash_attention_fwd_launch.
// For batch b, head h, query row i and key j (same H for q, k and v: the
// caller repeats the kv heads for GQA):
//   s[i, j] = scale * (q[i] . k[j])              (float32)
//   s       = tanh(s / cap) * cap                (when cap > 0)
//   masked  : k_pos >= Skv (the ragged edge), k_pos > q_pos (causal),
//             q_pos - k_pos >= window (window > 0), with
//             q_pos = q_offset + i and k_pos = j
//   out[i]  = sum_j softmax_j(s[i, :]) v[j]      (online softmax: a
//             running max m, sum l and float32 acc), written as
//             acc / max(l, 1e-30) in the input dtype, so a row with no
//             key left is 0.
// Inputs float32 or bfloat16 (all three alike); the output has q's dtype.
// With a non-null `lse` (B, H, Sq) float32, each row's log-sum-exp of its
// scaled (and capped) scores is written too, m + log(max(l, 1e-30)) in
// natural-log units, -inf for a row with no visible key (the residual of
// the JAX package's FA-2 backward, repro/models/flash.py:96); the FA-2
// backward (flash_attn_bwd.cu) recomputes P from it.  Whether lse is
// written is a template flag, so a null pointer runs the same code as a
// kernel without it.  `tile_bf16` (the float32 route only) rounds P and V
// to bfloat16 before P·V, as repro/models/flash.py's TILE_DTYPE does; the
// bfloat16 route always rounds P (below).
// Every operand is addressed through (b, h, s) element strides with a
// unit stride along D, so the model's (B, S, H, D) tensors are read and
// written as (B, H, S, D) views without a transpose copy.  Both kernels
// skip the kv tiles that no row of their q tile can see (causal and
// window limits), which halves the causal work, and mask the ragged
// edges of Sq and Skv themselves.
//
// Bound on this card: operations.  At the serving shape (B 8, H 9,
// S 2000, D 64, causal, bf16) the work is 4·B·H·(S(S+1)/2)·D ≈ 3.7e10
// flops, 0.037 ms at the 989 TFLOP/s of the bf16 tensor cores, while q,
// k, v in and out move 74 MB (0.022 ms at 3.35 TB/s).
//
// bfloat16: flash_fwd_tc_kernel, the FA-2 structure on the tensor cores.
//   * One CTA per (b·h, q tile) of 4 warps, each warp owning 16 or 32
//     q rows (1 or 2 m16 tiles, which share every K and V fragment the
//     warp loads from shared memory), chosen by head dim as measured
//     fastest (PERF.md): at D = 64, the serving shape, 32 rows a warp
//     (128 a CTA; 248 registers, no spill); at D = 128, where 32-row
//     warps spill, at D = 80 (hubert-xlarge), where they take 255
//     registers and a stack for at most 6%, and at D = 16, where the
//     two measured alike, 16 (64 a CTA).  D = 80 keeps the 16-byte
//     padding: its 176-byte rows put the 8 rows of an ldmatrix phase
//     in 8 distinct bank groups (11 is odd).  The grid is (b·h, q tiles) with the q tile on the slow
//     axis and reversed when causal, so the CTAs with the most kv tiles
//     are issued first and the short ones fill the tail.
//   * Q (its rows x D) and a 2-stage ring of 64-key K and V tiles come into
//     shared memory by cp.async (16 bytes a thread, rows past Skv
//     zero-filled, so a masked key's V row is 0, never garbage); tile
//     t + 1 loads while tile t computes.  Rows are padded by 16 bytes, so
//     the 8 row addresses of every ldmatrix phase fall in 8 distinct
//     bank groups: no bank conflicts.
//   * Each warp loads its Q fragments once with ldmatrix and keeps them
//     in registers.  S = Q·Kᵀ is mma.sync m16n8k16 (bf16 in, float32
//     sums) with K fragments from ldmatrix; scale, the tanh cap and the
//     masks are applied to the float32 S tile, the masks only on the
//     tiles that the diagonal, the window edge or the ragged Skv cut.
//   * Online softmax per row: the 4 threads of an mma quad hold a row's
//     columns and reduce its max with two xor shuffles; exponentials in
//     base 2 (ex2.approx) on s·log2(e).  The running sum l stays a
//     per-thread partial until the end.
//   * P is rounded to bf16 in registers and fed straight back as the A
//     operand of P·V (the S accumulator layout of two n8 tiles is the A
//     layout of one k16 tile), with V fragments from ldmatrix.trans: no
//     shared-memory round trip.  This rounding is the one numeric
//     difference from the TPU kernel, which keeps P in float32
//     (flash_attn_kernel.py:72-74): a relative error of at most 2^-9 per
//     weight, inside the bf16 tolerance of 2e-2 (the CPU test
//     test_torch_flash.py::test_tc_numerics_match_pallas emulates it).
//   * The output is divided by max(l, 1e-30), staged through the warp's
//     own Q rows in shared memory and stored as 16-byte rows through the
//     (b, h, s) strides.  The wrapper checks that q, k and v have
//     16-byte aligned base pointers and row strides (cp.async needs it).
//
// float32: flash_fwd_f32_kernel, scalar FMAs on the CUDA cores, exact to
// the plain version's 2e-5 (bf16 or TF32 products keep ~3 digits and
// could not meet it).  4 threads per query row split D (a whole row of q
// and acc would not fit 255 registers at D = 128) and sum the dot
// product with two xor shuffles; 32-key K and V tiles in shared memory;
// expf and tanhf.  It is chosen by dtype, not as a fallback: both
// kernels count under flash_attention_fwd.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: scalar kernel on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 64;           // query rows of one CTA
constexpr int kF32BK = 32;           // keys of one shared-memory tile
constexpr int kF32Lanes = 4;         // threads sharing one query row
constexpr int kF32Threads = kF32BQ * kF32Lanes;

template <int D, bool LSE, bool TILE>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Skv,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     int causal, int window, float cap, float scale,
                     int q_offset) {
  static_assert(D % 16 == 0 && D <= 128, "D: a multiple of 16, at most 128");
  constexpr int kV4 = D / 16;        // float4s of a row each thread holds
  __shared__ __align__(16) float k_tile[kF32BK][D];
  __shared__ __align__(16) float v_tile[kF32BK][D];

  // the longest causal q tiles first: they set the tail of the grid
  const int n_qt = gridDim.x;
  const int qt = causal ? (n_qt - 1 - (int)blockIdx.x) : (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = threadIdx.x / kF32Lanes;
  const int lane = threadIdx.x % kF32Lanes;
  const int q0 = qt * kF32BQ;
  const int qi = q0 + row;
  const int q_pos = q_offset + qi;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  // this thread's D/4 of the query row: float4 c holds d = 16c + 4·lane ..
  float qr[kV4][4];
  float acc[kV4][4];
#pragma unroll
  for (int c = 0; c < kV4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * c + 4 * lane + e;
      qr[c][e] = qi < Sq ? qb[(long long)qi * sq.s + d] * scale : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  // the kv range any row of this tile can see
  int k_lo = 0;
  int k_hi = Skv;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  if (causal) k_hi = min(Skv, max(0, q_offset + q0 + kF32BQ));
  k_lo = (k_lo / kF32BK) * kF32BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += kF32BK) {
    __syncthreads();                 // the previous tile is consumed
    for (int t = threadIdx.x; t < kF32BK * D; t += kF32Threads) {
      const int j = t / D;
      const int d = t - j * D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < Skv) {
        kx = kb[(long long)kp * sk.s + d];
        vx = vb[(long long)kp * sv.s + d];
      }
      k_tile[j][d] = kx;
      v_tile[j][d] = vx;
    }
    __syncthreads();

    float s[kF32BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kV4; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&k_tile[j][16 * c + 4 * lane]);
        part = fmaf(qr[c][0], kk.x, part);
        part = fmaf(qr[c][1], kk.y, part);
        part = fmaf(qr[c][2], kk.z, part);
        part = fmaf(qr[c][3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (cap > 0.f) part = tanhf(part / cap) * cap;
      const int kp = k0 + j;
      bool ok = kp < Skv;
      if (causal) ok = ok && q_pos >= kp;
      if (window > 0) ok = ok && (q_pos - kp) < window;
      s[j] = ok ? part : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;          // nothing visible yet
    const float corr = expf(m - m_new);        // 0 while m is -inf
    m = m_new;
    l *= corr;
#pragma unroll
    for (int c = 0; c < kV4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) {
      float p = expf(s[j] - m_new);            // 0 on a masked key
      l += p;
      if (TILE) p = round_bf16(p);
#pragma unroll
      for (int c = 0; c < kV4; ++c) {
        float4 vv =
            *reinterpret_cast<const float4*>(&v_tile[j][16 * c + 4 * lane]);
        if (TILE) {
          vv.x = round_bf16(vv.x);
          vv.y = round_bf16(vv.y);
          vv.z = round_bf16(vv.z);
          vv.w = round_bf16(vv.w);
        }
        acc[c][0] = fmaf(p, vv.x, acc[c][0]);
        acc[c][1] = fmaf(p, vv.y, acc[c][1]);
        acc[c][2] = fmaf(p, vv.z, acc[c][2]);
        acc[c][3] = fmaf(p, vv.w, acc[c][3]);
      }
    }
  }

  if (qi >= Sq) return;
  if (LSE && lane == 0)
    lse[(long long)bh * Sq + qi] =
        m == -INFINITY ? -INFINITY : m + logf(fmaxf(l, 1e-30f));
  const float den = fmaxf(l, 1e-30f);
  float* ob = out + b * so.b + h * so.h + (long long)qi * so.s;
#pragma unroll
  for (int c = 0; c < kV4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ob[16 * c + 4 * lane + e] = acc[c][e] / den;
  }
}

template <int D>
void launch_f32_d(const float* q, const float* k, const float* v, float* out,
                  float* lse, int tile_bf16, dim3 grid, int H, int Sq,
                  int Skv, Strides sq, Strides sk, Strides sv, Strides so,
                  int causal, int window, float cap, float scale,
                  int q_offset, cudaStream_t s) {
#define FLASH_F32_LAUNCH(L, T)                                                \
  flash_fwd_f32_kernel<D, L, T><<<grid, kF32Threads, 0, s>>>(                 \
      q, k, v, out, lse, H, Sq, Skv, sq, sk, sv, so, causal, window, cap,     \
      scale, q_offset)
  if (lse == nullptr && !tile_bf16) FLASH_F32_LAUNCH(false, false);
  else if (!tile_bf16) FLASH_F32_LAUNCH(true, false);
  else if (lse == nullptr) FLASH_F32_LAUNCH(false, true);
  else FLASH_F32_LAUNCH(true, true);
#undef FLASH_F32_LAUNCH
}

int launch_f32(const float* q, const float* k, const float* v, float* out,
               float* lse, int tile_bf16, int B, int H, int Sq, int Skv,
               int D, Strides sq, Strides sk, Strides sv, Strides so,
               int causal, int window, float cap, float scale, int q_offset,
               cudaStream_t s) {
  const long long bh = (long long)B * H;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Sq + kF32BQ - 1) / kF32BQ), (unsigned)bh);
  switch (D) {
#define FLASH_F32_CASE(DD)                                                    \
  case DD:                                                                    \
    launch_f32_d<DD>(q, k, v, out, lse, tile_bf16, grid, H, Sq, Skv, sq, sk,  \
                     sv, so, causal, window, cap, scale, q_offset, s);        \
    break;
    FLASH_F32_CASE(16)
    FLASH_F32_CASE(64)
    FLASH_F32_CASE(80)
    FLASH_F32_CASE(128)
#undef FLASH_F32_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

constexpr int kBK = 64;              // keys of one K / V tile
constexpr int kTcWarps = 4;          // warps of one CTA

// One CTA: kTcWarps warps of 16·MT q rows each (MT m16 tiles a warp,
// which share every K and V fragment they load).  Shared-memory rows of
// D bf16 are padded by 8 elements (16 bytes).
template <int D, int MT>
struct TcCfg {
  static constexpr int kWarpRows = 16 * MT;        // q rows of one warp
  static constexpr int kBQ = kWarpRows * kTcWarps; // q rows of one CTA
  static constexpr int kThreads = 32 * kTcWarps;
  static constexpr int kPitch = D + 8;
  static constexpr int kTile = kBK * kPitch;     // elements of one K or V tile
  static constexpr int kQ = kBQ * kPitch;
  static constexpr int kBytes = (kQ + 4 * kTile) * 2;  // Q, 2 x K, 2 x V
};

template <int D, int MT, bool LSE>
__global__ void __launch_bounds__(32 * kTcWarps, 1)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int H, int Sq, int Skv,
                    Strides sq, Strides sk, Strides sv, Strides so,
                    int causal, int window, float cap, float scale,
                    int q_offset) {
  static_assert(D % 16 == 0 && D <= 128, "D: a multiple of 16, at most 128");
  using Smem = TcCfg<D, MT>;
  constexpr int P = Smem::kPitch;
  constexpr int kBQ = Smem::kBQ;
  constexpr int kWR = Smem::kWarpRows;
  constexpr int kThreads = Smem::kThreads;
  constexpr int kKB = D / 16;        // k16 steps of Q·Kᵀ
  constexpr int kNB = kBK / 8;       // n8 tiles of S
  constexpr int kDB = D / 8;         // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + Smem::kQ;               // 2 stages
  __nv_bfloat16* sV = sK + 2 * Smem::kTile;        // 2 stages

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int n_qt = gridDim.y;
  const int qt = causal ? (n_qt - 1 - (int)blockIdx.y) : (int)blockIdx.y;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;           // row of the quad within 8
  const int t = lane & 3;            // thread of the quad

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  // the kv range any row of this tile can see
  int k_lo = 0;
  int k_hi = Skv;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  if (causal) k_hi = min(Skv, max(0, q_offset + q0 + kBQ));
  k_lo = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  const uint32_t sQa = smem_addr(sQ);
  const uint32_t sKa = smem_addr(sK);
  const uint32_t sVa = smem_addr(sV);
  constexpr uint32_t kTileBytes = Smem::kTile * 2;

  load_tile<D, kThreads, kBQ>(sQa, qb, sq.s, q0, Sq, tid);
  if (n_tiles > 0) {
    load_tile<D, kThreads, kBK>(sKa, kb, sk.s, k_lo, Skv, tid);
    load_tile<D, kThreads, kBK>(sVa, vb, sv.s, k_lo, Skv, tid);
  }
  cp_async_commit();

  // this thread's rows: in m-tile mt, row g (r = 0) and row g + 8 (r = 1)
  // of the warp's 16·mt .. 16·mt + 15
  const int w_row = q0 + warp * kWR;               // first q row of the warp
  const int qp_base = q_offset + w_row + g;        // + 16·mt + 8·r
  const float cap_inv = cap > 0.f ? 1.f / cap : 0.f;
  const float s_mul = scale * kLog2e;              // when cap == 0

  uint32_t qf[MT][kKB][4];
  float o[MT][kDB][4];
  float m_run[MT][2], l_run[MT][2];  // running max (log2 units), partial sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < kDB; ++i)
      o[mt][i][0] = o[mt][i][1] = o[mt][i][2] = o[mt][i][3] = 0.f;
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * kBK;
    if (it + 1 < n_tiles) {          // the next tile into the other stage
      const uint32_t off = ((it + 1) & 1) * kTileBytes;
      load_tile<D, kThreads, kBK>(sKa + off, kb, sk.s, k0 + kBK, Skv, tid);
      load_tile<D, kThreads, kBK>(sVa + off, vb, sv.s, k0 + kBK, Skv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();              // all but the newest group: tile it
    __syncthreads();

    if (it == 0) {                   // Q fragments, once
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < kKB; ++kk)
          ldmatrix_x4(qf[mt][kk],
                      sQa + (uint32_t)(((warp * kWR + mt * 16 + (lane & 15)) * P
                                        + kk * 16 + (lane >> 4) * 8) * 2));
    }
    const uint32_t stage = (it & 1) * kTileBytes;

    // S = Q·Kᵀ: 16·MT rows x 64 keys per warp, each K fragment used MT times
    float s[MT][kNB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < kNB; ++i)
        s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk) {
#pragma unroll
      for (int nb2 = 0; nb2 < kNB / 2; ++nb2) {
        uint32_t kf[4];
        const int key = nb2 * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int d = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(kf, sKa + stage + (uint32_t)((key * P + d) * 2));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * nb2], qf[mt][kk], kf[0], kf[1]);
          mma_bf16(s[mt][2 * nb2 + 1], qf[mt][kk], kf[2], kf[3]);
        }
      }
    }

    // scale and cap in float32, then log2 units for ex2
    if (cap > 0.f) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < kNB; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][i][e] = tanhf(s[mt][i][e] * scale * cap_inv) * cap * kLog2e;
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < kNB; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][i][e] *= s_mul;
    }
    // masks, only where the tile is cut for this warp's rows
    const bool cut = (k0 + kBK > Skv)
        || (causal && k0 + kBK - 1 > q_offset + w_row)
        || (window > 0 && q_offset + w_row + kWR - 1 - k0 >= window);
    if (cut) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < kNB; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + i * 8 + 2 * t + (e & 1);
            const int qp = qp_base + 16 * mt + (e < 2 ? 0 : 8);
            bool ok = kp < Skv;
            if (causal) ok = ok && qp >= kp;
            if (window > 0) ok = ok && (qp - kp) < window;
            if (!ok) s[mt][i][e] = -INFINITY;
          }
        }
      }
    }

    // online softmax per row: the max over the quad, the rescale, P
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_run[mt][r];
#pragma unroll
        for (int i = 0; i < kNB; ++i)
          mx = fmaxf(mx, fmaxf(s[mt][i][2 * r], s[mt][i][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row with nothing visible yet subtracts 0: exp of -inf is 0
        const float ref = mx == -INFINITY ? 0.f : mx;
        const float corr = ex2(m_run[mt][r] - ref);  // 0 while m is -inf
        m_run[mt][r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kNB; ++i) {
          s[mt][i][2 * r] = ex2(s[mt][i][2 * r] - ref);
          s[mt][i][2 * r + 1] = ex2(s[mt][i][2 * r + 1] - ref);
          sum += s[mt][i][2 * r] + s[mt][i][2 * r + 1];
        }
        l_run[mt][r] = l_run[mt][r] * corr + sum;
#pragma unroll
        for (int i = 0; i < kDB; ++i) {
          o[mt][i][2 * r] *= corr;
          o[mt][i][2 * r + 1] *= corr;
        }
      }
    }

    // O += P·V: P from registers (bf16), V fragments by ldmatrix.trans,
    // each V fragment used MT times
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dn2 = 0; dn2 < kDB / 2; ++dn2) {
        uint32_t vf[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int d = dn2 * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(vf, sVa + stage + (uint32_t)((key * P + d) * 2));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dn2], pa[mt], vf[0], vf[1]);
          mma_bf16(o[mt][2 * dn2 + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                 // this stage is free for tile it + 2
  }

  // stage the warp's output rows in its own Q rows, then 16-byte stores
  cp_async_wait<0>();                // no copy into sQ still in flight
  __syncthreads();
  __nv_bfloat16* sO = sQ + warp * kWR * P;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the row sum over the quad, then acc / max(l, 1e-30)
      float l = l_run[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int row = 16 * mt + 8 * r + g;
      if (LSE && t == 0 && w_row + row < Sq) {
        // m_run is in log2 units of the scaled (capped) scores
        const float mx = m_run[mt][r];
        lse[(long long)bh * Sq + w_row + row] =
            mx == -INFINITY ? -INFINITY
                            : (mx + log2f(fmaxf(l, 1e-30f))) * kLn2;
      }
#pragma unroll
      for (int i = 0; i < kDB; ++i)
        *reinterpret_cast<uint32_t*>(&sO[row * P + i * 8 + 2 * t]) =
            pack_bf16(o[mt][i][2 * r] * inv, o[mt][i][2 * r + 1] * inv);
    }
  }
  __syncwarp();
  __nv_bfloat16* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int c = lane; c < kWR * kDB; c += 32) {
    const int r = c / kDB;
    const int ch = c - r * kDB;
    const int qi = w_row + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(&ob[(long long)qi * so.s + ch * 8]) =
          *reinterpret_cast<const uint4*>(&sO[r * P + ch * 8]);
  }
}

template <int D, int MT, bool LSE>
int launch_tc_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                int B, int H, int Sq, int Skv, Strides sq, Strides sk,
                Strides sv, Strides so, int causal, int window, float cap,
                float scale, int q_offset, cudaStream_t s) {
  using Cfg = TcCfg<D, MT>;
  const long long n_qt = (Sq + Cfg::kBQ - 1) / Cfg::kBQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((long long)B * H), (unsigned)n_qt);
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t e =
      raise_smem_limit(flash_fwd_tc_kernel<D, MT, LSE>, Cfg::kBytes, raised);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_tc_kernel<D, MT, LSE><<<grid, Cfg::kThreads, Cfg::kBytes, s>>>(
      q, k, v, out, lse, H, Sq, Skv, sq, sk, sv, so, causal, window, cap,
      scale, q_offset);
  return (int)cudaGetLastError();
}

// the CTA shape by head dim: warps of 32 rows at D = 64, of 16 rows at
// D = 16, 80 and 128; the lse flag from the pointer
template <bool LSE>
int launch_tc_lse(const __nv_bfloat16* q, const __nv_bfloat16* k,
                  const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                  int B, int H, int Sq, int Skv, int D, Strides sq,
                  Strides sk, Strides sv, Strides so, int causal, int window,
                  float cap, float scale, int q_offset, cudaStream_t s) {
  switch (D) {
#define FLASH_TC_CASE(DD, MT)                                                 \
  case DD:                                                                    \
    return launch_tc_d<DD, MT, LSE>(q, k, v, out, lse, B, H, Sq, Skv, sq, sk, \
                                    sv, so, causal, window, cap, scale,       \
                                    q_offset, s);
    FLASH_TC_CASE(16, 1)
    FLASH_TC_CASE(64, 2)
    FLASH_TC_CASE(80, 1)
    FLASH_TC_CASE(128, 1)
#undef FLASH_TC_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch_tc(const __nv_bfloat16* q, const __nv_bfloat16* k,
              const __nv_bfloat16* v, __nv_bfloat16* out, float* lse, int B,
              int H, int Sq, int Skv, int D, Strides sq, Strides sk,
              Strides sv, Strides so, int causal, int window, float cap,
              float scale, int q_offset, cudaStream_t s) {
  if (lse == nullptr)
    return launch_tc_lse<false>(q, k, v, out, lse, B, H, Sq, Skv, D, sq, sk,
                                sv, so, causal, window, cap, scale, q_offset,
                                s);
  return launch_tc_lse<true>(q, k, v, out, lse, B, H, Sq, Skv, D, sq, sk, sv,
                             so, causal, window, cap, scale, q_offset, s);
}

}  // namespace

extern "C" {

// q (B, H, Sq, D), k and v (B, H, Skv, D), out (B, H, Sq, D), each given
// by its (b, h, s) element strides with a unit stride along D.
// dtype: 0 float32 (scalar kernel), 1 bfloat16 (tensor-core kernel; q, k,
// v and out with 16-byte aligned base pointers and strides).  D in
// {16, 64, 80, 128}; any other D returns cudaErrorInvalidValue.  lse:
// null, or a contiguous (B, H, Sq) float32 output.  tile_bf16: 1 rounds P
// and V to bfloat16 for P·V on the float32 route (the bfloat16 route
// always rounds P).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int Sq, int Skv,
                               int D, long long qsb, long long qsh,
                               long long qss, long long ksb, long long ksh,
                               long long kss, long long vsb, long long vsh,
                               long long vss, long long osb, long long osh,
                               long long oss, int causal, int window,
                               float cap, float scale, int q_offset,
                               void* lse, int tile_bf16, int dtype,
                               void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Skv < 0) return (int)cudaErrorInvalidValue;
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss}, sv{vsb, vsh, vss},
      so{osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32((const float*)q, (const float*)k, (const float*)v,
                      (float*)out, (float*)lse, tile_bf16, B, H, Sq, Skv,
                      D, sq, sk, sv, so, causal, window, cap, scale,
                      q_offset, s);
  if (dtype == 1)
    return launch_tc((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                     (const __nv_bfloat16*)v, (__nv_bfloat16*)out,
                     (float*)lse, B, H, Sq, Skv, D, sq, sk, sv, so, causal,
                     window, cap, scale, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
