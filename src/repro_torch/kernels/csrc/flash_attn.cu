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
// bfloat16 (D = 16, 64, 80 and 128): flash_fwd_wg_kernel, FA-3's forward
// structure, warp-specialised for Hopper (primitives in sm90.cuh).
//   * One CTA per (b·h, 128 q rows), three warpgroups.  The grid is
//     launched in groups of heads whose K and V fit in 32 MB of L2
//     together; a group's CTAs go head by head within each q tile, the
//     causal q tiles with the most kv tiles first, so the short ones fill
//     the tail and every K / V tile is read from device memory about once
//     (in (b·h, q tile) order yi-9b's 128 heads of 1 MB each streamed
//     their K and V from device memory for every q tile).
//   * The producer warpgroup (setmaxnreg down to 24 registers): one thread
//     TMA-loads the CTA's Q once, then keeps 128-key K and V tiles in
//     flight, each in a 2-stage ring of its own on full / empty mbarriers
//     (a K tile is freed once its S is done, a V tile once its P·V is).
//     The hardware computes every address; rows past Sq or Skv arrive as
//     zeros, so a masked key's V row is 0, never garbage.
//   * Two consumer warpgroups of 64 q rows each (240 registers), each
//     running FA-3's intra-warpgroup pipeline: S = Q·Kᵀ of tile j (wgmma
//     m64n128k16, both operands in shared memory) and O += P·V of tile
//     j - 1 (P, rounded to bf16 in registers, the A operand; V MN-major
//     from shared memory) are issued as two groups; once S lands, tile j's
//     scale, tanh cap and masks (the masks only on the tiles that the
//     diagonal, the window edge or the ragged Skv cut for the warp's rows:
//     branch-free element loops per tile kind, as the backward's) and its
//     online softmax in base 2 (ex2.approx; each thread's two rows, their
//     max reduced over the 4 threads of a quad) run while the P·V does;
//     then O is rescaled and tile j's P packed.  The two warpgroups take
//     turns issuing their products (named barriers: ping-pong), so that
//     one's exponentials run under the other's products.  Both take every
//     tile of the CTA's kv range, so no wgmma sits on a branch (the masks
//     hide what a row cannot see).
//   * Operands are split where the TMA's swizzle spans end, as in the
//     backward: 64-column blocks of 128-byte rows under the 128-byte
//     swizzle (D = 128 is two) and, at D = 80 (hubert-xlarge, zamba2-2.7b)
//     a 16-column tail of 32-byte rows under the 32-byte swizzle (D = 16 is
//     the tail alone), two tensor maps an operand; S takes four k16 steps
//     a block and one in the tail, O an n64 (n128) over the blocks and an
//     n16 over the tail.
//   * The output is divided by max(l, 1e-30) and stored as bf16 pairs
//     through the (b, h, s) strides; with lse (a template flag) each row's
//     m + log(l) too.
//   * Rounding P to bf16 before P·V is the one numeric difference from the
//     TPU kernel, which keeps P in float32 (flash_attn_kernel.py:72-74): a
//     relative error of at most 2^-9 per weight, inside the bf16 tolerance
//     of 2e-2 (the CPU test test_torch_flash.py::test_tc_numerics_match_
//     pallas emulates it); the row sum l adds the unrounded P.
//   * The wrapper refuses a q, k or v that a tensor map cannot read (a
//     16-byte aligned base and (b, h, s) strides of whole 16 bytes); a
//     launch the card refuses returns its CUDA error.
//   What bounds it now (PERF.md §6): at D 64 a tile's 128 x 128
//   exponentials (MUFU, 16 a clock an SM) take as long as its products,
//   so the two warpgroups' element work is the floor; a CTA's prologue
//   (barriers, Q's load, the first K) and epilogue run alone on its SM
//   (one CTA an SM; persistent CTAs walking a static list of tiles were
//   tried and were slower); at small shapes the wrapper's host time a
//   call (Python and six tensor-map encodes at most) is longer than the
//   kernel.
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

#include <algorithm>
#include <atomic>

#include "sm90.cuh"

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
// bfloat16: warp-specialised wgmma kernel (TMA, mbarriers, setmaxnreg)
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 384;     // a producer warpgroup, two consumers
constexpr int kFwdRows = 128;        // q rows of a CTA, 64 a consumer
constexpr int kFwdStages = 2;        // the ring of K / V tiles
constexpr int kFwdProducerRegs = 24; // 128 x 24 + 256 x 240 <= 65,536
constexpr int kFwdConsumerRegs = 240;
constexpr int kFwdEmptyArrivals = 8; // one a consumer warp
// The L2 bytes the launch order lets the K and V of the heads running at
// once take (of the H100's 50 MB): a group of heads whose K and V fit
// there has every q tile launched before the next group's, so each K / V
// tile is read from device memory about once, not once a q tile
constexpr long long kFwdL2Bytes = 32ll << 20;

// Shared memory, from a 1024-byte aligned base: Q (kFwdRows rows), then a
// ring of kFwdStages (K, V) pairs of kN-key tiles; each operand is D / 64
// swizzled blocks of 64 columns (128-byte rows) and, where D % 64 = 16, a
// tail of the last 16 columns (32-byte rows), as the backward's (sm90.cuh);
// then the mbarriers: K's full[stage] and empty[stage], V's full[stage]
// and empty[stage] (K and V are released apart: a K tile once its S is
// done, a V tile a tile later, once its P·V is), and Q's.  Every block
// and tail starts 1024-byte aligned.
template <int D>
struct FwdWg {
  static_assert(D == 16 || D == 64 || D == 80 || D == 128,
                "the wgmma kernel takes D 16, 64, 80 and 128");
  static constexpr int kN = 128;                              // keys a tile
  static constexpr int kBlocks = D / 64;
  static constexpr int kTail = D % 64;                        // 0 or 16
  static constexpr uint32_t kQBlock = kFwdRows * 128;
  static constexpr uint32_t kQ = kBlocks * kQBlock + kFwdRows * kTail * 2;
  static constexpr uint32_t kTileBlock = kN * 128;
  static constexpr uint32_t kTile = kBlocks * kTileBlock + kN * kTail * 2;
  static constexpr uint32_t kBar = kQ + kFwdStages * 2 * kTile;
  static constexpr uint32_t kBytes = kBar + (4 * kFwdStages + 1) * 8;
  static constexpr int kLaunchBytes = (int)kBytes + 1024;   // + alignment
  static constexpr uint32_t kQTx = kFwdRows * D * 2;        // bytes by TMA
  static constexpr uint32_t kTileTx = kN * D * 2;           // K or V
  static_assert(kTail == 0 || kTail == 16, "a tail is 16 columns");
  static_assert(kQ % 1024 == 0 && kTile % 1024 == 0, "1024-byte tiles");
};

// One kv tile's online softmax over a consumer thread's two rows (q
// positions qp and qp + 8, keys k0 + column): s, the raw scores q·k,
// becomes P (float32); the running max m (log2 units of the scaled,
// capped scores) and the thread's partial sum l are updated, and corr is
// what O's rows are to be multiplied by before this tile's P·V is added.
// CAP and MASK are the tile's, so the loops carry no branch.
template <int N, bool CAP, bool MASK>
__device__ __forceinline__ void fwd_softmax(
    float (&s)[N / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    const WgSoft& k, int qp, int k0, int t, int Skv, int causal,
    int window) {
  const float mul = CAP ? 1.f : k.sl;     // s · mul is in log2 units
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i];
    if (CAP) x = tanhf(x * k.sc) * k.cl;
    if (MASK) {
      const int kp = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const int qr = qp + 8 * r;
      bool ok = kp < Skv;
      if (causal) ok = ok && qr >= kp;
      if (window > 0) ok = ok && qr - kp < window;
      x = ok ? x : -INFINITY;
    }
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {           // the row's max over the quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * mul);
    // a row with nothing visible yet subtracts 0: 2^-inf is 0
    const float ref = m_new == -INFINITY ? 0.f : m_new;
    corr[r] = ex2(m[r] - ref);             // 0 while m is -inf
    m[r] = m_new;
    neg[r] = -ref;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], mul, neg[r]));
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// o's rows times corr, then P (s) as bf16 fragments: the A operand of
// the next P·V
template <int N, int D>
__device__ __forceinline__ void fwd_rescale_pack(float (&o)[D / 2],
                                                 const float (&corr)[2],
                                                 const float (&s)[N / 2],
                                                 uint32_t (&pa)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
  for (int kq = 0; kq < N / 16; ++kq) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kq][j] = pack_bf16(s[8 * kq + 2 * j], s[8 * kq + 2 * j + 1]);
  }
}

// One CTA per (b·h, kFwdRows q rows): the producer warpgroup's first
// thread TMA-loads Q, then streams K and V tiles through their rings;
// each consumer warpgroup owns 64 q rows and runs FA-3's intra-warpgroup
// pipeline: S = Q·Kᵀ of tile j (wgmma, both operands in shared memory)
// and O += P·V of tile j - 1 (P a bf16 register operand, V MN-major in
// shared memory) are issued together, tile j's softmax runs while the
// P·V does, and O is rescaled once that P·V has landed.  Both warpgroups
// take every tile of the CTA's range (the masks hide what a row cannot
// see), so no wgmma sits on a branch of its own.
template <int D, bool LSE>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wg_kernel(const __grid_constant__ OperandMaps mq,
                    const __grid_constant__ OperandMaps mk,
                    const __grid_constant__ OperandMaps mv,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int H, int Sq, int Skv,
                    Strides so, int causal, int window, float cap,
                    float scale, int q_offset, int n_qt, int group) {
  using Cfg = FwdWg<D>;
  constexpr int kN = Cfg::kN;
  constexpr int kS = kFwdStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full_k = base + Cfg::kBar;       // then empty_k, full_v,
  const uint32_t empty_k = full_k + 8 * kS;       // empty_v: kS each
  const uint32_t full_v = full_k + 16 * kS;
  const uint32_t empty_v = full_k + 24 * kS;
  const uint32_t q_bar = full_k + 32 * kS;

  // the launch order: groups of `group` heads (b·h) whose K and V fit in
  // L2 together; in a group every q tile of its heads, heads fastest and
  // the causal q tiles with the most kv tiles first, so the grid does not
  // end in a tail of long CTAs
  const int per_group = n_qt * group;
  const int grp = (int)blockIdx.x / per_group;
  const int rem = (int)blockIdx.x - grp * per_group;
  const int heads = min(group, (int)gridDim.x / n_qt - grp * group);
  const int qi = rem / heads;
  const int bh = grp * group + (rem - qi * heads);
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = causal ? n_qt - 1 - qi : qi;
  const int q0 = qt * kFwdRows;
  // the kv tiles any row of this CTA can see
  int k_lo = 0;
  int k_hi = Skv;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  if (causal) k_hi = min(Skv, max(0, q_offset + q0 + kFwdRows));
  k_lo = (k_lo / kN) * kN;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kN - 1) / kN : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(empty_k + 8 * st, kFwdEmptyArrivals);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty_v + 8 * st, kFwdEmptyArrivals);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {                       // the producer warpgroup
    regs_dec<kFwdProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(q_bar, Cfg::kQTx);
      wg_load_rows<D, kFwdRows>(base, &mq, q_bar, Cfg::kQBlock, q0, h, b);
      mbar_arrive(q_bar);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kS;
        const uint32_t free_ph = ((it / kS) & 1) ^ 1;
        const int k0 = k_lo + it * kN;
        const uint32_t tile = base + Cfg::kQ + st * 2 * Cfg::kTile;
        mbar_wait(empty_k + 8 * st, free_ph);             // K's slot free
        mbar_expect_tx(full_k + 8 * st, Cfg::kTileTx);
        wg_load_rows<D, kN>(tile, &mk, full_k + 8 * st, Cfg::kTileBlock, k0,
                            h, b);
        mbar_arrive(full_k + 8 * st);
        mbar_wait(empty_v + 8 * st, free_ph);             // V's slot free
        mbar_expect_tx(full_v + 8 * st, Cfg::kTileTx);
        wg_load_rows<D, kN>(tile + Cfg::kTile, &mv, full_v + 8 * st,
                            Cfg::kTileBlock, k0, h, b);
        mbar_arrive(full_v + 8 * st);
      }
    }
    return;
  }
  regs_inc<kFwdConsumerRegs>();
  const int w = wg - 1;                // the consumer: q rows q0 + 64w ..
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct >> 5;
  const int lane = ct & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w_row = q0 + 64 * w + 16 * warp;    // the warp's first row
  const int qp = q_offset + w_row + g;          // this thread's first row
  const WgSoft soft(scale, cap);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // S of tile `it` into s, issued as one wgmma group once its K landed
  auto issue_s = [&](float (&s)[kN / 2], int it) {
    const int st = it % kS;
    mbar_wait(full_k + 8 * st, (it / kS) & 1);
#pragma unroll    // defined before the fence: no definition may sit
                  // between it and the wgmma (ptxas then serialises)
    for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
    wgmma_fence();
    const uint32_t tile = base + Cfg::kQ + st * 2 * Cfg::kTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(s, desc_k<D>(base, Cfg::kQBlock, 64 * w, kk),
                    desc_k<D>(tile, Cfg::kTileBlock, 0, kk), kk > 0);
    wgmma_commit();
  };
  // O += P·V of tile `it` (P in pa), issued as one group once its V landed
  auto issue_pv = [&](const uint32_t (&pa)[kN / 16][4], int it) {
    const int st = it % kS;
    mbar_wait(full_v + 8 * st, (it / kS) & 1);
    wgmma_fence();
    const uint32_t tile = base + Cfg::kQ + st * 2 * Cfg::kTile + Cfg::kTile;
#pragma unroll
    for (int kq = 0; kq < kN / 16; ++kq)
      wgmma_rs<D>(o, pa[kq], tile, Cfg::kTileBlock, kq);
    wgmma_commit();
  };
  auto release = [&](uint32_t empty, int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % kS));
  };
  // tile `it`'s softmax over s, by the kind of tile it is for this warp
  auto softmax = [&](float (&s)[kN / 2], float (&corr)[2], int it) {
    const int k0 = k_lo + it * kN;
    const bool cut = (k0 + kN > Skv)
        || (causal && k0 + kN - 1 > q_offset + w_row)
        || (window > 0 && q_offset + w_row + 15 - k0 >= window);
    tile_kind(cap > 0.f, cut, [&](auto c, auto m) {
      fwd_softmax<kN, decltype(c)::value, decltype(m)::value>(
          s, m_run, l_run, corr, soft, qp, k0, t, Skv, causal, window);
    });
  };

  // The consumers take turns issuing their products (ping-pong), so that
  // one's softmax runs while the other's products do: a consumer's turn
  // waits at its own named barrier (1 + w) for the other's arrival there.
  // Consumer 1 lets consumer 0 go first, and skips its last arrival,
  // which no turn of consumer 0 would take.
  auto turn = [&]() { named_sync(1 + w, 256); };
  auto turn_done = [&](bool last) {
    if (!(last && w == 1)) named_arrive(2 - w, 256);
  };

  if (n_tiles > 0) {
    mbar_wait(q_bar, 0);               // Q landed
    if (w == 1) named_arrive(1, 256);
    uint32_t pa[kN / 16][4];
    {                                  // tile 0: S, its softmax, P
      float s[kN / 2], corr[2];
      turn();
      issue_s(s, 0);
      turn_done(false);
      wgmma_wait<0>();
      fence_regs(s);
      release(empty_k, 0);
      softmax(s, corr, 0);
      fwd_rescale_pack<kN, D>(o, corr, s, pa);
    }
    for (int it = 1; it < n_tiles; ++it) {
      float s[kN / 2], corr[2];
      turn();
      issue_s(s, it);                  // S of this tile
      issue_pv(pa, it - 1);            // P·V of the last one
      turn_done(false);
      wgmma_wait<1>();                 // S landed
      fence_regs(s);
      release(empty_k, it);
      softmax(s, corr, it);            // while P·V runs
      wgmma_wait<0>();
      fence_regs(o);
      release(empty_v, it - 1);
      fwd_rescale_pack<kN, D>(o, corr, s, pa);
    }
    turn();
    issue_pv(pa, n_tiles - 1);         // the last tile's P·V
    turn_done(true);
    wgmma_wait<0>();
    fence_regs(o);
  }

  // the row sums over the quad; O / max(l, 1e-30) and the lse
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
    const int row = w_row + g + 8 * r;
    if (LSE && t == 0 && row < Sq)     // m_run is in log2 units
      lse[(long long)bh * Sq + row] =
          m_run[r] == -INFINITY ? -INFINITY
                                : (m_run[r] + log2f(fmaxf(l, 1e-30f))) * kLn2;
  }
  __nv_bfloat16* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w_row + g + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(&ob[(long long)row * so.s + nb * 8 + 2 * t]) =
          pack_bf16(o[4 * nb + 2 * r] * inv[r], o[4 * nb + 2 * r + 1] * inv[r]);
  }
}

template <int D, bool LSE>
int launch_wg_lse(const OperandMaps& mq, const OperandMaps& mk,
                  const OperandMaps& mv, __nv_bfloat16* out, float* lse,
                  int B, int H, int Sq, int Skv, Strides so, int causal,
                  int window, float cap, float scale, int q_offset,
                  cudaStream_t s) {
  constexpr int kBytes = FwdWg<D>::kLaunchBytes;
  static std::atomic<unsigned long long> raised{0};
  const long long n_qt = (Sq + kFwdRows - 1) / kFwdRows;
  const long long bh = (long long)B * H;
  if (n_qt * bh > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  // the fewest groups of heads whose K and V fit in kFwdL2Bytes, of equal
  // size (a small last group would start its longest CTAs at the end)
  const long long head_bytes = 4ll * Skv * D;        // one head's K and V
  const long long fit = std::max(1ll, kFwdL2Bytes / std::max(head_bytes, 1ll));
  const long long n_groups = (bh + fit - 1) / fit;
  const int group = (int)((bh + n_groups - 1) / n_groups);
  auto kernel = flash_fwd_wg_kernel<D, LSE>;
  const cudaError_t e = raise_smem_limit(kernel, kBytes, raised);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(n_qt * bh), kFwdThreads, kBytes, s>>>(
      mq, mk, mv, out, lse, H, Sq, Skv, so, causal, window, cap, scale,
      q_offset, (int)n_qt, group);
  return (int)cudaGetLastError();
}

// q, k and v through their tensor maps (a 16-byte aligned base and
// (b, h, s) strides of whole 16 bytes, else cudaErrorInvalidValue); out
// with a 16-byte aligned base and strides too; the lse flag from the
// pointer
template <int D>
int launch_wg(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int H, int Sq, int Skv, Strides sq,
              Strides sk, Strides sv, Strides so, int causal, int window,
              float cap, float scale, int q_offset, cudaStream_t s) {
  OperandMaps mq, mk, mv;
  cudaError_t e = bf16_maps(&mq, q, B, H, Sq, D, sq);
  if (e == cudaSuccess) e = bf16_maps(&mk, k, B, H, Skv, D, sk);
  if (e == cudaSuccess) e = bf16_maps(&mv, v, B, H, Skv, D, sv);
  if (e != cudaSuccess) return (int)e;
  if ((uintptr_t)out % 16 != 0 || (B > 1 && so.b % 8 != 0)
      || (H > 1 && so.h % 8 != 0) || (Sq > 1 && so.s % 8 != 0))
    return (int)cudaErrorInvalidValue;
  auto* o = (__nv_bfloat16*)out;
  if (lse == nullptr)
    return launch_wg_lse<D, false>(mq, mk, mv, o, lse, B, H, Sq, Skv, so,
                                   causal, window, cap, scale, q_offset, s);
  return launch_wg_lse<D, true>(mq, mk, mv, o, lse, B, H, Sq, Skv, so,
                                causal, window, cap, scale, q_offset, s);
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int H, int Sq, int Skv, int D,
                Strides sq, Strides sk, Strides sv, Strides so, int causal,
                int window, float cap, float scale, int q_offset,
                cudaStream_t s) {
  switch (D) {
#define FLASH_WG_CASE(DD)                                                     \
  case DD:                                                                    \
    return launch_wg<DD>(q, k, v, out, lse, B, H, Sq, Skv, sq, sk, sv, so,    \
                         causal, window, cap, scale, q_offset, s);
    FLASH_WG_CASE(16)
    FLASH_WG_CASE(64)
    FLASH_WG_CASE(80)
    FLASH_WG_CASE(128)
#undef FLASH_WG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, H, Sq, D), k and v (B, H, Skv, D), out (B, H, Sq, D), each given
// by its (b, h, s) element strides with a unit stride along D.
// dtype: 0 float32 (scalar kernel), 1 bfloat16 (the wgmma kernel; q, k,
// v and out with 16-byte aligned base pointers and (b, h, s) strides of
// whole 16 bytes wherever the dimension has more than one index: the TMA
// tensor maps, which refuse another layout with cudaErrorInvalidValue).  D in
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
    return launch_bf16(q, k, v, out, (float*)lse, B, H, Sq, Skv, D, sq, sk,
                       sv, so, causal, window, cap, scale, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
