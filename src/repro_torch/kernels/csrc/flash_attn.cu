// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see ../_build.py and ../ops.py).
//
// Replaces the Pallas TPU kernel flash_attention_fwd_pallas of
// repro/kernels/flash_attn_kernel.py (:93; body _flash_fwd_kernel :43)
//   -> flash_attention_fwd_launch.
// For batch b, head h, query row i and key j (same H for q, k and v: the
// caller repeats the kv heads for GQA):
//   s[i, j] = (scale * q[i]) . k[j]             (float32)
//   s       = tanh(s / cap) * cap                (when cap > 0)
//   masked  : k_pos >= Skv (the ragged edge), k_pos > q_pos (causal),
//             q_pos - k_pos >= window (window > 0), with
//             q_pos = q_offset + i and k_pos = j
//   out[i]  = sum_j softmax_j(s[i, :]) v[j]      (online softmax: a
//             running max m, sum l and float32 acc), written as
//             acc / max(l, 1e-30) in the input dtype, so a row with no
//             key left is 0.
// Inputs float32 or bfloat16 (all three alike); the output has q's dtype.
// Every operand is addressed through (b, h, s) element strides with a
// unit stride along D, so the model's (B, S, H, D) tensors are read and
// written as (B, H, S, D) views without a transpose copy.
//
// Bound on this card: operations.  At the serving shape (B 8, H 9,
// S 2000, D 64, causal, bf16) the work is 4·B·H·(S(S+1)/2)·D ≈ 3.7e10
// flops, 0.037 ms at the 989 TFLOP/s of the bf16 tensor cores, while q,
// k, v in and out move 74 MB (0.022 ms at 3.35 TB/s).  This first kernel
// is the simple, exact one: scalar float32 FMAs on the CUDA cores (67
// TFLOP/s peak), so it is bound by its own FMA and shuffle instruction rate,
// far above the tensor-core bound.  What the design does about the
// bound it has:
//   * one CTA per (b·h, 64-row q tile) walks the kv tiles in a loop (the
//     TPU grid's sequential kv axis and its VMEM scratch become a loop
//     and registers); causal and window limits skip the kv tiles that
//     no row of the q tile can see, halving the causal work;
//   * 4 threads per query row split D: each holds D/4 of q (pre-scaled)
//     and D/4 of acc in registers (at D = 128, 32 + 32 floats: a whole
//     row of each would not fit 255 registers), reads its part of a K
//     or V row from shared memory as float4 (the 8 rows of a warp read
//     the same addresses: a broadcast) and sums the dot product with
//     two xor shuffles;
//   * the 32-key K and V tiles are staged in shared memory as float32
//     (bf16 converted once at the load), 32 KB at D = 128;
//   * expf and tanhf, not the fast approximations: the plain version is
//     held to 2e-5 in float32.
// The tensor-core version (mma.sync or wgmma on bf16 tiles, a TMA ring)
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;              // query rows of one CTA
constexpr int kBK = 32;              // keys of one shared-memory tile
constexpr int kLanes = 4;            // threads sharing one query row
constexpr int kThreads = kBQ * kLanes;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int Sq,
                 int Skv, Strides sq, Strides sk, Strides sv, Strides so,
                 int causal, int window, float cap, float scale,
                 int q_offset) {
  static_assert(D % 16 == 0 && D <= 128, "D: a multiple of 16, at most 128");
  constexpr int kV4 = D / 16;        // float4s of a row each thread holds
  __shared__ __align__(16) float k_tile[kBK][D];
  __shared__ __align__(16) float v_tile[kBK][D];

  // the longest causal q tiles first: they set the tail of the grid
  const int n_qt = gridDim.x;
  const int qt = causal ? (n_qt - 1 - (int)blockIdx.x) : (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int q0 = qt * kBQ;
  const int qi = q0 + row;
  const int q_pos = q_offset + qi;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  // this thread's D/4 of the query row: float4 c holds d = 16c + 4·lane ..
  float qr[kV4][4];
  float acc[kV4][4];
#pragma unroll
  for (int c = 0; c < kV4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * c + 4 * lane + e;
      qr[c][e] = qi < Sq ? to_f32(qb[(long long)qi * sq.s + d]) * scale : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  // the kv range any row of this tile can see
  int k_lo = 0;
  int k_hi = Skv;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  if (causal) k_hi = min(Skv, max(0, q_offset + q0 + kBQ));
  k_lo = (k_lo / kBK) * kBK;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();                 // the previous tile is consumed
    for (int t = threadIdx.x; t < kBK * D; t += kThreads) {
      const int j = t / D;
      const int d = t - j * D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < Skv) {
        kx = to_f32(kb[(long long)kp * sk.s + d]);
        vx = to_f32(vb[(long long)kp * sv.s + d]);
      }
      k_tile[j][d] = kx;
      v_tile[j][d] = vx;
    }
    __syncthreads();

    float s[kBK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
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
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);      // 0 on a masked key
      l += p;
#pragma unroll
      for (int c = 0; c < kV4; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&v_tile[j][16 * c + 4 * lane]);
        acc[c][0] = fmaf(p, vv.x, acc[c][0]);
        acc[c][1] = fmaf(p, vv.y, acc[c][1]);
        acc[c][2] = fmaf(p, vv.z, acc[c][2]);
        acc[c][3] = fmaf(p, vv.w, acc[c][3]);
      }
    }
  }

  if (qi >= Sq) return;
  const float den = fmaxf(l, 1e-30f);
  T* ob = out + b * so.b + h * so.h + (long long)qi * so.s;
#pragma unroll
  for (int c = 0; c < kV4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) store(&ob[16 * c + 4 * lane + e], acc[c][e] / den);
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int B, int H, int Sq,
           int Skv, int D, Strides sq, Strides sk, Strides sv, Strides so,
           int causal, int window, float cap, float scale, int q_offset,
           cudaStream_t s) {
  const long long bh = (long long)B * H;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)bh);
  const dim3 block(kThreads);
  switch (D) {
#define FLASH_CASE(DD)                                                        \
  case DD:                                                                    \
    flash_fwd_kernel<T, DD><<<grid, block, 0, s>>>(                           \
        q, k, v, out, H, Sq, Skv, sq, sk, sv, so, causal, window, cap, scale, \
        q_offset);                                                            \
    break;
    FLASH_CASE(16)
    FLASH_CASE(64)
    FLASH_CASE(128)
#undef FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, Sq, D), k and v (B, H, Skv, D), out (B, H, Sq, D), each given
// by its (b, h, s) element strides with a unit stride along D.
// dtype: 0 float32, 1 bfloat16.  D in {16, 64, 128}.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int Sq, int Skv,
                               int D, long long qsb, long long qsh,
                               long long qss, long long ksb, long long ksh,
                               long long kss, long long vsb, long long vsh,
                               long long vss, long long osb, long long osh,
                               long long oss, int causal, int window,
                               float cap, float scale, int q_offset,
                               int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Skv < 0) return (int)cudaErrorInvalidValue;
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss}, sv{vsb, vsh, vss},
      so{osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>((const float*)q, (const float*)k, (const float*)v,
                         (float*)out, B, H, Sq, Skv, D, sq, sk, sv, so,
                         causal, window, cap, scale, q_offset, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, B, H, Sq, Skv, D, sq,
        sk, sv, so, causal, window, cap, scale, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
