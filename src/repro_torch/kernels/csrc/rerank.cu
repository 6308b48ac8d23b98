// Exact set-similarity re-rank for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see ../_build.py and ../ops.py).
//
// Replaces the Pallas TPU kernel exact_rerank_pallas of
// repro/kernels/hamming_kernel.py (:381; body _rerank_kernel :344)
//   -> exact_rerank_launch.
// For query j and column i, over Wp payload words:
//   inter = sum_w popc(q[w, j] & pay[w, i]);  |A| = sum_w popc(q[w, j]);
//   |B| = sum_w popc(pay[w, i]);
//   jaccard     = inter / ((|A| + |B|) - inter)
//   cosine      = inter / sqrt(|A| * |B|)
//   containment = inter / |A|
// in float32, 0.0 on a zero denominator, -1.0 where surv[j, i] == 0.
//
// The int32 bit pattern of the score is the top-k sort key, so every
// float operation is IEEE-rounded with the _rn intrinsics (no fast-math
// division or square root, and no contraction of |A| * |B| into an FMA);
// the counts are integers below 2^24 and exact in float32.
//
// Bound on this card: bytes.  Every (query, column) pair reads one int32
// survivor flag and writes one float32 score; a column's Wp payload
// words are needed only where one of its m lanes survives, and after a
// τ-ladder rung that is a small share of the columns (19,203 lanes of
// 839 M at the segmented Review shape).  So the compulsory bytes are the
// two (m, n) planes, 6.7 GB there, 2.0 ms at 3.35 TB/s.  The design:
//   * a block covers a strip of columns for ALL m queries: the (Wp, m)
//     query words and their counts |A| sit in shared memory (2 KB at Wp
//     8, m 64), loaded in chunks of queries only where Wp * m does not
//     fit;
//   * a thread holds 4 consecutive columns: 16-byte streaming (.cs)
//     loads of the flags and stores of the scores, the flags of 4
//     queries loaded before any is scored, so that enough bytes are in
//     flight; one column a thread where n % 4 != 0 or a pointer is not
//     16-byte aligned;
//   * lazy payloads: a warp loads its columns' payload words and counts
//     |B| at the first survivor among its 128 columns' lanes, at most
//     once (the first 8 words kept in registers, any further ones read
//     again from L1/L2), and never where none of its lanes survives; a
//     load a thread, at each thread's own first survivor, kept the warp
//     waiting on device memory up to 32 times (4.1 against 2.9 ms on an
//     H100 at 1% survivors);
//   * the ragged edge of n is masked here; offsets are int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Metric { kJaccard = 0, kCosine = 1, kContainment = 2 };

constexpr int kThreads = 256;
constexpr int kRegWords = 8;     // payload words a thread keeps in registers
constexpr int kUnroll = 4;       // queries whose flags are loaded together
constexpr int kSmemBytes = 48 * 1024;

template <int VEC>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_flags(const int32_t* p, int (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_scores(float* p,
                                             const float (&x)[VEC]) {
  if constexpr (VEC == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  else
    __stcs(p, x[0]);
}

template <int METRIC>
__device__ __forceinline__ float score_of(int inter, int size_a,
                                          int size_b) {
  const float fi = (float)inter;
  const float fa = (float)size_a;
  const float fb = (float)size_b;
  float den;
  if (METRIC == kJaccard)
    den = __fsub_rn(__fadd_rn(fa, fb), fi);
  else if (METRIC == kCosine)
    den = __fsqrt_rn(__fmul_rn(fa, fb));
  else
    den = fa;
  return den > 0.0f ? __fdiv_rn(fi, den) : 0.0f;
}

template <int METRIC, int VEC>
__global__ void __launch_bounds__(kThreads)
rerank_strip_kernel(const uint32_t* __restrict__ pay,
                    const uint32_t* __restrict__ q,
                    const int32_t* __restrict__ surv,
                    float* __restrict__ out, int64_t n, int m, int Wp,
                    int chunk) {
  extern __shared__ uint32_t smem[];
  uint32_t* q_sh = smem;                                  // [chunk][Wp]
  int* size_a = (int*)(smem + (size_t)chunk * Wp);        // [chunk]
  const int64_t i0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * VEC;
  const bool inside = i0 < n;  // VEC = 4 only where n % 4 == 0

  uint32_t pw[kRegWords][VEC] = {};   // the payload words, once loaded
  int size_b[VEC] = {};
  bool loaded = false;

  for (int c0 = 0; c0 < m; c0 += chunk) {
    const int nc = m - c0 < chunk ? m - c0 : chunk;
    __syncthreads();                 // the previous chunk is scored
    for (int t = threadIdx.x; t < nc * Wp; t += kThreads) {
      const int jj = t / Wp;
      const int w = t - jj * Wp;
      q_sh[t] = __ldg(&q[(int64_t)w * m + c0 + jj]);
    }
    __syncthreads();
    for (int jj = threadIdx.x; jj < nc; jj += kThreads) {
      int a = 0;
      for (int w = 0; w < Wp; ++w) a += __popc(q_sh[jj * Wp + w]);
      size_a[jj] = a;
    }
    __syncthreads();
    if (!inside) continue;

    for (int jj = 0; jj < nc; jj += kUnroll) {
      int flag[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (jj + u < nc) {
          load_flags<VEC>(surv + (int64_t)(c0 + jj + u) * n + i0, flag[u]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) flag[u][k] = 0;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (jj + u >= nc) break;
        bool any = false;
#pragma unroll
        for (int k = 0; k < VEC; ++k) any |= flag[u][k] != 0;
        // the whole warp loads at its first survivor: one wait on device
        // memory a warp, not one a thread
        if (__any_sync(__activemask(), any && !loaded) && !loaded) {
#pragma unroll
          for (int w = 0; w < kRegWords; ++w) {
            if (w < Wp) {
              load_words<VEC>(pay + (int64_t)w * n + i0, pw[w]);
#pragma unroll
              for (int k = 0; k < VEC; ++k) size_b[k] += __popc(pw[w][k]);
            }
          }
          for (int w = kRegWords; w < Wp; ++w) {
            uint32_t x[VEC];
            load_words<VEC>(pay + (int64_t)w * n + i0, x);
#pragma unroll
            for (int k = 0; k < VEC; ++k) size_b[k] += __popc(x[k]);
          }
          loaded = true;
        }
        const uint32_t* qw = q_sh + (jj + u) * Wp;
        float score[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          score[k] = -1.0f;
          if (flag[u][k] != 0) {
            int inter = 0;
#pragma unroll
            for (int w = 0; w < kRegWords; ++w)
              if (w < Wp) inter += __popc(qw[w] & pw[w][k]);
            for (int w = kRegWords; w < Wp; ++w)
              inter += __popc(qw[w] & __ldg(&pay[(int64_t)w * n + i0 + k]));
            score[k] = score_of<METRIC>(inter, size_a[jj + u], size_b[k]);
          }
        }
        store_scores<VEC>(out + (int64_t)(c0 + jj + u) * n + i0, score);
      }
    }
  }
}

template <int METRIC, int VEC>
int launch(const uint32_t* pay, const uint32_t* q, const int32_t* surv,
           float* out, int64_t n, int m, int Wp, cudaStream_t s) {
  // queries a chunk: as many as fit 48 KB of shared memory, at most m
  const int fit = kSmemBytes / (int)((Wp + 1) * sizeof(uint32_t));
  const int chunk = fit < m ? fit : m;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)chunk * (Wp + 1) * sizeof(uint32_t);
  const int64_t per_block = (int64_t)kThreads * VEC;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  rerank_strip_kernel<METRIC, VEC><<<(unsigned)blocks, kThreads, smem, s>>>(
      pay, q, surv, out, n, m, Wp, chunk);
  return (int)cudaGetLastError();
}

template <int METRIC>
int launch_metric(const uint32_t* pay, const uint32_t* q, const int32_t* surv,
                  float* out, int64_t n, int m, int Wp, bool vec,
                  cudaStream_t s) {
  return vec ? launch<METRIC, 4>(pay, q, surv, out, n, m, Wp, s)
             : launch<METRIC, 1>(pay, q, surv, out, n, m, Wp, s);
}

}  // namespace

extern "C" {

// (Wp, n) x (Wp, m) uint32 bitmaps + (m, n) int32 survivor flags ->
// (m, n) float32 scores.  metric: 0 jaccard, 1 cosine, 2 containment.
int exact_rerank_launch(const void* pay, const void* q, const void* surv,
                        void* out, long long n, int m, int Wp, int metric,
                        void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  if (Wp <= 0) return (int)cudaErrorInvalidValue;
  const uint32_t* pp = (const uint32_t*)pay;
  const uint32_t* qp = (const uint32_t*)q;
  const int32_t* sp = (const int32_t*)surv;
  float* op = (float*)out;
  // 16-byte payload words, flags and scores: 4 columns a thread
  const bool vec = n % 4 == 0 && (uintptr_t)pay % 16 == 0
                   && (uintptr_t)surv % 16 == 0 && (uintptr_t)out % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nn = n;
  switch (metric) {
    case kJaccard:
      return launch_metric<kJaccard>(pp, qp, sp, op, nn, m, Wp, vec, s);
    case kCosine:
      return launch_metric<kCosine>(pp, qp, sp, op, nn, m, Wp, vec, s);
    case kContainment:
      return launch_metric<kContainment>(pp, qp, sp, op, nn, m, Wp, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
