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
// survivor flag and writes one float32 score, for ~3 Wp integer ops; the
// (Wp, n) payload stream is 1/m of the planes per query.  The design:
//   * one thread per column, threads contiguous along n: the payload
//     words and the (m, n) rows coalesce;
//   * the query tile's Wp * TM words and its TM counts |A| in shared
//     memory (broadcast reads); |B| is counted once per column;
//   * TM intersection counters in registers; the ragged edges of n and
//     m are masked here; offsets are int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Metric { kJaccard = 0, kCosine = 1, kContainment = 2 };

template <int TM, int METRIC>
__global__ void rerank_kernel(const uint32_t* __restrict__ pay,
                              const uint32_t* __restrict__ q,
                              const int32_t* __restrict__ surv,
                              float* __restrict__ out, int64_t n, int m,
                              int Wp) {
  extern __shared__ uint32_t q_tile[];  // [Wp][TM]
  __shared__ int size_a[TM];
  const int j0 = blockIdx.y * TM;
  for (int t = threadIdx.x; t < Wp * TM; t += blockDim.x) {
    const int jj = t % TM;
    const int w = t / TM;
    const int j = j0 + jj;
    q_tile[t] = (j < m) ? q[(int64_t)w * m + j] : 0u;
  }
  __syncthreads();
  if (threadIdx.x < TM) {
    int a = 0;
    for (int w = 0; w < Wp; ++w) a += __popc(q_tile[w * TM + threadIdx.x]);
    size_a[threadIdx.x] = a;
  }
  __syncthreads();

  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  int inter[TM];
#pragma unroll
  for (int jj = 0; jj < TM; ++jj) inter[jj] = 0;
  int size_b = 0;
  for (int w = 0; w < Wp; ++w) {
    const uint32_t x = __ldg(&pay[(int64_t)w * n + i]);
    size_b += __popc(x);
    const uint32_t* qw = &q_tile[w * TM];
#pragma unroll
    for (int jj = 0; jj < TM; ++jj) inter[jj] += __popc(x & qw[jj]);
  }

  const float fb = (float)size_b;
#pragma unroll
  for (int jj = 0; jj < TM; ++jj) {
    const int j = j0 + jj;
    if (j >= m) break;
    const int64_t off = (int64_t)j * n + i;
    float score = -1.0f;
    if (__ldg(&surv[off]) != 0) {
      const float fi = (float)inter[jj];
      const float fa = (float)size_a[jj];
      float den;
      if (METRIC == kJaccard)
        den = __fsub_rn(__fadd_rn(fa, fb), fi);
      else if (METRIC == kCosine)
        den = __fsqrt_rn(__fmul_rn(fa, fb));
      else
        den = fa;
      score = den > 0.0f ? __fdiv_rn(fi, den) : 0.0f;
    }
    out[off] = score;
  }
}

template <int METRIC>
int launch(const uint32_t* pay, const uint32_t* q, const int32_t* surv,
           float* out, long long n, int m, int Wp, int tile_m, int block_n,
           cudaStream_t s) {
  const dim3 block(block_n);
  const dim3 grid((unsigned)((n + block_n - 1) / block_n),
                  (unsigned)((m + tile_m - 1) / tile_m));
  const size_t smem = (size_t)Wp * tile_m * sizeof(uint32_t);
  if (grid.y > 65535u || smem > 48u * 1024u) return (int)cudaErrorInvalidValue;
  switch (tile_m) {
#define RERANK_CASE(TM)                                                       \
  case TM:                                                                    \
    rerank_kernel<TM, METRIC><<<grid, block, smem, s>>>(pay, q, surv, out,    \
                                                        (int64_t)n, m, Wp);   \
    break;
    RERANK_CASE(1)
    RERANK_CASE(2)
    RERANK_CASE(4)
    RERANK_CASE(8)
    RERANK_CASE(16)
    RERANK_CASE(32)
#undef RERANK_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (Wp, n) x (Wp, m) uint32 bitmaps + (m, n) int32 survivor flags ->
// (m, n) float32 scores.  metric: 0 jaccard, 1 cosine, 2 containment.
int exact_rerank_launch(const void* pay, const void* q, const void* surv,
                        void* out, long long n, int m, int Wp, int metric,
                        int tile_m, int block_n, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  if (Wp <= 0 || block_n < 32 || block_n > 1024 || block_n % 32)
    return (int)cudaErrorInvalidValue;
  const uint32_t* pp = (const uint32_t*)pay;
  const uint32_t* qp = (const uint32_t*)q;
  const int32_t* sp = (const int32_t*)surv;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (metric) {
    case kJaccard:
      return launch<kJaccard>(pp, qp, sp, op, n, m, Wp, tile_m, block_n, s);
    case kCosine:
      return launch<kCosine>(pp, qp, sp, op, n, m, Wp, tile_m, block_n, s);
    case kContainment:
      return launch<kContainment>(pp, qp, sp, op, n, m, Wp, tile_m, block_n,
                                  s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
