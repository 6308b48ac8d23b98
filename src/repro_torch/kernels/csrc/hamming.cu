// Vertical-format Hamming scans for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see ../_build.py and ../ops.py).
//
// Replaces two Pallas TPU kernels of repro/kernels/hamming_kernel.py:
//   * hamming_distances_pallas   (:70, body _hamming_kernel :64)
//       -> hamming_distances_launch
//   * sparse_verify_batch_pallas (:114, body _verify_batch_kernel :100;
//     its m=1 case sparse_verify_pallas :156)
//       -> sparse_verify_batch_launch
// Both share the tile _tile_distances (:49):
//   d[j, i] = sum_w popc( OR_p db[p, w, i] ^ q[p, w, j] ).
//
// Bound on this card: bytes.  The work is a few integer ops per output
// element, while every (query j, column i) pair writes one int32 (the
// distance scan) or reads one int32 base and writes two (the verify).
// At the main path's shapes the (m, n) planes are ~30x the (b, W, n)
// database stream, so the design keeps the output stores coalesced and
// reads each database word once per query tile:
//   * one thread per database column i, threads contiguous along n, so
//     the lane-major (b, W, n) words and the (m, n) rows coalesce;
//   * a query tile of TM queries per block, its b*W*TM words staged in
//     shared memory (every thread reads the same word: a broadcast);
//   * TM accumulators in registers; the ragged edges of n and m are
//     masked here, so the caller pads nothing;
//   * b, W and tau are runtime arguments; output offsets are int64
//     (m * n passes 2^31 at the shapes the search serves).
// The arena verify, which gathers its base through a segment-offset
// lane, is the slab pass of arena.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;  // distance sentinel of pruned lanes

// What the tile does with its distances.
enum Mode { kDistances = 0, kVerify = 1 };

template <int TM, int MODE>
__global__ void hamming_tile_kernel(const uint32_t* __restrict__ db,
                                    const uint32_t* __restrict__ q,
                                    const int32_t* __restrict__ base,
                                    int32_t* __restrict__ out0,
                                    int32_t* __restrict__ out1,
                                    int64_t n, int m, int b, int W, int tau) {
  extern __shared__ uint32_t q_tile[];  // [b * W][TM]
  const int j0 = blockIdx.y * TM;
  const int words = b * W;
  for (int t = threadIdx.x; t < words * TM; t += blockDim.x) {
    const int jj = t % TM;
    const int pw = t / TM;
    const int j = j0 + jj;
    q_tile[t] = (j < m) ? q[(int64_t)pw * m + j] : 0u;
  }
  __syncthreads();

  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  int d[TM];
#pragma unroll
  for (int jj = 0; jj < TM; ++jj) d[jj] = 0;
  for (int w = 0; w < W; ++w) {
    uint32_t acc[TM];
#pragma unroll
    for (int jj = 0; jj < TM; ++jj) acc[jj] = 0u;
    for (int p = 0; p < b; ++p) {
      const uint32_t x = __ldg(&db[((int64_t)p * W + w) * n + i]);
      const uint32_t* qp = &q_tile[(p * W + w) * TM];
#pragma unroll
      for (int jj = 0; jj < TM; ++jj) acc[jj] |= x ^ qp[jj];
    }
#pragma unroll
    for (int jj = 0; jj < TM; ++jj) d[jj] += __popc(acc[jj]);
  }

#pragma unroll
  for (int jj = 0; jj < TM; ++jj) {
    const int j = j0 + jj;
    if (j >= m) break;
    const int64_t off = (int64_t)j * n + i;
    if (MODE == kDistances) {
      out0[off] = d[jj];
    } else {
      const int bj = __ldg(&base[off]);
      // wrapping add, as the int32 sum of the reference
      const int total = (int)((uint32_t)d[jj] + (uint32_t)bj);
      out0[off] = total <= tau ? 1 : 0;
      out1[off] = total < kBig ? total : kBig;
    }
  }
}

template <int MODE>
int launch(const void* db, const void* q, const void* base, void* out0,
           void* out1, long long n, int m, int b, int W, int tau, int tile_m,
           int block_n, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  if (b <= 0 || W <= 0 || block_n <= 0 || block_n > 1024 || block_n % 32)
    return (int)cudaErrorInvalidValue;
  const dim3 block(block_n);
  const dim3 grid((unsigned)((n + block_n - 1) / block_n),
                  (unsigned)((m + tile_m - 1) / tile_m));
  const size_t smem = (size_t)b * W * tile_m * sizeof(uint32_t);
  if (grid.y > 65535u || smem > 48u * 1024u) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* dbp = (const uint32_t*)db;
  const uint32_t* qp = (const uint32_t*)q;
  const int32_t* bp = (const int32_t*)base;
  int32_t* o0 = (int32_t*)out0;
  int32_t* o1 = (int32_t*)out1;
  switch (tile_m) {
#define HAMMING_CASE(TM)                                                      \
  case TM:                                                                    \
    hamming_tile_kernel<TM, MODE><<<grid, block, smem, s>>>(                  \
        dbp, qp, bp, o0, o1, (int64_t)n, m, b, W, tau);                       \
    break;
    HAMMING_CASE(1)
    HAMMING_CASE(2)
    HAMMING_CASE(4)
    HAMMING_CASE(8)
    HAMMING_CASE(16)
    HAMMING_CASE(32)
#undef HAMMING_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (b, W, n) x (b, W, m) uint32 -> (m, n) int32 distances.
int hamming_distances_launch(const void* db, const void* q, void* out,
                             long long n, int m, int b, int W, int tile_m,
                             int block_n, void* stream) {
  return launch<kDistances>(db, q, nullptr, out, nullptr, n, m, b, W, 0,
                            tile_m, block_n, stream);
}

// (b, W, n) x (b, W, m) uint32 + (m, n) int32 base -> (m, n) int32 mask
// (base + d <= tau) and (m, n) int32 min(base + d, BIG).
int sparse_verify_batch_launch(const void* db, const void* q,
                               const void* base, void* mask, void* dist,
                               long long n, int m, int b, int W, int tau,
                               int tile_m, int block_n, void* stream) {
  return launch<kVerify>(db, q, base, mask, dist, n, m, b, W, tau, tile_m,
                         block_n, stream);
}

const char* hamming_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
