// Vertical-format Hamming scans for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see ../_build.py and ../ops.py).
//
// Replaces two Pallas TPU kernels of repro/kernels/hamming_kernel.py:
//   * hamming_distances_pallas   (:70, body _hamming_kernel :64)
//       -> hamming_distances_batched_launch
//   * sparse_verify_batch_pallas (:114, body _verify_batch_kernel :100;
//     its m=1 case sparse_verify_pallas :156)
//       -> sparse_verify_batch_batched_launch
// Both share the tile _tile_distances (:49):
//   d[j, i] = sum_w popc( OR_p db[p, w, i] ^ q[p, w, j] ).
// The JAX package also reaches both under jax.vmap, which adds a grid
// axis: the MI-bST candidate verify vmaps the scan over queries
// (repro/core/multi_index.py:167-169) and the sharded bST vmaps the
// verify over shards (repro/core/distributed_search.py:471).  Here that
// axis is grid.z: every operand takes a batch stride in elements, and a
// stride of 0 shares an operand across the batch (the query planes of
// the sharded scan).  The unbatched wrappers of ../ops.py call the same
// two entries with batch = 1, which launches the kernel specialised
// without the batch offsets (BATCH = false): with them the verify's
// 8-query tile takes 40 registers instead of 32 (6 blocks of 256 an SM
// instead of 8) and ran 4.51 against 4.30 ms queued at the static Review
// shape on an H100 (tools/bench_hot_kernels.py --only rows).
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

template <int TM, int MODE, bool BATCH>
__global__ void hamming_tile_kernel(const uint32_t* __restrict__ db,
                                    const uint32_t* __restrict__ q,
                                    const int32_t* __restrict__ base,
                                    int32_t* __restrict__ out0,
                                    int32_t* __restrict__ out1,
                                    int64_t n, int m, int b, int W, int tau,
                                    int64_t db_bs, int64_t q_bs,
                                    int64_t base_bs, int64_t out_bs) {
  extern __shared__ uint32_t q_tile[];  // [b * W][TM]
  if (BATCH) {
    // this block's batch entry (grid.z); a stride of 0 shares the operand
    const int64_t z = blockIdx.z;
    db += z * db_bs;
    q += z * q_bs;
    if (MODE == kVerify) base += z * base_bs;
    out0 += z * out_bs;
    if (MODE == kVerify) out1 += z * out_bs;
  }
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
           void* out1, long long n, int m, int b, int W, int tau, int batch,
           long long db_bs, long long q_bs, long long base_bs,
           long long out_bs, int tile_m, int block_n, void* stream) {
  if (n <= 0 || m <= 0 || batch <= 0) return (int)cudaSuccess;
  if (b <= 0 || W <= 0 || block_n <= 0 || block_n > 1024 || block_n % 32 ||
      db_bs < 0 || q_bs < 0 || base_bs < 0 || out_bs < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(block_n);
  const dim3 grid((unsigned)((n + block_n - 1) / block_n),
                  (unsigned)((m + tile_m - 1) / tile_m), (unsigned)batch);
  const size_t smem = (size_t)b * W * tile_m * sizeof(uint32_t);
  if (grid.y > 65535u || grid.z > 65535u || smem > 48u * 1024u)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* dbp = (const uint32_t*)db;
  const uint32_t* qp = (const uint32_t*)q;
  const int32_t* bp = (const int32_t*)base;
  int32_t* o0 = (int32_t*)out0;
  int32_t* o1 = (int32_t*)out1;
  switch (tile_m) {
#define HAMMING_CASE(TM)                                                      \
  case TM:                                                                    \
    if (batch > 1)                                                            \
      hamming_tile_kernel<TM, MODE, true><<<grid, block, smem, s>>>(          \
          dbp, qp, bp, o0, o1, (int64_t)n, m, b, W, tau, (int64_t)db_bs,      \
          (int64_t)q_bs, (int64_t)base_bs, (int64_t)out_bs);                  \
    else                                                                      \
      hamming_tile_kernel<TM, MODE, false><<<grid, block, smem, s>>>(         \
          dbp, qp, bp, o0, o1, (int64_t)n, m, b, W, tau, 0, 0, 0, 0);         \
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

// batch x [(b, W, n) x (b, W, m) uint32 -> (m, n) int32 distances],
// operand z at z * its stride (elements; 0 = shared).
int hamming_distances_batched_launch(const void* db, const void* q,
                                     void* out, long long n, int m, int b,
                                     int W, int batch, long long db_bs,
                                     long long q_bs, long long out_bs,
                                     int tile_m, int block_n, void* stream) {
  return launch<kDistances>(db, q, nullptr, out, nullptr, n, m, b, W, 0,
                            batch, db_bs, q_bs, 0, out_bs, tile_m, block_n,
                            stream);
}

// batch x [(b, W, n) x (b, W, m) uint32 + (m, n) int32 base -> (m, n)
// int32 mask (base + d <= tau) and (m, n) int32 min(base + d, BIG)];
// mask and dist share out_bs.
int sparse_verify_batch_batched_launch(const void* db, const void* q,
                                       const void* base, void* mask,
                                       void* dist, long long n, int m, int b,
                                       int W, int tau, int batch,
                                       long long db_bs, long long q_bs,
                                       long long base_bs, long long out_bs,
                                       int tile_m, int block_n,
                                       void* stream) {
  return launch<kVerify>(db, q, base, mask, dist, n, m, b, W, tau, batch,
                         db_bs, q_bs, base_bs, out_bs, tile_m, block_n,
                         stream);
}

const char* hamming_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
