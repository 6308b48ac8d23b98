// Packed-suffix arena verify for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see ../_build.py and ../ops.py).
//
// Replaces the Pallas TPU kernel sparse_verify_arena_packed_pallas of
// repro/kernels/hamming_kernel.py (:203; body
// _verify_arena_packed_kernel :183, tile _packed_tile_distances :168)
//   -> sparse_verify_arena_packed_launch.
// Each column is ONE uint32 word holding the b bit planes of the S
// suffix symbols below its segment's collapse depth (plane p at bit
// offset p*S, b*S <= 32).  For query j and column i:
//   x = db[i] ^ q[j];  acc = OR_{p<b} (x >> p*S) & (2^S - 1);
//   total = popc(acc) + (live[i] ? base_plane[j, base_idx[i]] : BIG);
//   mask = total <= tau;  dist = min(total, BIG).
//
// Bound on this card: bytes.  A column is 9 bytes of lanes (word, base
// index, liveness), while every (query, column) pair gathers one int32
// base and writes two int32 outputs, for ~3b + 6 integer ops.  The
// design:
//   * one thread per column, threads contiguous along n: the lanes and
//     the (m, n) output rows coalesce;
//   * TM query words per block in shared memory (a broadcast read), so
//     each column's three lanes are read once per query tile;
//   * the base is gathered from the (m, T) plane in device memory.  The
//     TPU kernel holds a (block_m, T) slab of it in VMEM; at the sizes
//     the segmented index serves T is ~10^7 roots, far past shared
//     memory, and a column's root is random within its segment, so the
//     gather is a random 4-byte access per pair: the kernel's gap to
//     its bound;
//   * the ragged edges of n and m are masked here; offsets are int64.
// S = 32 (b = 1) takes the all-ones field: 1u << 32 is undefined in C.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;  // distance sentinel of pruned lanes

template <int TM>
__global__ void packed_verify_kernel(const uint32_t* __restrict__ db,
                                     const uint32_t* __restrict__ q,
                                     const int32_t* __restrict__ base_plane,
                                     const int32_t* __restrict__ base_idx,
                                     const uint8_t* __restrict__ live,
                                     int32_t* __restrict__ mask,
                                     int32_t* __restrict__ dist, int64_t n,
                                     int m, int64_t T, int b, int S,
                                     int tau) {
  __shared__ uint32_t q_tile[TM];
  const int j0 = blockIdx.y * TM;
  for (int t = threadIdx.x; t < TM; t += blockDim.x)
    q_tile[t] = (j0 + t < m) ? q[j0 + t] : 0u;
  __syncthreads();

  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t word = __ldg(&db[i]);
  const int64_t lane = __ldg(&base_idx[i]);
  const bool alive = __ldg(&live[i]) != 0;
  const uint32_t field = S >= 32 ? 0xFFFFFFFFu : (1u << S) - 1u;

#pragma unroll
  for (int jj = 0; jj < TM; ++jj) {
    const int j = j0 + jj;
    if (j >= m) break;
    const uint32_t x = word ^ q_tile[jj];
    uint32_t acc = x & field;
    for (int p = 1; p < b; ++p) acc |= (x >> (p * S)) & field;
    const int bj = alive ? __ldg(&base_plane[(int64_t)j * T + lane]) : kBig;
    // wrapping add, as the int32 sum of the reference
    const int total = (int)((uint32_t)__popc(acc) + (uint32_t)bj);
    const int64_t off = (int64_t)j * n + i;
    mask[off] = total <= tau ? 1 : 0;
    dist[off] = total < kBig ? total : kBig;
  }
}

}  // namespace

extern "C" {

// (n,) x (m,) uint32 packed words + (m, T) int32 base plane + (n,) int32
// segment-offset lane + (n,) uint8 liveness -> (m, n) int32 mask and
// (m, n) int32 totals clamped to BIG.  Needs b >= 1, 0 <= S and
// b * S <= 32; base_idx must lie in [0, T).
int sparse_verify_arena_packed_launch(const void* db, const void* q,
                                      const void* base_plane,
                                      const void* base_idx, const void* live,
                                      void* mask, void* dist, long long n,
                                      int m, long long T, int b, int S,
                                      int tau, int tile_m, int block_n,
                                      void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  if (b <= 0 || S < 0 || b * S > 32 || T <= 0 || block_n <= 0 ||
      block_n > 1024 || block_n % 32)
    return (int)cudaErrorInvalidValue;
  const dim3 block(block_n);
  const dim3 grid((unsigned)((n + block_n - 1) / block_n),
                  (unsigned)((m + tile_m - 1) / tile_m));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* dbp = (const uint32_t*)db;
  const uint32_t* qp = (const uint32_t*)q;
  const int32_t* bp = (const int32_t*)base_plane;
  const int32_t* ip = (const int32_t*)base_idx;
  const uint8_t* lp = (const uint8_t*)live;
  int32_t* mp = (int32_t*)mask;
  int32_t* dp = (int32_t*)dist;
  switch (tile_m) {
#define PACKED_CASE(TM)                                                       \
  case TM:                                                                    \
    packed_verify_kernel<TM><<<grid, block, 0, s>>>(                          \
        dbp, qp, bp, ip, lp, mp, dp, (int64_t)n, m, (int64_t)T, b, S, tau);   \
    break;
    PACKED_CASE(1)
    PACKED_CASE(2)
    PACKED_CASE(4)
    PACKED_CASE(8)
    PACKED_CASE(16)
    PACKED_CASE(32)
#undef PACKED_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
