// Vertical-format Hamming scans for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see ../_build.py and ../ops.py).
//
// Replaces two Pallas TPU kernels of repro/kernels/hamming_kernel.py:
//   * hamming_distances_pallas   (:70, body _hamming_kernel :64)
//       -> hamming_distances_batched_launch, and, where the JAX package
//          vmaps it over the MI-bST's per-query candidate sets
//          (repro/core/multi_index.py:160-169),
//          hamming_distances_gather_launch
//   * sparse_verify_batch_pallas (:114, body _verify_batch_kernel :100;
//     its m=1 case sparse_verify_pallas :156)
//       -> sparse_verify_batch_batched_launch
// Both share the tile _tile_distances (:49):
//   d[j, i] = sum_w popc( OR_p db[p, w, i] ^ q[p, w, j] ).
// The JAX package also reaches both under jax.vmap, which adds a grid
// axis.  The sharded bST vmaps the verify over shards
// (repro/core/distributed_search.py:471): here that axis is grid.z, every
// operand takes a batch stride in elements, and a stride of 0 shares an
// operand across the batch.  The unbatched wrappers of ../ops.py call
// the same two entries with batch = 1, which launches the kernel
// specialised without the batch offsets (BATCH = false): with them the
// verify's 8-query tile takes 40 registers instead of 32 (6 blocks of
// 256 an SM instead of 8) and ran 4.51 against 4.30 ms queued at the
// static Review shape on an H100 (tools/bench_hot_kernels.py --only rows).
// The MI-bST candidate verify (the vmap over queries) is its own kernel,
// gather_verify_kernel below: it reads the database through each
// query's candidate ids and scores only the valid prefix of its row.
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

// The MI-bST candidate verify.  Query j holds C candidate slots
// ids[j, s] whose first counts[j] are valid (the compacted prefix); the
// JAX package gathers full_vert[:, :, ids] for every slot and vmaps the
// scan over the queries.  Here each valid slot reads its own b*W words
// straight through its id, so nothing is gathered, copied or scored for
// a slot past its query's count:
//   out[j, s] = sum_w popc( OR_p db[p, w, ids[j, s]] ^ q[p, w, j] )
//               for s < counts[j], else BIG.
// Bound on this card: bytes.  Candidate ids lie ~1,300 rows apart at the
// Review shape, so each gathered 4-byte word costs the card a 32-byte
// sector of its own, and the latency of such random reads, not the
// streaming rate, sets the time.  So:
//   * one thread per (query, slot), kSlots slots a thread, slots
//     contiguous along a block's span (coalesced id loads and output
//     stores);
//   * a block whose slots all lie past its query's count only stores
//     BIG: it reads neither ids nor the database;
//   * blocks run span by span with all m queries of a span together:
//     the queries' ids are sorted and alike in number, so the blocks in
//     flight gather from one region of the database; the spans follow
//     at a stride coprime with their count (17 or the next), which
//     spreads each row's few gather spans among its many BIG-only spans
//     over the launch.  Both orders beat query-by-query blocks in trial
//     runs on an H100 (the variants are not kept; PERF.md §6);
//   * the ids are loaded before the block's query words are staged in
//     shared memory (once a block, broadcast to every thread), so their
//     latencies overlap;
//   * every gather of a pair of words w, w+1 over all b planes and both
//     slots is issued through the read-only path before any popc;
//   * b (1..8) is a template argument so the words stay in registers; W
//     and m are runtime; offsets into the database and the output are
//     int64; an id outside [0, n) is never read and scores BIG.
// Two slots a thread beat one and four at the Review shape in trial
// runs on an H100 (PERF.md §6), so it is fixed, as is the block.
constexpr int kSlots = 2;
constexpr int kGatherBlock = 512;

template <int B>
__global__ void gather_verify_kernel(const uint32_t* __restrict__ db,
                                     const uint32_t* __restrict__ q,
                                     const int32_t* __restrict__ ids,
                                     const int32_t* __restrict__ counts,
                                     int32_t* __restrict__ out, int64_t n,
                                     int m, int C, int W, int64_t ids_ld,
                                     int64_t stride) {
  extern __shared__ uint32_t q_words[];  // [B * W]: query j's words
  // the launch order: consecutive blocks take one span of every query,
  // and the spans follow at `stride` (coprime with their count)
  const int64_t bid = blockIdx.x + (int64_t)gridDim.x * blockIdx.y;
  const int j = (int)(bid % m);
  const int64_t xb = (bid / m) * stride % gridDim.x;
  const int64_t span0 = xb * blockDim.x * kSlots;
  const int64_t s0 = span0 + threadIdx.x;
  int32_t* row = out + (int64_t)j * C;
  const int cnt = min(max(__ldg(&counts[j]), 0), C);
  if (span0 >= cnt) {  // block-uniform: BIG stores only
    // thread t fills slots span0 + 2t, +1: one 8-byte store where the
    // row's alignment allows it
    const int64_t f = span0 + (int64_t)kSlots * threadIdx.x;
    int32_t* at = row + f;
    if (f + kSlots <= C && ((uintptr_t)at & (4 * kSlots - 1)) == 0) {
      *reinterpret_cast<int2*>(at) = make_int2(kBig, kBig);
    } else {
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (f + k < C) at[k] = kBig;
    }
    return;
  }
  int64_t id[kSlots];
  bool ok[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int64_t s = s0 + (int64_t)k * blockDim.x;
    id[k] = s < cnt ? (int64_t)__ldg(&ids[(int64_t)j * ids_ld + s]) : -1;
    ok[k] = id[k] >= 0 && id[k] < n;
  }
  for (int t = threadIdx.x; t < B * W; t += blockDim.x)
    q_words[t] = __ldg(&q[(int64_t)t * m + j]);
  __syncthreads();

  int d[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) d[k] = 0;
  for (int w = 0; w < W; w += 2) {
    const bool two = w + 1 < W;
    uint32_t x0[kSlots][B], x1[kSlots][B];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
#pragma unroll
      for (int p = 0; p < B; ++p) {
        const int64_t at = ((int64_t)p * W + w) * n + id[k];
        x0[k][p] = ok[k] ? __ldg(&db[at]) : 0u;
        x1[k][p] = ok[k] && two ? __ldg(&db[at + n]) : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      uint32_t a0 = 0u, a1 = 0u;
#pragma unroll
      for (int p = 0; p < B; ++p) {
        a0 |= x0[k][p] ^ q_words[p * W + w];
        if (two) a1 |= x1[k][p] ^ q_words[p * W + w + 1];
      }
      d[k] += __popc(a0) + __popc(a1);
    }
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int64_t s = s0 + (int64_t)k * blockDim.x;
    if (s < C) row[s] = ok[k] ? d[k] : kBig;
  }
}

int64_t gcd(int64_t a, int64_t b) { return b ? gcd(b, a % b) : a; }

// The first stride from 17 up that is coprime with `spans`; the last
// answer is kept a thread, since one index launches at one C.
int64_t span_stride(int64_t spans) {
  thread_local int64_t last_spans = -1, last_stride = 17;
  if (spans != last_spans) {
    int64_t stride = 17;
    while (gcd(stride, spans) != 1) ++stride;
    last_spans = spans;
    last_stride = stride;
  }
  return last_stride;
}

// One candidate verify launch at B planes.  The block is kGatherBlock
// cut to what the instance's registers allow, looked up once an
// instance (a static's initialiser runs once, thread-safe).
template <int B>
int launch_gather(const uint32_t* db, const uint32_t* q, const int32_t* ids,
                  const int32_t* counts, int32_t* out, int64_t n, int m,
                  int C, int W, int64_t ids_ld, cudaStream_t s) {
  static const int block = [] {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, gather_verify_kernel<B>) != cudaSuccess)
      return 0;
    const int most = attr.maxThreadsPerBlock;
    return (kGatherBlock < most ? kGatherBlock : most) / 32 * 32;
  }();
  const size_t smem = (size_t)B * W * sizeof(uint32_t);
  if (block < 32 || smem > 48u * 1024u) return (int)cudaErrorInvalidValue;
  const int64_t span = (int64_t)block * kSlots;
  const int64_t spans = (C + span - 1) / span;
  gather_verify_kernel<B><<<dim3((unsigned)spans, (unsigned)m), block, smem,
                            s>>>(db, q, ids, counts, out, n, m, C, W, ids_ld,
                                 span_stride(spans));
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

// (b, W, n) database x (b, W, m) queries, (m, C) candidate ids (row
// stride ids_ld elements, unit column stride) with (m,) counts -> (m, C)
// int32: the distance at each slot below its query's count, BIG past it.
int hamming_distances_gather_launch(const void* db, const void* q,
                                    const void* ids, const void* counts,
                                    void* out, long long n, int m, int C,
                                    int b, int W, long long ids_ld,
                                    void* stream) {
  if (m <= 0 || C <= 0) return (int)cudaSuccess;
  if (n < 0 || b < 1 || b > 8 || W <= 0 || ids_ld < C || m > 65535)
    return (int)cudaErrorInvalidValue;
  const uint32_t* dbp = (const uint32_t*)db;
  const uint32_t* qp = (const uint32_t*)q;
  const int32_t* ip = (const int32_t*)ids;
  const int32_t* cp = (const int32_t*)counts;
  int32_t* op = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (b) {
#define GATHER_B(B)                                                           \
  case B:                                                                     \
    return launch_gather<B>(dbp, qp, ip, cp, op, (int64_t)n, m, C, W,         \
                            (int64_t)ids_ld, s);
    GATHER_B(1)
    GATHER_B(2)
    GATHER_B(3)
    GATHER_B(4)
    GATHER_B(5)
    GATHER_B(6)
    GATHER_B(7)
    GATHER_B(8)
#undef GATHER_B
  }
  return (int)cudaErrorInvalidValue;
}

const char* hamming_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
