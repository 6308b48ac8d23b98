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
// index, liveness), every (query, column) pair writes two int32 outputs,
// and each query's row of the (m, T) base plane is read once: at the
// segmented Review shape (n 12.6 M, T 6.8 M, m 64) that is 8.3 GB, 2.5 ms
// at 3.35 TB/s.  What stands between the kernel and that bound is the
// gather base_plane[j, base_idx[i]]: a column's root is random within
// its segment, so each gather is a random 4-byte access into a 27 MB
// row — a 32-byte DRAM sector per gather unless what it reads is held in
// the 50 MB L2, and a 32-byte L2 sector even when it is.  The kernel
// walks the queries in order (query-major), 4 queries a pass, so that
// the blocks in flight gather from one small table that stays in L2
// (not the 8 rows, 218 MB, of a column-major 8-query tile, where almost
// every gather missed L2).  Measured at that shape (PERF.md), a table of
// 27 MB — one query's int32 row, or 8 queries' nibbles — still misses L2
// often; one of 14 MB much less.
//
// So each pass first codes its 4 rows into a (T,) uint16 slab (14 MB),
// a nibble per query and root: 0..13 the base itself, 14 BIG, 15 "read
// the int32 row" — exact for every input; the segmented index's bases
// are <= tau or BIG, so with tau < 14 it never reads a row.  The slab is
// written and gathered with an evict_last policy, the lanes, the plane
// and the outputs stream past L2 (.cs, evict first).  After a grid-wide
// barrier each column gathers ONE uint16 for its 4 queries: a quarter of
// the L2 requests of a row per query; the lanes are re-read once per
// pass (16 times, 1.8 GB, coalesced, 16-byte loads of 4 columns a
// thread).  A second barrier frees the slab for the next pass.  One
// cooperative launch: the grid is one wave of resident blocks (the SM
// count and blocks per SM found once per device), striding over roots
// and then columns.
//
// Ragged n and m are masked here; offsets are int64; 16-byte lanes and
// outputs (4 columns a thread) where n % 4 == 0 and the lanes are
// aligned, one column a thread otherwise.  S = 32 (b = 1) takes the
// all-ones field: 1u << 32 is undefined in C.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kBig = 1 << 20;  // distance sentinel of pruned lanes
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// A slab word holds the nibble codes of one root for 4 queries: 0..13
// the base itself, 14 BIG, 15 "read the int32 row".
constexpr int kQ = 4;
constexpr uint32_t kBigCode = 14;
constexpr uint32_t kRowCode = 15;

__device__ __forceinline__ uint32_t code_of(int v) {
  return (v >= 0 && v < (int)kBigCode) ? (uint32_t)v
         : v == kBig                   ? kBigCode
                                       : kRowCode;
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// a gather of what this kernel wrote before a grid barrier: at L2 (.cg,
// never a stale L1 line), kept there (evict_last)
__device__ __forceinline__ uint32_t ld_keep_cg(const uint16_t* p,
                                               uint64_t pol) {
  unsigned short x;
  asm volatile("ld.global.cg.L2::cache_hint.b16 %0, [%1], %2;\n"
               : "=h"(x) : "l"(p), "l"(pol));
  return x;
}

__device__ __forceinline__ void st_keep(uint16_t* p, uint32_t x,
                                        uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.b16 [%0], %1, %2;\n"
               :: "l"(p), "h"((unsigned short)x), "l"(pol) : "memory");
}

__device__ __forceinline__ void verify_one(uint32_t word, uint32_t qw,
                                           int bj, uint32_t field, int b,
                                           int S, int tau, int& mk,
                                           int& dk) {
  const uint32_t x = word ^ qw;
  uint32_t acc = x & field;
  for (int p = 1; p < b; ++p) acc |= (x >> (p * S)) & field;
  // wrapping add, as the int32 sum of the reference
  const int total = (int)((uint32_t)__popc(acc) + (uint32_t)bj);
  mk = total <= tau ? 1 : 0;
  dk = total < kBig ? total : kBig;
}

__device__ __forceinline__ uint32_t field_of(int S) {
  return S >= 32 ? 0xFFFFFFFFu : (1u << S) - 1u;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
packed_slab_kernel(const uint32_t* __restrict__ db,
                   const uint32_t* __restrict__ q,
                   const int32_t* __restrict__ base_plane,
                   const int32_t* __restrict__ base_idx,
                   const uint8_t* __restrict__ live,
                   int32_t* __restrict__ mask, int32_t* __restrict__ dist,
                   uint16_t* __restrict__ slab, int64_t n, int m, int64_t T,
                   int b, int S, int tau) {
  cg::grid_group grid = cg::this_grid();
  const uint32_t field = field_of(S);
  const uint64_t pol = evict_last_policy();
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int j0 = 0; j0 < m; j0 += kQ) {
    const int nq = m - j0 < kQ ? m - j0 : kQ;
    // code the pass's rows: slab[r] field qq = code of base_plane[j0+qq, r]
    for (int64_t r = tid; r < T; r += stride) {
      uint32_t word = 0;
#pragma unroll
      for (int qq = 0; qq < kQ; ++qq)
        if (qq < nq)
          word |= code_of(__ldcs(&base_plane[(int64_t)(j0 + qq) * T + r]))
                  << (4 * qq);
      st_keep(&slab[r], word, pol);
    }
    grid.sync();

    auto decode = [&](uint32_t codes, int qq, int32_t lane, bool alive) {
      if (!alive) return kBig;
      const uint32_t c = (codes >> (4 * qq)) & 0xFu;
      if (c < kBigCode) return (int)c;
      if (c == kBigCode) return kBig;
      return __ldg(&base_plane[(int64_t)(j0 + qq) * T + lane]);
    };
    for (int64_t i0 = tid * VEC; i0 < n; i0 += stride * VEC) {
      if constexpr (VEC == 4) {
        const uint4 word = __ldcs(reinterpret_cast<const uint4*>(db + i0));
        const int4 lane = __ldcs(reinterpret_cast<const int4*>(base_idx + i0));
        const uchar4 alive =
            __ldcs(reinterpret_cast<const uchar4*>(live + i0));
        const uint32_t c0 = alive.x ? ld_keep_cg(slab + lane.x, pol) : 0u;
        const uint32_t c1 = alive.y ? ld_keep_cg(slab + lane.y, pol) : 0u;
        const uint32_t c2 = alive.z ? ld_keep_cg(slab + lane.z, pol) : 0u;
        const uint32_t c3 = alive.w ? ld_keep_cg(slab + lane.w, pol) : 0u;
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq) {
          if (qq >= nq) break;
          const uint32_t qw = __ldg(&q[j0 + qq]);
          int4 mk, dk;
          verify_one(word.x, qw, decode(c0, qq, lane.x, alive.x), field, b,
                     S, tau, mk.x, dk.x);
          verify_one(word.y, qw, decode(c1, qq, lane.y, alive.y), field, b,
                     S, tau, mk.y, dk.y);
          verify_one(word.z, qw, decode(c2, qq, lane.z, alive.z), field, b,
                     S, tau, mk.z, dk.z);
          verify_one(word.w, qw, decode(c3, qq, lane.w, alive.w), field, b,
                     S, tau, mk.w, dk.w);
          const int64_t off = (int64_t)(j0 + qq) * n + i0;
          __stcs(reinterpret_cast<int4*>(mask + off), mk);
          __stcs(reinterpret_cast<int4*>(dist + off), dk);
        }
      } else {
        const uint32_t word = __ldcs(db + i0);
        const int32_t lane = __ldcs(base_idx + i0);
        const bool alive = __ldcs(live + i0) != 0;
        const uint32_t codes = alive ? ld_keep_cg(slab + lane, pol) : 0u;
#pragma unroll
        for (int qq = 0; qq < kQ; ++qq) {
          if (qq >= nq) break;
          int mk, dk;
          verify_one(word, __ldg(&q[j0 + qq]),
                     decode(codes, qq, lane, alive), field, b, S, tau, mk,
                     dk);
          const int64_t off = (int64_t)(j0 + qq) * n + i0;
          __stcs(mask + off, mk);
          __stcs(dist + off, dk);
        }
      }
    }
    grid.sync();                     // the slab is free for the next pass
  }
}

// One wave of resident blocks of packed_slab_kernel<VEC> on the current
// device (the barrier's rule), found on the device's first launch and
// kept: 0 on error, with the error in *err.
template <int VEC>
int resident_grid(cudaError_t* err) {
  static std::atomic<int> cache[kMaxDevices];   // zero: not found yet
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices) {
    const int known = cache[dev].load(std::memory_order_relaxed);
    if (known > 0) return known;
  }
  int sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, packed_slab_kernel<VEC>, kThreads, 0);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  if (dev < kMaxDevices)
    cache[dev].store(sms * per_sm, std::memory_order_relaxed);
  return sms * per_sm;
}

template <int VEC>
int launch_slab(const uint32_t* db, const uint32_t* q, const int32_t* bp,
                const int32_t* ip, const uint8_t* lp, int32_t* mp,
                int32_t* dp, uint16_t* slab, int64_t n, int m, int64_t T,
                int b, int S, int tau, cudaStream_t s) {
  cudaError_t e = cudaSuccess;
  const int blocks = resident_grid<VEC>(&e);
  if (blocks == 0) return (int)e;
  void* args[] = {(void*)&db, (void*)&q, (void*)&bp, (void*)&ip, (void*)&lp,
                  (void*)&mp, (void*)&dp, (void*)&slab, (void*)&n, (void*)&m,
                  (void*)&T, (void*)&b, (void*)&S, (void*)&tau};
  e = cudaLaunchCooperativeKernel((const void*)packed_slab_kernel<VEC>,
                                  dim3(blocks), dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (n,) x (m,) uint32 packed words + (m, T) int32 base plane + (n,) int32
// segment-offset lane + (n,) uint8 liveness -> (m, n) int32 mask and
// (m, n) int32 totals clamped to BIG.  Needs b >= 1, 0 <= S and
// b * S <= 32; base_idx must lie in [0, T); `slab` is a (T,) uint16
// scratch.
int sparse_verify_arena_packed_launch(const void* db, const void* q,
                                      const void* base_plane,
                                      const void* base_idx, const void* live,
                                      void* mask, void* dist, void* slab,
                                      long long n, int m, long long T, int b,
                                      int S, int tau, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  if (b <= 0 || S < 0 || b * S > 32 || T <= 0 || slab == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* dbp = (const uint32_t*)db;
  const uint32_t* qp = (const uint32_t*)q;
  const int32_t* bp = (const int32_t*)base_plane;
  const int32_t* ip = (const int32_t*)base_idx;
  const uint8_t* lp = (const uint8_t*)live;
  int32_t* mp = (int32_t*)mask;
  int32_t* dp = (int32_t*)dist;
  uint16_t* sp = (uint16_t*)slab;
  // 16-byte lanes and output rows, 4-byte liveness: 4 columns a thread
  const bool vec = n % 4 == 0 && (uintptr_t)db % 16 == 0
                   && (uintptr_t)base_idx % 16 == 0
                   && (uintptr_t)live % 4 == 0 && (uintptr_t)mask % 16 == 0
                   && (uintptr_t)dist % 16 == 0;
  const int64_t nn = n, TT = T;
  if (vec)
    return launch_slab<4>(dbp, qp, bp, ip, lp, mp, dp, sp, nn, m, TT, b, S,
                          tau, s);
  return launch_slab<1>(dbp, qp, bp, ip, lp, mp, dp, sp, nn, m, TT, b, S, tau,
                        s);
}

}  // extern "C"
