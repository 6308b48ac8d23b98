// Arena verifies for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (see ../_build.py and ../ops.py).
//
// Replaces two Pallas TPU kernels of repro/kernels/hamming_kernel.py:
//   * sparse_verify_arena_packed_pallas (:203; body
//     _verify_arena_packed_kernel :183, tile _packed_tile_distances :168)
//       -> sparse_verify_arena_packed_launch
//   * sparse_verify_arena_pallas (:278; body _verify_arena_kernel :259)
//       -> sparse_verify_arena_launch
// Both gather each column's base distance from an (m, T) plane through
// the column's segment-offset lane; they differ only in the distance
// tile, a template parameter of one pass kernel:
//   * packed: each column is ONE uint32 word holding the b bit planes of
//     the S suffix symbols below its segment's collapse depth (plane p at
//     bit offset p*S, b*S <= 32): x = db[i] ^ q[j];
//     d = popc(OR_{p<b} (x >> p*S) & (2^S - 1));
//   * plane: each column is b*W lane-major words db[p, w, i]:
//     d = sum_w popc(OR_p db[p, w, i] ^ q[p, w, j]).
// Then, for query j and column i:
//   total = d + (live[i] ? base_plane[j, base_idx[i]] : BIG);
//   mask = total <= tau;  dist = min(total, BIG).
//
// Bound on this card: bytes.  Every (query, column) pair writes two int32
// outputs, each column's lanes (its words, base index, liveness) and
// each query's row of the (m, T) base plane are read once: at the
// segmented Review shape (packed, n 12.6 M, T 6.8 M, m 64) 8.3 GB, 2.5
// ms at 3.35 TB/s.  What stands between the kernel and that bound is the
// gather base_plane[j, base_idx[i]]: a column's root is random within
// its segment, so each gather is a random 4-byte access into a row of T
// int32 — a 32-byte DRAM sector per gather unless what it reads is held
// in the 50 MB L2, and a 32-byte L2 sector even when it is.  A tile of 8
// queries by columns gathers from 8 such rows at once (218 MB at the
// Review shape), and almost every gather misses L2.  So the kernel walks
// the queries in order (query-major), Q queries a pass, and first codes
// the pass's Q rows into a (T,) slab of nibbles, one word per root: 0..13
// the base itself, 14 BIG, 15 "read the int32 row" — exact for every
// input; the segmented index's bases are <= tau or BIG, so with tau < 14
// it never reads a row.  Q is 16, 8 or 4 (a 64-, 32- or 16-bit word),
// the wrapper's choice from T, so that the slab stays well inside L2
// (5.3 MB at the CP shape's T = 662,938 with Q = 16; 14 MB at T = 6.8 M
// with Q = 4, where a 27 MB slab missed L2 often).  The slab is written
// and gathered with an evict_last policy; the plane, the packed lanes and
// the outputs stream past L2 (.cs, evict first).  After a grid-wide
// barrier each column gathers ONE slab word for its Q queries and reads
// its lanes once a pass: a plane column's b*W words come from device
// memory for the pass's first query and from L1 for the others.  A
// second barrier frees the slab for the next pass.  One cooperative
// launch: the grid is one wave of resident blocks (the SM count and
// blocks per SM found once per device and kernel), striding over roots
// and then columns; at most 64 registers a thread, so that 4 blocks fit
// an SM (the 16-query pass over 4 plane columns took 100 and ran 2).
//
// Ragged n and m are masked here; offsets are int64; 16-byte lanes and
// outputs (4 columns a thread) where n % 4 == 0 and the lanes are
// aligned, one column a thread otherwise.  S = 32 (b = 1) takes the
// all-ones field: 1u << 32 is undefined in C.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kBig = 1 << 20;  // distance sentinel of pruned lanes
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;   // resident blocks an SM: at most 64 registers
constexpr int kMaxDevices = 64;

// The nibble codes of a slab word: 0..13 the base itself, 14 BIG, 15
// "read the int32 row".  A pass of Q queries holds a Q/2-byte word.
constexpr uint32_t kBigCode = 14;
constexpr uint32_t kRowCode = 15;

template <int Q>
using SlabWord = std::conditional_t<
    Q == 4, uint16_t, std::conditional_t<Q == 8, uint32_t, uint64_t>>;

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

// A gather of what this kernel wrote before a grid barrier: at L2 (.cg,
// never a stale L1 line), kept there (evict_last).
__device__ __forceinline__ uint16_t ld_keep_cg(const uint16_t* p,
                                               uint64_t pol) {
  unsigned short x;
  asm volatile("ld.global.cg.L2::cache_hint.b16 %0, [%1], %2;\n"
               : "=h"(x) : "l"(p), "l"(pol));
  return x;
}

__device__ __forceinline__ uint32_t ld_keep_cg(const uint32_t* p,
                                               uint64_t pol) {
  uint32_t x;
  asm volatile("ld.global.cg.L2::cache_hint.b32 %0, [%1], %2;\n"
               : "=r"(x) : "l"(p), "l"(pol));
  return x;
}

__device__ __forceinline__ uint64_t ld_keep_cg(const uint64_t* p,
                                               uint64_t pol) {
  uint64_t x;
  asm volatile("ld.global.cg.L2::cache_hint.b64 %0, [%1], %2;\n"
               : "=l"(x) : "l"(p), "l"(pol));
  return x;
}

__device__ __forceinline__ void st_keep(uint16_t* p, uint16_t x,
                                        uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.b16 [%0], %1, %2;\n"
               :: "l"(p), "h"(x), "l"(pol) : "memory");
}

__device__ __forceinline__ void st_keep(uint32_t* p, uint32_t x,
                                        uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;\n"
               :: "l"(p), "r"(x), "l"(pol) : "memory");
}

__device__ __forceinline__ void st_keep(uint64_t* p, uint64_t x,
                                        uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.b64 [%0], %1, %2;\n"
               :: "l"(p), "l"(x), "l"(pol) : "memory");
}

// The packed distance tile: one word a column, cached in registers for
// the pass.
struct PackedTile {
  const uint32_t* db;
  const uint32_t* q;
  uint32_t field;  // the S-bit field mask
  int b, S;

  template <int VEC>
  struct Cols {
    uint32_t w[VEC];
  };

  template <int VEC>
  __device__ __forceinline__ Cols<VEC> load(int64_t i0) const {
    Cols<VEC> c;
    if constexpr (VEC == 4) {
      const uint4 x = __ldcs(reinterpret_cast<const uint4*>(db + i0));
      c.w[0] = x.x;
      c.w[1] = x.y;
      c.w[2] = x.z;
      c.w[3] = x.w;
    } else {
      c.w[0] = __ldcs(db + i0);
    }
    return c;
  }

  template <int VEC>
  __device__ __forceinline__ void distances(const Cols<VEC>& c, int64_t,
                                            int j, int (&d)[VEC]) const {
    const uint32_t qw = __ldg(&q[j]);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const uint32_t x = c.w[k] ^ qw;
      uint32_t acc = x & field;
      for (int p = 1; p < b; ++p) acc |= (x >> (p * S)) & field;
      d[k] = __popc(acc);
    }
  }
};

// The plane distance tile: b*W lane-major words a column, read from
// device memory for a pass's first query and from L1 for the rest.
struct PlaneTile {
  const uint32_t* db;  // (b, W, n)
  const uint32_t* q;   // (b, W, m)
  int64_t n;
  int m, b, W;

  template <int VEC>
  struct Cols {};

  template <int VEC>
  __device__ __forceinline__ Cols<VEC> load(int64_t) const {
    return {};
  }

  template <int VEC>
  __device__ __forceinline__ void distances(const Cols<VEC>&, int64_t i0,
                                            int j, int (&d)[VEC]) const {
#pragma unroll
    for (int k = 0; k < VEC; ++k) d[k] = 0;
    for (int w = 0; w < W; ++w) {
      uint32_t acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0u;
      for (int p = 0; p < b; ++p) {
        const int64_t row = (int64_t)p * W + w;
        const uint32_t qw = __ldg(&q[row * m + j]);
        const uint32_t* col = db + row * n + i0;
        if constexpr (VEC == 4) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(col));
          acc[0] |= x.x ^ qw;
          acc[1] |= x.y ^ qw;
          acc[2] |= x.z ^ qw;
          acc[3] |= x.w ^ qw;
        } else {
          acc[0] |= __ldg(col) ^ qw;
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) d[k] += __popc(acc[k]);
    }
  }
};

template <int VEC>
__device__ __forceinline__ void load_lanes(const int32_t* base_idx,
                                           const uint8_t* live, int64_t i0,
                                           int32_t (&lane)[VEC],
                                           bool (&alive)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 l = __ldcs(reinterpret_cast<const int4*>(base_idx + i0));
    const uchar4 a = __ldcs(reinterpret_cast<const uchar4*>(live + i0));
    lane[0] = l.x;
    lane[1] = l.y;
    lane[2] = l.z;
    lane[3] = l.w;
    alive[0] = a.x != 0;
    alive[1] = a.y != 0;
    alive[2] = a.z != 0;
    alive[3] = a.w != 0;
  } else {
    lane[0] = __ldcs(base_idx + i0);
    alive[0] = __ldcs(live + i0) != 0;
  }
}

template <int VEC>
__device__ __forceinline__ void store_pair(int32_t* mask, int32_t* dist,
                                           int64_t off, const int (&mk)[VEC],
                                           const int (&dk)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<int4*>(mask + off),
           make_int4(mk[0], mk[1], mk[2], mk[3]));
    __stcs(reinterpret_cast<int4*>(dist + off),
           make_int4(dk[0], dk[1], dk[2], dk[3]));
  } else {
    __stcs(mask + off, mk[0]);
    __stcs(dist + off, dk[0]);
  }
}

template <class Tile, int Q, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
arena_slab_kernel(Tile tile, const int32_t* __restrict__ base_plane,
                  const int32_t* __restrict__ base_idx,
                  const uint8_t* __restrict__ live,
                  int32_t* __restrict__ mask, int32_t* __restrict__ dist,
                  SlabWord<Q>* __restrict__ slab, int64_t n, int m, int64_t T,
                  int tau) {
  using Slab = SlabWord<Q>;
  cg::grid_group grid = cg::this_grid();
  const uint64_t pol = evict_last_policy();
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int j0 = 0; j0 < m; j0 += Q) {
    const int nq = m - j0 < Q ? m - j0 : Q;
    // code the pass's rows: slab[r] field qq = code of base_plane[j0+qq, r]
    for (int64_t r = tid; r < T; r += stride) {
      Slab word = 0;
#pragma unroll
      for (int qq = 0; qq < Q; ++qq)
        if (qq < nq)
          word |= (Slab)code_of(
                      __ldcs(&base_plane[(int64_t)(j0 + qq) * T + r]))
                  << (4 * qq);
      st_keep(&slab[r], word, pol);
    }
    grid.sync();

    for (int64_t i0 = tid * VEC; i0 < n; i0 += stride * VEC) {
      const auto cols = tile.template load<VEC>(i0);
      int32_t lane[VEC];
      bool alive[VEC];
      load_lanes<VEC>(base_idx, live, i0, lane, alive);
      Slab codes[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        codes[k] = alive[k] ? ld_keep_cg(slab + lane[k], pol) : (Slab)0;
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) {
        if (qq >= nq) break;
        const int j = j0 + qq;
        int d[VEC], mk[VEC], dk[VEC];
        tile.template distances<VEC>(cols, i0, j, d);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          int bj = kBig;
          if (alive[k]) {
            const uint32_t c = (uint32_t)(codes[k] >> (4 * qq)) & 0xFu;
            bj = c < kBigCode    ? (int)c
                 : c == kBigCode ? kBig
                                 : __ldg(&base_plane[(int64_t)j * T + lane[k]]);
          }
          // wrapping add, as the int32 sum of the reference
          const int total = (int)((uint32_t)d[k] + (uint32_t)bj);
          mk[k] = total <= tau ? 1 : 0;
          dk[k] = total < kBig ? total : kBig;
        }
        store_pair<VEC>(mask, dist, (int64_t)j * n + i0, mk, dk);
      }
    }
    grid.sync();                     // the slab is free for the next pass
  }
}

// One wave of resident blocks of arena_slab_kernel<Tile, Q, VEC> on the
// current device (the barrier's rule), found on the device's first
// launch and kept: 0 on error, with the error in *err.
template <class Tile, int Q, int VEC>
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
        &per_sm, arena_slab_kernel<Tile, Q, VEC>, kThreads, 0);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  if (dev < kMaxDevices)
    cache[dev].store(sms * per_sm, std::memory_order_relaxed);
  return sms * per_sm;
}

template <class Tile, int Q, int VEC>
int launch_pass(Tile tile, const int32_t* bp, const int32_t* ip,
                const uint8_t* lp, int32_t* mp, int32_t* dp, void* slab,
                int64_t n, int m, int64_t T, int tau, cudaStream_t s) {
  cudaError_t e = cudaSuccess;
  const int blocks = resident_grid<Tile, Q, VEC>(&e);
  if (blocks == 0) return (int)e;
  SlabWord<Q>* sp = (SlabWord<Q>*)slab;
  void* args[] = {(void*)&tile, (void*)&bp, (void*)&ip, (void*)&lp,
                  (void*)&mp,   (void*)&dp, (void*)&sp, (void*)&n,
                  (void*)&m,    (void*)&T,  (void*)&tau};
  e = cudaLaunchCooperativeKernel((const void*)arena_slab_kernel<Tile, Q, VEC>,
                                  dim3(blocks), dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch shared by both verifies: `vec` picks 4 columns a thread,
// `slab_q` the queries of a pass (the slab's word: 4, 8 or 16 nibbles).
template <class Tile>
int launch_arena(const Tile& tile, bool vec, int slab_q, const void* base_plane,
                 const void* base_idx, const void* live, void* mask,
                 void* dist, void* slab, long long n, int m, long long T,
                 int tau, void* stream) {
  const int32_t* bp = (const int32_t*)base_plane;
  const int32_t* ip = (const int32_t*)base_idx;
  const uint8_t* lp = (const uint8_t*)live;
  int32_t* mp = (int32_t*)mask;
  int32_t* dp = (int32_t*)dist;
  const int64_t nn = n, TT = T;
  cudaStream_t s = (cudaStream_t)stream;
#define ARENA_CASE(Q)                                                        \
  case Q:                                                                    \
    return vec ? launch_pass<Tile, Q, 4>(tile, bp, ip, lp, mp, dp, slab, nn, \
                                         m, TT, tau, s)                      \
               : launch_pass<Tile, Q, 1>(tile, bp, ip, lp, mp, dp, slab, nn, \
                                         m, TT, tau, s);
  switch (slab_q) {
    ARENA_CASE(4)
    ARENA_CASE(8)
    ARENA_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ARENA_CASE
}

// 16-byte lanes and output rows, 4-byte liveness: 4 columns a thread
bool vec_lanes(long long n, const void* base_idx, const void* live,
               const void* mask, const void* dist) {
  return n % 4 == 0 && (uintptr_t)base_idx % 16 == 0
         && (uintptr_t)live % 4 == 0 && (uintptr_t)mask % 16 == 0
         && (uintptr_t)dist % 16 == 0;
}

}  // namespace

extern "C" {

// (n,) x (m,) uint32 packed words + (m, T) int32 base plane + (n,) int32
// segment-offset lane + (n,) uint8 liveness -> (m, n) int32 mask and
// (m, n) int32 totals clamped to BIG.  Needs b >= 1, 0 <= S and
// b * S <= 32; base_idx must lie in [0, T); `slab` is a (T,) scratch of
// slab_q / 2 bytes a root, slab_q in {4, 8, 16}.
int sparse_verify_arena_packed_launch(const void* db, const void* q,
                                      const void* base_plane,
                                      const void* base_idx, const void* live,
                                      void* mask, void* dist, void* slab,
                                      long long n, int m, long long T, int b,
                                      int S, int tau, int slab_q,
                                      void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  if (b <= 0 || S < 0 || b * S > 32 || T <= 0 || slab == nullptr)
    return (int)cudaErrorInvalidValue;
  const PackedTile tile{(const uint32_t*)db, (const uint32_t*)q,
                        S >= 32 ? 0xFFFFFFFFu : (1u << S) - 1u, b, S};
  const bool vec = vec_lanes(n, base_idx, live, mask, dist)
                   && (uintptr_t)db % 16 == 0;
  return launch_arena(tile, vec, slab_q, base_plane, base_idx, live, mask,
                      dist, slab, n, m, T, tau, stream);
}

// (b, W, n) x (b, W, m) uint32 + (m, T) int32 base plane + (n,) int32
// segment-offset lane + (n,) uint8 liveness -> (m, n) int32 mask and
// (m, n) int32 min(base_plane[j, base_idx[i]] + d, BIG); a dead lane's
// base is BIG.  base_idx must lie in [0, T); `slab` as above.
int sparse_verify_arena_launch(const void* db, const void* q,
                               const void* base_plane, const void* base_idx,
                               const void* live, void* mask, void* dist,
                               void* slab, long long n, int m, long long T,
                               int b, int W, int tau, int slab_q,
                               void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaSuccess;
  if (b <= 0 || W <= 0 || T <= 0 || slab == nullptr)
    return (int)cudaErrorInvalidValue;
  const PlaneTile tile{(const uint32_t*)db, (const uint32_t*)q, (int64_t)n,
                       m, b, W};
  const bool vec = vec_lanes(n, base_idx, live, mask, dist)
                   && (uintptr_t)db % 16 == 0;
  return launch_arena(tile, vec, slab_q, base_plane, base_idx, live, mask,
                      dist, slab, n, m, T, tau, stream);
}

}  // extern "C"
