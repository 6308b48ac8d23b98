// The shared pieces of the flash-attention kernels (flash_attn.cu,
// flash_attn_bwd.cu): operand strides and bf16 helpers, and the Hopper
// (sm_90a) primitives of their bf16 kernels: mbarriers, TMA tile loads
// through a tensor map (and the maps themselves, encoded on the host),
// warpgroup MMAs (wgmma) with their shared-memory descriptors, named
// barriers and setmaxnreg.
// Shared tiles are the TMA's 128-byte swizzle: rows of 64 bf16 (128 bytes)
// whose 16-byte chunks are XORed with the row's index mod 8, so a tile's
// base must be 1024-byte aligned; a D = 128 operand is two such tiles of
// 64 columns.  A 16-column tail (D = 80's last columns, or all of D = 16)
// is a tile of the 32-byte swizzle: rows of 32 bytes whose two chunks are
// swapped in rows 4-7 of every 8 (a 256-byte pattern).  Everything sits in
// an unnamed namespace, so each source keeps its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// operands and bf16
// ---------------------------------------------------------------------------

// (b, h, s) element strides of a (B, H, S, D) operand; D is unit-stride
struct Strides {
  long long b, h, s;
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// x rounded to the nearest bfloat16 (ties to even), back in float32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16 (round to nearest even), the
// first in the low half: the element order of an MMA fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The dynamic shared-memory limit of `kernel` raised to `bytes` on the
// current device, once per device (`raised` keeps a bit for each).
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, int bytes,
                             std::atomic<unsigned long long>& raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// the barriers' initialisation made visible to the TMA unit (async proxy)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the current phase also waits for `bytes` more of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
      :: "r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory at `dst`; its bytes complete on the mbarrier `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// warpgroup MMA
// ---------------------------------------------------------------------------

// the layout types of a descriptor (bits 62-63)
constexpr uint32_t kSwizzle128B = 1;
constexpr uint32_t kSwizzle32B = 3;

// The descriptor of a swizzled shared operand at `addr`: `lbo` the byte
// stride between swizzle-wide blocks along M or N (MN-major only: 64
// columns under the 128-byte swizzle), `sbo` the byte stride between
// groups of 8 rows (1024 for rows of 128 bytes, 256 for rows of 32)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo,
                                               uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
         | (uint64_t)swizzle << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64, f32) = d · [scale_d] + A · B: A (64 x 16) and B (16 x 64)
// in shared memory, both K-major (descriptors a and b)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128, f32) = d · [scale_d] + A · B: A (64 x 16) and B (16 x 128)
// in shared memory, both K-major (descriptors a and b)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0 .. 32) (64 x 64, f32) = d · [scale_d] + A · B: A (64 x 16) a bf16
// register fragment, B (16 x 64) in shared memory, MN-major (descriptor b)
template <int M>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[M],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  static_assert(M >= 32, "an n64 accumulator is 32 floats a thread");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[0 .. 64) (64 x 128, f32) = d · [scale_d] + A · B: A (64 x 16) a bf16
// register fragment, B (16 x 128) in shared memory, MN-major (descriptor b)
template <int M>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[M],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  static_assert(M >= 64, "an n128 accumulator is 64 floats a thread");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[O .. O + 8) (64 x 16, f32) = d · [scale_d] + A · B: A (64 x 16) a
// bf16 register fragment, B (16 x 16) in shared memory, MN-major
// (descriptor b); O places the n16 accumulator after an n64 one
template <int O, int M>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[M],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  static_assert(O + 8 <= M, "an n16 accumulator is 8 floats a thread");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[O]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]),
        "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// warp specialisation
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// two floats from shared memory (8-byte aligned)
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// a barrier of the `threads` threads that name `id` (1..15; 0 is
// __syncthreads's)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// an arrival at barrier `id` of `threads` threads, without waiting
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// operands split by head dim, and the flash kernels' softmax constants
// ---------------------------------------------------------------------------

// A K-major operand of 64 rows x 16 columns (depth step kk) from row `row`
// of a swizzled operand whose blocks are `block` bytes apart: steps 0-3 of
// each 128-byte block, then the 32-byte tail's one step
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, uint32_t block,
                                           int row, int kk) {
  constexpr int kBlockSteps = 4 * (D / 64);
  if (kk < kBlockSteps)
    return wgmma_desc(base + (kk >> 2) * block + row * 128 + (kk & 3) * 32,
                      16, 1024, kSwizzle128B);
  return wgmma_desc(base + (D / 64) * block + row * 32, 16, 256,
                    kSwizzle32B);
}

// d += A · B over a streamed tile whose blocks are `block` bytes apart,
// B its 16 rows of depth step kq as an MN-major operand of D columns: one
// n64 or n128 over the 128-byte blocks (d[0 .. 64·blocks / 2)), one n16
// over the 32-byte tail (the next 8 floats)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint32_t tile, uint32_t block,
                                         int kq) {
  constexpr int kBlocks = D / 64;
  if constexpr (kBlocks == 1) {
    wgmma_rs_n64(d, a, wgmma_desc(tile + kq * 16 * 128, block, 1024,
                                  kSwizzle128B), 1);
  } else if constexpr (kBlocks == 2) {
    wgmma_rs_n128(d, a, wgmma_desc(tile + kq * 16 * 128, block, 1024,
                                   kSwizzle128B), 1);
  }
  if constexpr (D % 64 != 0)    // one swizzle span wide: lbo is not read
    wgmma_rs_n16<32 * kBlocks>(
        d, a, wgmma_desc(tile + kBlocks * block + kq * 16 * 32, 256, 256,
                         kSwizzle32B), 1);
}

// The softmax constants of a call: scale·log2(e) (no cap), or scale / cap
// and cap·log2(e) (under a cap)
struct WgSoft {
  float sl, sc, cl;
  __device__ __forceinline__ WgSoft(float scale, float cap)
      : sl(scale * kLog2e), sc(cap > 0.f ? scale / cap : 0.f),
        cl(cap * kLog2e) {}
};

// f(CAP, MASK) with both as std::integral_constant, so that the element
// loop of each kind of tile is compiled without branches
template <typename F>
__device__ __forceinline__ void tile_kind(bool cap, bool mask, F&& f) {
  using Y = std::true_type;
  using N = std::false_type;
  if (cap) {
    if (mask) f(Y{}, Y{}); else f(Y{}, N{});
  } else {
    if (mask) f(N{}, Y{}); else f(N{}, N{});
  }
}

constexpr int kBox = 64;             // TMA boxes: 64 rows (x 64 or 16 columns)

// The tensor maps of one (B, H, S, D) bf16 operand: 64 x 64 boxes of its
// 64-column blocks under the 128-byte swizzle and, where D has a 16-column
// tail, 16-column x 64-row boxes of it under the 32-byte swizzle (else
// zeroed and never read)
struct OperandMaps {
  CUtensorMap block, tail;
};

// rows [row0, row0 + ROWS) of an operand into its swizzled blocks at `dst`
// (`block` bytes apart) and its tail after them, completing on `bar`
template <int D, int ROWS>
__device__ __forceinline__ void wg_load_rows(uint32_t dst,
                                             const OperandMaps* m,
                                             uint32_t bar, uint32_t block,
                                             int row0, int h, int b) {
  constexpr int kBlocks = D / 64;
#pragma unroll
  for (int r = 0; r < ROWS; r += kBox) {
#pragma unroll
    for (int j = 0; j < kBlocks; ++j)
      tma_load_4d(dst + j * block + r * 128, &m->block, bar, 64 * j,
                  row0 + r, h, b);
    if constexpr (D % 64 != 0)
      tma_load_4d(dst + kBlocks * block + r * 32, &m->tail, bar,
                  64 * kBlocks, row0 + r, h, b);
  }
}

// ---------------------------------------------------------------------------
// tensor maps: the driver's cuTensorMapEncodeTiled, fetched through the
// runtime (the library links no libcuda)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static std::atomic<EncodeTiledFn> fn{nullptr};
  EncodeTiledFn f = fn.load(std::memory_order_acquire);
  if (f != nullptr) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t e = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
  if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  f = reinterpret_cast<EncodeTiledFn>(p);
  fn.store(f, std::memory_order_release);
  return f;
}

// One box shape of a (B, H, S, D) bf16 operand (unit stride along D,
// (b, h, s) element strides `st`) as a 4-d tensor map {D, S, H, B}: boxes
// of `cols` columns x kBox rows under `swizzle`; rows past S read as
// zeros.  A dimension of size 1 is never stepped, so its stride is
// replaced by a packed one.  TMA needs a 16-byte aligned base and strides
// (ops.py copies an operand that has not for the backward, and refuses it
// for the forward).
cudaError_t bf16_box_map(CUtensorMap* m, const void* base, int B, int H,
                         int S, int D, Strides st, int cols,
                         CUtensorMapSwizzle swizzle) {
  const long long ss = S > 1 ? st.s : D;
  const long long sh = H > 1 ? st.h : ss * S;
  const long long sb = B > 1 ? st.b : sh * H;
  if ((uintptr_t)base % 16 != 0 || ss <= 0 || sh <= 0 || sb <= 0
      || ss % 8 != 0 || sh % 8 != 0 || sb % 8 != 0)
    return cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)kBox, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// An operand's OperandMaps: the 64 x 64 boxes of its 128-byte-swizzled
// blocks (D >= 64) and the 16 x 64 boxes of its 32-byte-swizzled tail
// (D % 64 = 16), the rest zeroed.  S = 0: zeroed maps that are never read.
cudaError_t bf16_maps(OperandMaps* m, const void* base, int B, int H, int S,
                      int D, Strides st) {
  memset(m, 0, sizeof(*m));
  if (S <= 0) return cudaSuccess;
  cudaError_t e = cudaSuccess;
  if (D >= 64)
    e = bf16_box_map(&m->block, base, B, H, S, D, st, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess && D % 64 != 0)
    e = bf16_box_map(&m->tail, base, B, H, S, D, st, 16,
                     CU_TENSOR_MAP_SWIZZLE_32B);
  return e;
}

}  // namespace
