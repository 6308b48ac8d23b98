// Device primitives shared by the flash-attention kernels (flash_attn.cu,
// flash_attn_bwd.cu): operand strides, cp.async copies into padded
// shared-memory tiles, ldmatrix fragment loads, bf16 mma.sync m16n8k16
// with float32 sums, and the dynamic shared-memory limit raised once per
// device.  Everything sits in an unnamed namespace, so each source keeps
// its own copy, as when these lived in flash_attn.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

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

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) · b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16 (round to nearest even), the
// first in the low half: the element order of an mma fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of a (·, D) bf16 operand with row stride
// `stride` -> shared memory of pitch D + 8, by THREADS threads; rows at or
// past `limit` are zero-filled (their source address is clamped to row0,
// which is valid)
template <int D, int THREADS, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int limit, int tid) {
  constexpr int kChunks = D / 8;     // 16-byte chunks of a row
#pragma unroll
  for (int c = tid; c < ROWS * kChunks; c += THREADS) {
    const int r = c / kChunks;
    const int ch = c - r * kChunks;
    const bool ok = row0 + r < limit;
    const __nv_bfloat16* g = src + (long long)(ok ? row0 + r : row0) * stride
                             + ch * 8;
    cp_async16(dst + (uint32_t)((r * (D + 8) + ch * 8) * 2), g, ok ? 16 : 0);
  }
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

}  // namespace
