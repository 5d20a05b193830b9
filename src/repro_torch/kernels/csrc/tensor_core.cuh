// Tensor-core and asynchronous-copy primitives shared by the bf16 kernels
// in this directory (sm_90a): cp.async, and the warpgroup products
// (wgmma) with their descriptors and fences.
//
// The accumulator of wgmma.m64nNk16 (fp32), over the warpgroup's 4 warps
// (g = lane / 4, c = 2 * (lane % 4)): warp w owns rows 16 w .. 16 w + 15;
// register 4 j + e holds row 16 w + g + 8 (e / 2), column 8 j + c + e % 2.
// An A operand in registers (bf16, 4 registers a k16 step) has, per warp,
// the layout of mma.m16n8k16's A: a[0] = (g, c..c+1), a[1] = (g+8, c..c+1),
// a[2] = (g, c+8..c+9), a[3] = (g+8, c+8..c+9).  Two bf16 values share a
// 32-bit register, the lower column in the lower half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; the bytes past `src_bytes`
// (0..16) are zero-filled, so a ragged edge reads as zeros.  `src` must
// be a valid, 16-byte aligned address even when src_bytes is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, zero-filled past `src_bytes` (0 or 4).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two floats -> two bf16 (round to nearest even) in one register, `lo` in
// the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------- wgmma
//
// A warpgroup (4 warps, 128 threads) issues an asynchronous 64-row
// product with B (and A, unless A comes from registers) read from shared
// memory through a matrix descriptor.  The operand tiles here are all in
// the 128-byte swizzled layout: rows of 128 bytes (64 bf16) in 1024-byte
// aligned 8-row atoms, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8).  K-major (the reduction dim contiguous): a k16 step is 32
// bytes along the row, 8-row groups `sbo` = 1024 bytes apart.  N-major
// (read with the transpose bit): the rows are k, 64-column atoms `lbo`
// bytes apart, and a k16 step is 16 rows.

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders the compiler's uses of N accumulator registers after the wait
// that completes the products writing them (and its writes before the next
// products): wgmma writes them behind the compiler's back.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (each >> 4), layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

}  // namespace
