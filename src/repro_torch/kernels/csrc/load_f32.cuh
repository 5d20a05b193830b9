// Loads of a row slice into fp32 registers, shared by the kernels in this
// directory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

// One 32-bit word -> 1 float (fp32) or 2 floats (bf16).
__device__ __forceinline__ void unpack(uint32_t u, float* o, float) {
  o[0] = __uint_as_float(u);
}
__device__ __forceinline__ void unpack(uint32_t u, float* o, __nv_bfloat16) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  o[0] = f.x;
  o[1] = f.y;
}

// N contiguous elements -> N floats, in the widest words that the slice's
// size allows: 16 bytes where it is a whole number of them, else 8, else 4
// (head dim 80 gives a decode lane 10 elements: 40 bytes in fp32, 20 in
// bf16).  The address must be aligned to the word chosen.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float* o) {
  constexpr int BYTES = N * sizeof(T);
  constexpr int E = 4 / sizeof(T);                  // elements per 32 bits
  static_assert(BYTES % 4 == 0, "row slice must be a whole number of words");
  using W = std::conditional_t<BYTES % 16 == 0, uint4,
                               std::conditional_t<BYTES % 8 == 0, uint2, uint32_t>>;
  constexpr int U = sizeof(W) / 4;                  // 32-bit parts of a word
  const W* w = reinterpret_cast<const W*>(p);
#pragma unroll
  for (int i = 0; i < BYTES / (int)sizeof(W); ++i) {
    const W r = __ldg(w + i);
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
    for (int k = 0; k < U; ++k) unpack(u[k], o + (i * U + k) * E, T());
  }
}

}  // namespace
