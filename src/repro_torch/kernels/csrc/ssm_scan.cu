// Chunked gated linear scan (the Mamba2 SSD core) on Hopper's tensor cores
// (sm_90a), behind a plain C entry point that returns cudaGetLastError().
//
// ssm_scan_tc_kernel<T, PS>  replaces ssm_scan_pallas
//   (src/repro/kernels/ssm_scan.py:57, _ssm_kernel :20, pl.pallas_call :74),
//   the chunked form of
//       h_t = exp(a_log_t) h_{t-1} + x_t (x) b_t,    y_t = h_t . c_t,
//   from a zero state, per (batch row, head).  x (B,S,H,P) and y in T
//   (float32 or bfloat16), a_log (B,S,H) fp32, b and c (B,S,N) in T,
//   h_final (B,H,P,N) fp32; P = N = 64.
//
// Bound.  At zamba2-2.7b's prefill (B 4, S 512, H 80) the scan needs ~3.04
//   GFLOP (the chunked form at its cheapest chunk, 8 rows) against 90.8 MB
//   of x, a_log, b, c, y and h_final in fp32 (48.4 MB in bf16).  In bf16
//   the bytes bound it (0.0144 ms at 3.35 TB/s).  In fp32 each product runs
//   as three TF32 products (3 x 3.04 GFLOP at 495 TFLOP/s, 0.0184 ms), so
//   the bytes bound it too (0.0271 ms); on the CUDA cores the operations
//   would (0.0454 ms at 67 TFLOP/s).
//
// Design.  Columns p of y and rows p of h depend only on x[:, p], so P is
//   split across blocks: a block owns (P-slice of PS columns, head, batch
//   row) and walks the sequence in chunks of kLc = 64 rows, its PS x 64
//   slice of the state carried in registers (and copied to shared memory
//   for the next chunk's C h^T).  PS is 32, or in bf16 16 where B H is
//   below the SM count: a grid of 32s would leave most SMs one block of
//   four warps, and slices of 16 give them two (measured faster at one
//   prompt, slower at two; PERF.md).  fp32 holds two blocks an SM (264
//   slots on 132 SMs), bf16 five (660): at 4 x 512 the grid is 640 blocks
//   of 32, 2.4 waves in fp32 and one in bf16; one prompt of 1 x 2048 is
//   160 blocks of 32 in fp32 and 320 of 16 in bf16, one wave each (the old
//   grid of B x H blocks gave 320 and 80).
//   Per chunk:
//     1. cp.async brings the chunk's x slice, b, c and a_log rows into
//        shared memory; rows past S are zero-filled, with a_log 0, so a
//        ragged last chunk adds nothing and decays nothing.  fp32 keeps
//        two stages, the next chunk's copies issued before this one's
//        products; bf16 keeps one and the SM's other four blocks cover
//        its copies (measured faster than two stages at four blocks an
//        SM).  b is read once and serves both its row-major and (by
//        ldmatrix.trans or scalar loads) its transposed uses;
//     2. every warp scans the chunk's a_log in fp64 in its own registers
//        (two rows a lane, shuffles), so no barrier waits on it, and keeps
//        the cumulative decays in log2 units as fp32 pairs hi + lo: fp32
//        prefix sums lose ~1e-4 of exp(cum_i - cum_j) where |cum| nears
//        1000, as the published init's fast heads do within a chunk,
//        while (hi_i - hi_j) + (lo_i - lo_j) keeps fp32's precision;
//     3. warp W takes rows 16W .. 16W + 15 (W a template argument, so that
//        every loop over its tiles has a known bound and the products of
//        different tiles interleave): S = C B^T for its row tile up to
//        the diagonal, and C h^T for the entering state, in one loop over
//        N that loads each C fragment once for both; then S_ij *=
//        2^(cum_i - cum_j) by ex2.approx for j <= i and 0 above by a
//        select (above the diagonal the exponent is positive and may
//        overflow; inf times a 0/1 mask would be NaN), and C h^T *=
//        exp(cum_i);
//     4. y += S x with S as the register A operand (the S accumulator's
//        layout is the A fragment, keys permuted within each k8 step in
//        fp32), y stored in T;
//     5. h = exp(total) h + (x . exp(total - cum))^T b, its 16 x 8 tiles
//        dealt to the warps against their share of steps 3-4 (warp 3, the
//        longest diagonal, takes none).
//   Barriers a chunk: data landed; (fp32) b's TF32 parts in place; stage
//   and state free.  Each warp runs its own instantiation of the scan, so
//   the barriers are the non-aligned barrier.sync: the warps meet at
//   different instructions.
//
// Products.  fp32 (T = float): TF32 stays off, as in the reference; each
//   product a b is three mma.sync.m16n8k8 TF32 products, a_big b_big +
//   a_big b_small + a_small b_big, with x_big = tf32(x), x_small =
//   tf32(x - x_big) (rounded to nearest) and fp32 sums (wgmma takes TF32
//   only K-major, which x as the B operand of S x is not).  b is split
//   once a chunk for all warps (its big parts in place, its small parts
//   in a tile of their own).  The three products of a k step sum from
//   zero and are then added to their accumulator in fp32: the tensor
//   cores truncate as they add, and one chain of 24 products into an
//   accumulator as large as y's drifted past fp32's tolerance on the
//   card.  bf16 (T = bf16):
//   mma.sync.m16n8k16 with fp32 sums.  b, c and x enter as they are, so
//   C B^T is exact products summed in fp32.  Each fp32 operand enters as a
//   bf16 pair, hi = bf16(v) and lo = bf16(v - hi), two products (~2^-17 of
//   v): the decayed scores S before S x, the state (fp32 across chunks)
//   before C h^T, and x exp(total - cum_j) before the state update.  y is
//   rounded to bf16 once, at the store.  The reference rounds each of
//   those three to bf16; a single bf16 value at any one of them puts y
//   outside the bf16 tolerance of the fp64 scan at slow decay
//   (tests/test_torch_ssm_redesign_numerics.py).  Shared-memory rows are
//   padded by 16 bytes, so every fragment load (scalar, 32-bit or
//   ldmatrix) is free of bank conflicts.
//
// Shared memory: the stages of x (64 rows of PS + pad), b and c (64 rows of
//   64 + pad) and a_log, then the state (PS rows of 64 + pad; in bf16 its
//   hi and lo tiles) and in fp32 b's small parts.  fp32: 114,688 bytes,
//   two blocks an SM; bf16: 33,024 at PS 32 and 26,368 at 16, five blocks
//   an SM by their 96 registers a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kLc = 64;                  // rows per chunk
constexpr int kWarps = 4;                // warp w: chunk rows 16w .. 16w + 15
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;
constexpr double kLog2e = 1.4426950408889634;

// ------------------------------------------------------------ fp32: 3xTF32

// x rounded to TF32 (10 mantissa bits), to nearest with ties away, as
// cvt.rna.tf32.f32 rounds a finite x: the bit pattern is sign-magnitude,
// so adding half of the dropped range rounds the magnitude (two integer
// instructions, where cvt.rna compiles to several).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (tf32(x), tf32(x - tf32(x))).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const float* v, uint32_t* big,
                                       uint32_t* small) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], big[e], small[e]);
}

// d (16 x 8 fp32) += A (16 x 8 tf32) * B (8 x 8 tf32).  Per thread (g =
// lane / 4, t = lane % 4): a = (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4); b = (k t, n g), (k t + 4, n g); d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in three passes of operands split already, the small
// products first, summed from zero and then added to d in fp32 (rounded to
// nearest): the tensor cores truncate as they add, so a chain of products
// into one accumulator as large as y's drifts by about an ulp of it every
// step.
__device__ __forceinline__ void mma_3x(float* d, const uint32_t* a_big,
                                       const uint32_t* a_small, uint32_t b0_big,
                                       uint32_t b1_big, uint32_t b0_small,
                                       uint32_t b1_small) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, a_small, b0_big, b1_big);
  mma_tf32(part, a_big, b0_small, b1_small);
  mma_tf32(part, a_big, b0_big, b1_big);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += part[e];
}

// The same, splitting b.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* a_big,
                                           const uint32_t* a_small, float b0,
                                           float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split_tf32(b0, b0_big, b0_small);
  split_tf32(b1, b1_big, b1_small);
  mma_3x(d, a_big, a_small, b0_big, b1_big, b0_small, b1_small);
}

// ------------------------------------------------------------ bf16

// d (16 x 8 fp32) += A (16 x 16 bf16) * B (16 x 8 bf16): a = (g, 2t..2t+1),
// (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); b = (k 2t..2t+1, n g),
// (k 2t + 8.., n g); two bf16 a register, the lower k in the lower half.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Transposing 8 x 8 bf16 loads: lanes 8q .. 8q + 7 address the 8 rows of
// matrix q; register q of a thread holds rows 2t, 2t + 1 of column g.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
// Two fp32 values as bf16 pairs: hi = bf16(v), lo = bf16(v - hi), each a
// packed operand of its own product (v0 in the lower halves).
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                          uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  lo = pack_bf16(v0 - bf_lo(hi), v1 - bf_hi(hi));
}

// 2^x by the special-function unit alone (relative error ~2^-22; results
// below 2^-126, negligible beside the entries they sit with, flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A barrier of the whole block that the warps may reach at different
// instructions (bar.sync, which __syncthreads() emits, is .aligned: every
// thread at the same one).
__device__ __forceinline__ void block_sync() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// ------------------------------------------------------------ layout

// Shared memory, in bytes.  Rows are padded by 16 bytes: 68 floats or 72
// bf16 for b, c and the state (a row of N = 64), PS + 4 floats or PS + 8
// bf16 for x.  The fp32 state is one tile of floats; the bf16 state two
// tiles of bf16 (hi, lo).  fp32 also keeps the small TF32 parts of the
// chunk's b in a tile of their own (its big parts overwrite b in place).
template <typename T, int PS>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int LDN = 64 + kPad;           // b, c, state rows
  static constexpr int LDX = PS + kPad;           // x rows
  static constexpr int x_off = 0;
  static constexpr int b_off = x_off + kLc * LDX * (int)sizeof(T);
  static constexpr int c_off = b_off + kLc * LDN * (int)sizeof(T);
  static constexpr int a_off = c_off + kLc * LDN * (int)sizeof(T);
  static constexpr int stage = a_off + kLc * 4;
  static constexpr int stages = sizeof(T) == 4 ? 2 : 1;   // chunks held
  static constexpr int h_off = stages * stage;
  static constexpr int h_tiles = sizeof(T) == 4 ? 1 : 2;
  static constexpr int bsm_off = h_off + h_tiles * PS * LDN * (int)sizeof(T);
  static constexpr int bytes = bsm_off + (sizeof(T) == 4 ? kLc * LDN * 4 : 0);
};

// The 16 x 8 state tiles (PS / 16 row tiles x 8) warp W updates: row tile
// mt, column tiles nlo .. nlo + cnt - 1.  Warps with a short diagonal
// (fewer S tiles and S x steps) take more, so that the four warps' counts
// of products come out about even; warp 3 takes none.
template <int PS, int W>
struct StateTiles {
  static constexpr int mt = PS == 32 && W > 0 ? 1 : 0;
  static constexpr int nlo =
      (PS == 32 && W == 2) || (PS == 16 && W == 1) ? 5 : 0;
  static constexpr int cnt =
      PS == 32 ? (W == 0 ? 8 : W == 1 ? 5 : W == 2 ? 3 : 0)
               : (W == 0 ? 5 : W == 1 ? 3 : 0);
};

// The scan as warp W runs it: W is a template argument, so every loop over
// the warp's tiles has a bound the compiler knows, and the products of
// different tiles interleave (a runtime bound would put each tile's
// products behind a branch, one dependent chain after another).  All four
// warps meet at the same barriers, each at its own barrier.sync.
template <typename T, int PS, int W>
__device__ __forceinline__ void scan_warp(const T* __restrict__ x,
                                          const float* __restrict__ a_log,
                                          const T* __restrict__ bm,
                                          const T* __restrict__ cm,
                                          T* __restrict__ y,
                                          float* __restrict__ h_final, int S,
                                          int H) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NP = PS / 8;                      // n8 tiles of the slice
  constexpr int E = 16 / sizeof(T);               // elements a 16-byte copy
  constexpr int nS = 2 * W + 2;                   // S tiles up to the diagonal
  using L = Smem<T, PS>;
  using R = StateTiles<PS, W>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* hs = reinterpret_cast<T*>(smem + L::h_off);

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int i0 = 16 * W + g, i1 = i0 + 8;         // this thread's chunk rows
  const size_t row_x = (size_t)H * 64;            // x and y row stride
  const T* xb = x + ((size_t)b * S * H + h) * 64 + p0;
  const T* bb = bm + (size_t)b * S * 64;
  const T* cb = cm + (size_t)b * S * 64;
  const float* ab = a_log + (size_t)b * S * H + h;
  T* yb = y + ((size_t)b * S * H + h) * 64 + p0 + 2 * t;

  // The chunk of rows t0 .. t0 + 63 into stage st; rows past S zero-filled
  // (the source address stays valid).  Thread tid copies 16-byte column
  // chunk tid % C of rows tid / C + k 128 / C, C the chunks a row.
  auto issue = [&](int st, int t0) {
    unsigned char* base = smem + st * L::stage;
    constexpr int CX = PS / E, CN = 64 / E;
#pragma unroll
    for (int k = 0; k < kLc * CX / kThreads; ++k) {
      const int r = tid / CX + k * (kThreads / CX), cc = tid % CX;
      const bool ok = t0 + r < S;
      cp_async16(smem_u32(base + L::x_off) + (r * L::LDX + cc * E) * sizeof(T),
                 xb + (size_t)(ok ? t0 + r : 0) * row_x + cc * E, ok ? 16 : 0);
    }
#pragma unroll
    for (int k = 0; k < kLc * CN / kThreads; ++k) {
      const int r = tid / CN + k * (kThreads / CN), cc = tid % CN;
      const bool ok = t0 + r < S;
      const size_t off = (size_t)(ok ? t0 + r : 0) * 64 + cc * E;
      const uint32_t dst = (r * L::LDN + cc * E) * sizeof(T);
      cp_async16(smem_u32(base + L::b_off) + dst, bb + off, ok ? 16 : 0);
      cp_async16(smem_u32(base + L::c_off) + dst, cb + off, ok ? 16 : 0);
    }
    if (tid < kLc) {
      const int pos = t0 + tid;
      const bool ok = pos < S;
      cp_async4(smem_u32(base + L::a_off) + tid * 4,
                ab + (size_t)(ok ? pos : 0) * H, ok ? 4 : 0);
    }
  };

  float hacc[R::cnt > 0 ? R::cnt : 1][4];         // this warp's state tiles
#pragma unroll
  for (int q = 0; q < R::cnt; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[q][e] = 0.f;

  const int nchunks = (S + kLc - 1) / kLc;
  if constexpr (L::stages == 2) {
    issue(0, 0);
    cp_async_commit();
  }

  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * kLc;
    unsigned char* base = smem + (ci % L::stages) * L::stage;
    if constexpr (L::stages == 2) {               // the next chunk in flight
      if (ci + 1 < nchunks) issue((ci + 1) & 1, t0 + kLc);
      cp_async_commit();
      cp_async_wait<1>();                         // this chunk landed
    } else {                                      // the other blocks cover it
      issue(0, t0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    block_sync();
    const T* xs = reinterpret_cast<const T*>(base + L::x_off);
    const T* bs = reinterpret_cast<const T*>(base + L::b_off);
    const T* cs = reinterpret_cast<const T*>(base + L::c_off);
    const float* as = reinterpret_cast<const float*>(base + L::a_off);
    [[maybe_unused]] const float* bsm =
        reinterpret_cast<const float*>(smem + L::bsm_off);
    if constexpr (kF32) {
      // b's TF32 parts, once for all warps: big in place, small beside it
      // (thread tid: row tid / 2, columns 32 (tid % 2) ..)
      float* bw = reinterpret_cast<float*>(base + L::b_off);
      float* sw = reinterpret_cast<float*>(smem + L::bsm_off);
      const int o = (tid / 2) * L::LDN + 32 * (tid % 2);
#pragma unroll
      for (int c = 0; c < 32; c += 4) {
        float4 v = *reinterpret_cast<const float4*>(bw + o + c);
        float* e = reinterpret_cast<float*>(&v);
        float4 sm4;
        float* f = reinterpret_cast<float*>(&sm4);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t big, small;
          split_tf32(e[k], big, small);
          e[k] = __uint_as_float(big);
          f[k] = __uint_as_float(small);
        }
        *reinterpret_cast<float4*>(bw + o + c) = v;
        *reinterpret_cast<float4*>(sw + o + c) = sm4;
      }
    }

    // 1. the chunk's cumulative log decay, summed in fp64: lane l holds
    //    rows 2l, 2l + 1, in log2 units as fp32 pairs hi + lo (so that the
    //    difference of two rows keeps fp32's precision however large they
    //    are), and their exp(total - cum); dec = exp(total)
    const double v0 = as[2 * lane], v1 = as[2 * lane + 1];
    double run = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(kAll, run, o);
      if (lane >= o) run += u;
    }
    double before = __shfl_up_sync(kAll, run, 1);
    if (lane == 0) before = 0.0;
    const double l0 = (before + v0) * kLog2e, l1 = (before + v0 + v1) * kLog2e;
    const double lt = __shfl_sync(kAll, l1, 31);
    const float hi0 = (float)l0, hi1 = (float)l1;
    const float lo0 = (float)(l0 - hi0), lo1 = (float)(l1 - hi1);
    const float wd0 = exp2f((float)(lt - l0)), wd1 = exp2f((float)(lt - l1));
    const float dec = exp2f((float)lt);
    // rows i0, i1 sit in lanes src, src + 4 (the lower row if g is even)
    const int src = 8 * W + g / 2;
    float ih[2], il[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float h_even = __shfl_sync(kAll, hi0, src + 4 * r);
      const float h_odd = __shfl_sync(kAll, hi1, src + 4 * r);
      const float l_even = __shfl_sync(kAll, lo0, src + 4 * r);
      const float l_odd = __shfl_sync(kAll, lo1, src + 4 * r);
      ih[r] = (g & 1) ? h_odd : h_even;
      il[r] = (g & 1) ? l_odd : l_even;
    }

    if constexpr (kF32) block_sync();              // b's parts are in place

    // 2. S = C B^T (tiles 0 .. nS - 1) and the state's term C h^T
    float s[nS][4], yv[NP][4];
#pragma unroll
    for (int q = 0; q < nS; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[q][e] = 0.f;
#pragma unroll
    for (int q = 0; q < NP; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) yv[q][e] = 0.f;
    const bool inter = ci > 0;                    // the state is 0 before
    if constexpr (kF32) {
      const float* cr = cs + i0 * L::LDN + t;
#pragma unroll 1
      for (int kk = 0; kk < 8; ++kk) {
        const float av[4] = {cr[8 * kk], cr[8 * L::LDN + 8 * kk],
                             cr[8 * kk + 4], cr[8 * L::LDN + 8 * kk + 4]};
        uint32_t a_big[4], a_small[4];
        split4(av, a_big, a_small);
#pragma unroll
        for (int nt = 0; nt < nS; ++nt) {
          const int o = (8 * nt + g) * L::LDN + 8 * kk + t;
          const uint32_t* bg = reinterpret_cast<const uint32_t*>(bs) + o;
          const uint32_t* bl = reinterpret_cast<const uint32_t*>(bsm) + o;
          mma_3x(s[nt], a_big, a_small, bg[0], bg[4], bl[0], bl[4]);
        }
        if (inter) {
#pragma unroll
          for (int pn = 0; pn < NP; ++pn) {
            const float* hr = hs + (8 * pn + g) * L::LDN + 8 * kk + t;
            mma_3xtf32(yv[pn], a_big, a_small, hr[0], hr[4]);
          }
        }
      }
    } else {
      constexpr int WD = L::LDN / 2;              // 32-bit words a row
      const uint32_t* c32 = reinterpret_cast<const uint32_t*>(cs) + i0 * WD + t;
      const uint32_t* b32 = reinterpret_cast<const uint32_t*>(bs) + g * WD + t;
      const uint32_t* hh = reinterpret_cast<const uint32_t*>(hs) + g * WD + t;
      const uint32_t* hl = hh + PS * WD;
#pragma unroll 1
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {c32[8 * kk], c32[8 * WD + 8 * kk],
                               c32[8 * kk + 4], c32[8 * WD + 8 * kk + 4]};
#pragma unroll
        for (int nt = 0; nt < nS; ++nt) {
          const int o = 8 * nt * WD + 8 * kk;
          mma_bf16(s[nt], a, b32[o], b32[o + 4]);
        }
        if (inter) {
#pragma unroll
          for (int pn = 0; pn < NP; ++pn) {
            const int o = 8 * pn * WD + 8 * kk;
            mma_bf16(yv[pn], a, hh[o], hh[o + 4]);
            mma_bf16(yv[pn], a, hl[o], hl[o + 4]);
          }
        }
      }
    }

    // 3. decay and mask S (columns 8nt + 2t, + 1 sit in lane 4nt + t); the
    //    state's term decays from the chunk's start
#pragma unroll
    for (int nt = 0; nt < nS; ++nt) {
      const float jh[2] = {__shfl_sync(kAll, hi0, 4 * nt + t),
                           __shfl_sync(kAll, hi1, 4 * nt + t)};
      const float jl[2] = {__shfl_sync(kAll, lo0, 4 * nt + t),
                           __shfl_sync(kAll, lo1, 4 * nt + t)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, c = e % 2;     // rows i0, i1; columns j, j + 1
        const float v =
            s[nt][e] * exp2_approx((ih[r] - jh[c]) + (il[r] - jl[c]));
        // tiles left of the diagonal tiles 2W, 2W + 1 lie wholly below it
        s[nt][e] = nt < 2 * W || i0 + 8 * r >= 8 * nt + 2 * t + c ? v : 0.f;
      }
    }
    if (inter) {
      const float e0 = exp2f(ih[0] + il[0]), e1 = exp2f(ih[1] + il[1]);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        yv[pn][0] *= e0;
        yv[pn][1] *= e0;
        yv[pn][2] *= e1;
        yv[pn][3] *= e1;
      }
    }

    // 4. y += S x over the diagonal's k steps
    if constexpr (kF32) {
      // A = S with each k8 step's keys permuted (k t -> column 2t, k t + 4
      // -> 2t + 1), so B reads x rows 8kk + 2t and 8kk + 2t + 1
      const float* xr = xs + 2 * t * L::LDX + g;
#pragma unroll
      for (int kk = 0; kk < nS; ++kk) {
        const float sv[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        uint32_t s_big[4], s_small[4];
        split4(sv, s_big, s_small);
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) {
          const float* xp = xr + 8 * kk * L::LDX + 8 * pn;
          mma_3xtf32(yv[pn], s_big, s_small, xp[0], xp[L::LDX]);
        }
      }
    } else {
      // lane l addresses x row 16kk + (l & 7) + 8 ((l >> 3) & 1), columns
      // 8 (2 pair + (l >> 4)): registers b0, b1 of tiles 2 pair, 2 pair + 1
      const uint32_t xa = smem_u32(xs) +
          (((lane & 7) + 8 * ((lane >> 3) & 1)) * L::LDX + 8 * (lane >> 4)) * 2;
#pragma unroll
      for (int kk = 0; kk <= W; ++kk) {
        // A = S as a bf16 pair: tiles 2kk, 2kk + 1 are its k16 step
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* v = s[2 * kk + e / 2] + 2 * (e % 2);
          split_bf16(v[0], v[1], hi[e], lo[e]);
        }
#pragma unroll
        for (int pair = 0; pair < NP / 2; ++pair) {
          uint32_t r[4];
          ldsm_x4_t(r, xa + (16 * kk * L::LDX + 16 * pair) * 2);
          mma_bf16(yv[2 * pair], hi, r[0], r[1]);
          mma_bf16(yv[2 * pair], lo, r[0], r[1]);
          mma_bf16(yv[2 * pair + 1], hi, r[2], r[3]);
          mma_bf16(yv[2 * pair + 1], lo, r[2], r[3]);
        }
      }
    }

    // 5. y rows t0 + i0, t0 + i1, columns p0 + 8pn + 2t, + 1
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      if (t0 + i0 < S)
        store2(yb + (size_t)(t0 + i0) * row_x + 8 * pn, yv[pn][0], yv[pn][1]);
      if (t0 + i1 < S)
        store2(yb + (size_t)(t0 + i1) * row_x + 8 * pn, yv[pn][2], yv[pn][3]);
    }

    // 6. this warp's state tiles: h = exp(total) h + (x w)^T b, w_j =
    //    exp(total - cum_j) (rows 2l, 2l + 1 of lane l)
    if constexpr (R::cnt > 0) {
#pragma unroll
      for (int q = 0; q < R::cnt; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[q][e] *= dec;
      if constexpr (kF32) {
        // k t -> chunk row 8kk + 2t, k t + 4 -> 8kk + 2t + 1
        const float* xr = xs + 2 * t * L::LDX + 16 * R::mt + g;
        const int ob = 2 * t * L::LDN + 8 * R::nlo + g;
        const uint32_t* bg = reinterpret_cast<const uint32_t*>(bs) + ob;
        const uint32_t* bl = reinterpret_cast<const uint32_t*>(bsm) + ob;
#pragma unroll 1
        for (int kk = 0; kk < 8; ++kk) {
          const float w0 = __shfl_sync(kAll, wd0, 4 * kk + t);
          const float w1 = __shfl_sync(kAll, wd1, 4 * kk + t);
          const float* xk = xr + 8 * kk * L::LDX;
          const float av[4] = {xk[0] * w0, xk[8] * w0, xk[L::LDX] * w1,
                               xk[L::LDX + 8] * w1};
          uint32_t a_big[4], a_small[4];
          split4(av, a_big, a_small);
#pragma unroll
          for (int q = 0; q < R::cnt; ++q) {
            const int o = 8 * kk * L::LDN + 8 * q;
            mma_3x(hacc[q], a_big, a_small, bg[o], bg[o + L::LDN], bl[o],
                   bl[o + L::LDN]);
          }
        }
      } else {
        // A = x^T by ldmatrix.trans: lane l addresses x row 16kk + (l & 7)
        // + 8 (l >> 4), columns 16 mt + 8 ((l >> 3) & 1); B = b rows 16kk +
        // (l & 7) + 8 ((l >> 3) & 1), columns 8 (nlo + q)
        const uint32_t xa = smem_u32(xs) +
            (((lane & 7) + 8 * (lane >> 4)) * L::LDX + 16 * R::mt +
             8 * ((lane >> 3) & 1)) * 2;
        const uint32_t ba = smem_u32(bs) +
            (((lane & 7) + 8 * ((lane >> 3) & 1)) * L::LDN + 8 * R::nlo) * 2;
#pragma unroll 1
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[4], hi[4], lo[4];
          ldsm_x4_t(a, xa + 16 * kk * L::LDX * 2);
          // registers 0, 1 hold rows 16kk + 2t, + 1; 2, 3 rows + 8
          const float w0 = __shfl_sync(kAll, wd0, 8 * kk + t);
          const float w1 = __shfl_sync(kAll, wd1, 8 * kk + t);
          const float w2 = __shfl_sync(kAll, wd0, 8 * kk + 4 + t);
          const float w3 = __shfl_sync(kAll, wd1, 8 * kk + 4 + t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_bf16(bf_lo(a[e]) * (e < 2 ? w0 : w2),
                       bf_hi(a[e]) * (e < 2 ? w1 : w3), hi[e], lo[e]);
#pragma unroll
          for (int q = 0; q < R::cnt; ++q) {
            uint32_t bq[2];
            ldsm_x2_t(bq, ba + (16 * kk * L::LDN + 8 * q) * 2);
            mma_bf16(hacc[q], hi, bq[0], bq[1]);
            mma_bf16(hacc[q], lo, bq[0], bq[1]);
          }
        }
      }
    }

    block_sync();                                 // stage and state free
    // the state for the next chunk's C h^T: rows 16 mt + g (+ 8), columns
    // 8 (nlo + q) + 2t, + 1
    if (ci + 1 < nchunks) {
#pragma unroll
      for (int q = 0; q < R::cnt; ++q) {
        const int col = 8 * (R::nlo + q) + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * R::mt + g + 8 * half;
          const float v0 = hacc[q][2 * half], v1 = hacc[q][2 * half + 1];
          if constexpr (kF32) {
            store2(hs + row * L::LDN + col, v0, v1);
          } else {
            uint32_t hi, lo;
            split_bf16(v0, v1, hi, lo);
            *reinterpret_cast<uint32_t*>(hs + row * L::LDN + col) = hi;
            *reinterpret_cast<uint32_t*>(hs + (PS + row) * L::LDN + col) = lo;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // h_final[b][h][p0 + p][n]
  float* hf = h_final + ((size_t)(b * H + h) * 64 + p0) * 64;
#pragma unroll
  for (int q = 0; q < R::cnt; ++q) {
    const int col = 8 * (R::nlo + q) + 2 * t, row = 16 * R::mt + g;
    store2(hf + row * 64 + col, hacc[q][0], hacc[q][1]);
    store2(hf + (row + 8) * 64 + col, hacc[q][2], hacc[q][3]);
  }
}

template <typename T, int PS>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 5)
ssm_scan_tc_kernel(const T* __restrict__ x, const float* __restrict__ a_log,
                   const T* __restrict__ bm, const T* __restrict__ cm,
                   T* __restrict__ y, float* __restrict__ h_final, int S,
                   int H) {
  static_assert(PS == 16 || PS == 32, "P-slices of 16 or 32 columns");
  switch (threadIdx.x / 32) {                     // warp-uniform
    case 0: scan_warp<T, PS, 0>(x, a_log, bm, cm, y, h_final, S, H); break;
    case 1: scan_warp<T, PS, 1>(x, a_log, bm, cm, y, h_final, S, H); break;
    case 2: scan_warp<T, PS, 2>(x, a_log, bm, cm, y, h_final, S, H); break;
    default: scan_warp<T, PS, 3>(x, a_log, bm, cm, y, h_final, S, H); break;
  }
}

template <typename T, int PS>
int launch(const void* x, const void* a_log, const void* b, const void* c,
           void* y, void* h_final, int B, int S, int H, cudaStream_t st) {
  using L = Smem<T, PS>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_tc_kernel<T, PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssm_scan_tc_kernel<T, PS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  ssm_scan_tc_kernel<T, PS><<<dim3(64 / PS, H, B), kThreads, L::bytes, st>>>(
      (const T*)x, (const float*)a_log, (const T*)b, (const T*)c, (T*)y,
      (float*)h_final, S, H);
  return (int)cudaGetLastError();
}

// bf16: P-slices of 16 where B H is below the SM count, else of 32.
int launch_bf16(const void* x, const void* a_log, const void* b,
                const void* c, void* y, void* h_final, int B, int S, int H,
                cudaStream_t st) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  if ((long)B * H < sms)
    return launch<__nv_bfloat16, 16>(x, a_log, b, c, y, h_final, B, S, H, st);
  return launch<__nv_bfloat16, 32>(x, a_log, b, c, y, h_final, B, S, H, st);
}

}  // namespace

// dtype codes shared with kernels/ssm_scan.py
enum { kFloat32 = 0, kBFloat16 = 1 };

extern "C" {

// x (B,S,H,P) and y in the dtype; a_log (B,S,H) fp32; b, c (B,S,N) in the
// dtype; h_final (B,H,P,N) fp32.  (P, N) = (64, 64) only.
int ssm_scan_fwd(const void* x, const void* a_log, const void* b,
                 const void* c, void* y, void* h_final, int B, int S, int H,
                 int P, int N, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P != 64 || N != 64) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch<float, 32>(x, a_log, b, c, y, h_final, B, S, H, st);
  if (dtype == kBFloat16)
    return launch_bf16(x, a_log, b, c, y, h_final, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
