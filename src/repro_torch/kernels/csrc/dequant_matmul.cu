// Matrix product against a codec-encoded weight, written by hand for Hopper
// (sm_90a), behind a plain C entry point that returns cudaGetLastError().
//
// dequant_matmul  replaces fused_dequant_matmul
//                 (src/repro/kernels/fused_dequant_matmul.py:64, pl.pallas_call :102)
//
// What it computes: out (M, N) = x (M, K) @ dequant(W) (K, N), fp32
// accumulation, out in x's dtype.  W is a codec view (src/repro_torch/dist/
// quant.py, QuantView):
//   int8:  w[k][n] = float(q[k][n]) * s[k / R][n / 128]
//   nf4:   w[k][n] = book[nibble(q[k][n / 2], n % 2)] * s[k / R][n / 128]
//          (low nibble first, the 16-entry QLoRA codebook)
// with R the scale tile rows: 1 for a 2-d leaf (the Pallas kernel's only
// contract), 8 for one layer of a stacked (L, K, N) leaf.  Each decoded
// value is one rounded fp32 product (__fmul_rn), then rounds through bf16
// when the template or x is bf16 — the reference's dequantize_leaf cast to
// the template dtype and the model's w.astype(x.dtype) — so a one-hot row of
// x reproduces dist.quant's decode bit for bit.  No decoded weight ever
// reaches HBM: each block decodes its tile of W into shared memory.
//
// Bound: operations.  2*M*K*N flops against x, codes and scales read once:
// at M = 2048 (batch 4 x 512) every llama2-7b projection is far above the
// card's flops-per-byte line.  Two kernels:
//
// dequant_matmul_wgmma_kernel  bf16 x, on the tensor cores (989 TFLOP/s;
//   0.0695 ms at 2048 x 4096 x 4096): bf16 x times the bf16-rounded
//   decoded weight, summed in fp32, as the MXU computes it for the
//   reference.  A block computes a 128 x 128 tile of out with two
//   warpgroups, each issuing wgmma.m64n128k16 (A = its 64 rows of x, B =
//   the decoded tile, both from shared memory) over K steps of 64.  What
//   holds it back is not the products but feeding them: x is re-read from
//   L2 by every column block, and the decode runs on the CUDA cores.  So x
//   comes in by cp.async into a three-stage ring in the 128-byte swizzled
//   K-major layout wgmma reads, the raw codes and scales a step ahead of x
//   into their own ring, and the codes of step kt + 1 are decoded into the
//   other of two B buffers (N-major, 128-byte swizzled: the transpose bit)
//   while the warpgroups' products of step kt run, one __syncthreads a
//   step; two blocks share an SM, so one block's decode also overlaps the
//   other's products.  The decode is cheap per value: int8 takes its float
//   from an exponent trick instead of a conversion instruction, and NF4
//   reads it from a per-row table of the 16 bf16 products (one multiply
//   and rounding per row and code, not per value).  x or codes whose rows
//   are not whole 16-byte words (K not a multiple of 8, a code row not a
//   multiple of 16 bytes; the ragged test shapes, no llama2-7b shape) come
//   in by plain loads into the same layout.
//
// dequant_matmul_kernel  fp32 x, on the CUDA cores (TF32 stays off, as in
//   the reference; 67 TFLOP/s).  The TPU kernel holds one (K, 128) column
//   block of the decoded weight in VMEM per grid step and feeds the MXU.
//   Here each block computes a 128 x 128 tile of out and walks K in steps
//   of 16: it stages an x tile (transposed, padded against bank conflicts)
//   and a 16 x 128 weight tile decoded straight from the codes and scales
//   in HBM into shared memory.  Each of the 256 threads accumulates an
//   8 x 8 sub-tile in registers with fp32 FMAs (two float4 loads of x and
//   two of w per 64 FMAs).
//
// Shared by both: each decoded row of a 128-column lane tile needs one
// scale.  NF4 lookups (the codebook, or a row's table) sit in shared
// memory: 16 entries fill 16 banks, so a gather never conflicts.  Ragged
// M, K and N are bounds checks: out-of-range x and w read as 0, and an odd
// NF4 width's pad nibble is never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;     // one lane tile of the scale grid
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.3344709873199463f, 0.42563003301620483f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};


template <bool kRoundBf16>
__device__ __forceinline__ float decode(float code, float scale) {
  const float w = __fmul_rn(code, scale);
  return kRoundBf16 ? __bfloat162float(__float2bfloat16_rn(w)) : w;
}

// kFmt: 0 int8, 1 nf4.  kTileRows: rows of W per scale (1 or 8).
template <int kFmt, int kTileRows, bool kRoundBf16>
__global__ void __launch_bounds__(kThreads, 2)
dequant_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
                      const float* __restrict__ s, float* __restrict__ out,
                      int M, int K, int N, int ldq, int lds) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];
  __shared__ __align__(16) float ws[kBK][kBN];
  __shared__ float book[16];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  if (kFmt == 1 && tid < 16) book[tid] = kNF4[tid];
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int wk = tid / 16;          // weight row this thread decodes
  const int wn = (tid % 16) * 8;    // and its 8 columns
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0.f;
    }
    float v[8];
    const int gk = k0 + wk;
    if (gk < K) {
      const float sc = s[(long long)(gk / kTileRows) * lds + blockIdx.x];
      if (kFmt == 0) {
        const int8_t* row =
            reinterpret_cast<const int8_t*>(q) + (long long)gk * ldq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gn = n0 + wn + j;
          v[j] = gn < N ? decode<kRoundBf16>((float)row[gn], sc) : 0.f;
        }
      } else {
        const uint8_t* row = q + (long long)gk * ldq;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const int gn = n0 + wn + j;     // even: both nibbles of one byte
          const unsigned byte = gn < N ? row[gn >> 1] : 0x77u;
          v[j] = gn < N ? decode<kRoundBf16>(book[byte & 0xFu], sc) : 0.f;
          v[j + 1] =
              gn + 1 < N ? decode<kRoundBf16>(book[byte >> 4], sc) : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    *reinterpret_cast<float4*>(&ws[wk][wn]) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&ws[wk][wn + 4]) =
        make_float4(v[4], v[5], v[6], v[7]);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn < N) out[(long long)gm * N + gn] = acc[i][j];
    }
  }
}

// ------------------------------------------------- bf16 x, tensor cores

// d (64 x 128 fp32, the wgmma accumulator layout) += A (64 x 16 bf16,
// K-major in shared memory) * B (16 x 128 bf16, N-major in shared memory:
// the transpose bit).
__device__ __forceinline__ void wgmma_m64n128k16_bt(float* d, uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

constexpr int kTcBM = 128;                      // two warpgroups of 64 rows
constexpr int kTcBN = 128;                      // one lane tile of scales
constexpr int kTcBK = 64;                       // one 128-byte swizzle row
constexpr int kTcThreads = 256;
constexpr int kTcXBytes = kTcBM * kTcBK * 2;    // 16 KB a stage, 3 stages
constexpr int kTcWBytes = kTcBK * kTcBN * 2;    // 16 KB a buffer, 2
constexpr int kTcCBytes = kTcBK * kTcBN;        // 8 KB a stage, 3 stages
constexpr int kTcSmem = 3 * kTcXBytes + 2 * kTcWBytes + 3 * kTcCBytes +
                        3 * kTcBK * 4 + kTcBK * 32 +
                        1024;                   // + alignment slack

// Shared-memory layouts (each tile 1024-byte aligned, 128-byte rows, the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8): SWIZZLE_128B):
//   x stage     128 rows (m) of 64 k: K-major, the A operand;
//   B buffer    2 atoms of 64 rows (k) of 64 columns: N-major, read with
//               the transpose bit (atoms 8 KB apart, 8-row groups 1 KB);
//   code stage  64 rows of the block's 128 (int8) or 64 (NF4) code bytes,
//               plain; scale stage, one a row;
//   NF4 tables  for each decoded row, the 16 codebook values times the
//               row's scale, rounded to bf16.
// Two blocks fit an SM (registers capped at 128 a thread).
template <int kFmt, int kTileRows, bool kAligned>
__global__ void __launch_bounds__(kTcThreads, 2)
dequant_matmul_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                            const uint8_t* __restrict__ q,
                            const float* __restrict__ s,
                            __nv_bfloat16* __restrict__ out, int M, int K,
                            int N, int ldq, int lds) {
  constexpr int kRowBytes = kFmt == 0 ? kTcBN : kTcBN / 2;  // codes a row
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  const uint32_t raw = smem_u32(tc_smem_raw);
  unsigned char* xs = tc_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* ws = xs + 3 * kTcXBytes;
  uint8_t* cs = ws + 2 * kTcWBytes;
  float* ss = reinterpret_cast<float*>(cs + 3 * kTcCBytes);
  uint32_t* tables = reinterpret_cast<uint32_t*>(ss + 3 * kTcBK);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kTcBN, m0 = blockIdx.y * kTcBM;
  const int nk = (K + kTcBK - 1) / kTcBK;
  const int ch = tid % 8;                  // its 16-byte chunk of a B row
  // NF4: the codebook entries 2 ch and 2 ch + 1, whose products with each
  // row's scale this thread writes into that row's table.
  const float book0 = kNF4[(2 * ch) & 15], book1 = kNF4[(2 * ch + 1) & 15];

  // x of step kt into x stage kt % 3.
  auto load_x = [&](int kt) {
    unsigned char* xd = xs + (kt % 3) * kTcXBytes;
    const int k0 = kt * kTcBK;
    for (int c = tid; c < kTcBM * 8; c += kTcThreads) {
      const int r = c / 8, cc = c % 8;
      const int gm = m0 + r, gk = k0 + cc * 8;
      unsigned char* dst = xd + r * 128 + ((cc ^ (r & 7)) << 4);
      if (kAligned) {
        const bool ok = gm < M && gk < K;
        cp_async16(smem_u32(dst), ok ? x + (size_t)gm * K + gk : x,
                   ok ? 16 : 0);
      } else {
        const uint16_t* xr = reinterpret_cast<const uint16_t*>(x);
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k2 = gk + 2 * e;
          const uint32_t lo =
              gm < M && k2 < K ? xr[(size_t)gm * K + k2] : 0u;
          const uint32_t hi =
              gm < M && k2 + 1 < K ? xr[(size_t)gm * K + k2 + 1] : 0u;
          w[e] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };
  // Raw codes and scales of step kt into code stage kt % 3.
  auto load_codes = [&](int kt) {
    uint8_t* cd = cs + (kt % 3) * kTcCBytes;
    const int k0 = kt * kTcBK;
    const int cb0 = kFmt == 0 ? n0 : n0 / 2;   // the block's first code byte
    for (int c = tid; c < kTcBK * (kRowBytes / 16); c += kTcThreads) {
      const int r = c / (kRowBytes / 16), col = (c % (kRowBytes / 16)) * 16;
      const int gk = k0 + r, gb = cb0 + col;
      if (kAligned) {
        const bool ok = gk < K && gb < ldq;
        cp_async16(smem_u32(cd + r * kTcBN + col),
                   ok ? q + (size_t)gk * ldq + gb : q, ok ? 16 : 0);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (gk < K && gb + e < ldq)
            w[e / 4] |= (uint32_t)q[(size_t)gk * ldq + gb + e] << (8 * (e % 4));
        *reinterpret_cast<uint4*>(cd + r * kTcBN + col) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    if (tid < kTcBK) {
      const int gk = k0 + tid;
      float* sd = ss + (kt % 3) * kTcBK + tid;
      const bool ok = gk < K;
      const float* src = s + (size_t)(gk / kTileRows) * lds + blockIdx.x;
      if (kAligned)
        cp_async4(smem_u32(sd), ok ? src : s, ok ? 4 : 0);
      else
        *sd = ok ? *src : 0.f;
    }
  };
  // Step kt's raw codes -> B buffer kt & 1.  Thread t decodes rows t / 8
  // and t / 8 + 32, in each atom the 8 columns of chunk t % 8 (the 8
  // threads of a row, all in one warp, store to 8 distinct chunks).  Each
  // value is one rounded product of its code and its row's scale, rounded
  // to bf16; rows past K and columns past N are 0.  int8 takes its float
  // from the exponent trick (2^23 + 2^22 + code, less the same), not a
  // conversion instruction; NF4 looks each value up in the row's 16-entry
  // table of bf16 products, which the row's 8 threads fill first (one
  // multiply and rounding a row and code, not a value).
  auto decode = [&](int kt) {
    const uint8_t* cd = cs + (kt % 3) * kTcCBytes;
    const float* sd = ss + (kt % 3) * kTcBK;
    unsigned char* wd = ws + (kt & 1) * kTcWBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tid / 8 + 32 * i;
      const int gk = kt * kTcBK + r;
      const float sc = sd[r];
      const uint16_t* table =
          reinterpret_cast<const uint16_t*>(tables + r * 8);
      if (kFmt == 1) {
        __syncwarp();                          // last step's reads are done
        tables[r * 8 + ch] =
            pack_bf16(__fmul_rn(book0, sc), __fmul_rn(book1, sc));
        __syncwarp();
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int c0 = 64 * a + 8 * ch;       // column in the block
        uint32_t p[4];
        if (kFmt == 0) {
          const uint2 rw =
              *reinterpret_cast<const uint2*>(cd + r * kTcBN + c0);
          const uint32_t u[2] = {rw.x, rw.y};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float w[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int b = 2 * j + e;
              const int code = (int32_t)(u[b / 4] << (24 - 8 * (b % 4))) >> 24;
              w[e] = __fmul_rn(__int_as_float(0x4B400000 + code) - 12582912.0f,
                               sc);
            }
            p[j] = pack_bf16(w[0], w[1]);
          }
        } else {
          const uint32_t u =
              *reinterpret_cast<const uint32_t*>(cd + r * kTcBN + c0 / 2);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t byte = (u >> (8 * j)) & 0xFFu;
            p[j] = (uint32_t)table[byte & 0xFu] |
                   ((uint32_t)table[byte >> 4] << 16);
          }
        }
        if (gk >= K || n0 + c0 + 8 > N) {     // a ragged edge: zero the rest
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gn = n0 + c0 + 2 * j;
            const uint32_t keep = (gk < K && gn < N ? 0xFFFFu : 0u) |
                                  (gk < K && gn + 1 < N ? 0xFFFF0000u : 0u);
            p[j] &= keep;
          }
        }
        *reinterpret_cast<uint4*>(wd + a * (kTcBK * 128) + r * 128 +
                                  ((ch ^ (r & 7)) << 4)) =
            make_uint4(p[0], p[1], p[2], p[3]);
      }
    }
  };

  const int wg = warp / 4;                   // rows 64 * wg of the tile
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // The prologue's two groups, then the loop's group at step kt - 2, carry
  // x of step kt and the codes of step kt + 1: x leads by two steps, the
  // codes by three (they are decoded a step before their product).
  load_x(0);
  load_codes(0);
  if (1 < nk) load_codes(1);
  cp_async_commit();
  if (1 < nk) load_x(1);
  if (2 < nk) load_codes(2);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  decode(0);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<1>();        // x of step kt, codes of step kt + 1
    fence_proxy_async();       // cp.async and decode stores -> wgmma reads
    __syncthreads();
    if (kt + 2 < nk) load_x(kt + 2);
    if (kt + 3 < nk) load_codes(kt + 3);
    cp_async_commit();

    const uint32_t xa = smem_u32(xs + (kt % 3) * kTcXBytes + wg * 64 * 128);
    const uint32_t wa = smem_u32(ws + (kt & 1) * kTcWBytes);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)    // 16 k a step: 32 B of A,
      wgmma_m64n128k16_bt(acc, wg_desc(xa + 32 * kk, 16, 1024),  // 16 rows
                          wg_desc(wa + 2048 * kk, kTcBK * 128, 1024));  // of B
    wg_commit();
    decode(kt + 1);            // on the CUDA cores, beside the products (past
    wg_wait0();                // the last step: rows past K, zeros, unread)
  }
  fence_regs<64>(acc);

  // Accumulator layout: warp w of the warpgroup owns rows 16 w .. 16 w + 15;
  // register 4 j + e holds row 16 w + lane / 4 + 8 (e / 2), column
  // 8 j + 2 (lane % 4) + e % 2.
  const int row_a = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < kTcBN / 8; ++j) {
    const int col = n0 + 8 * j + cq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      if (row >= M || col >= N) continue;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      __nv_bfloat16* o = out + (size_t)row * N + col;
      if (N % 2 == 0) {                     // col even: a 4-byte pair
        *reinterpret_cast<uint32_t*>(o) = pack_bf16(v0, v1);
      } else {
        o[0] = __float2bfloat16_rn(v0);
        if (col + 1 < N) o[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int kFmt, int kTileRows, bool kRoundBf16>
int launch(const void* x, const void* q, const void* s, void* out, int m,
           int k, int n, int ldq, int lds, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  dequant_matmul_kernel<kFmt, kTileRows, kRoundBf16>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const float*>(x), static_cast<const uint8_t*>(q),
          static_cast<const float*>(s), static_cast<float*>(out), m, k, n,
          ldq, lds);
  return (int)cudaGetLastError();
}

template <int kFmt, int kTileRows, bool kAligned>
int launch_tc(const void* x, const void* q, const void* s, void* out, int m,
              int k, int n, int ldq, int lds, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        dequant_matmul_wgmma_kernel<kFmt, kTileRows, kAligned>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((n + kTcBN - 1) / kTcBN, (m + kTcBM - 1) / kTcBM);
  dequant_matmul_wgmma_kernel<kFmt, kTileRows, kAligned>
      <<<grid, kTcThreads, kTcSmem, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const uint8_t*>(q), static_cast<const float*>(s),
          static_cast<__nv_bfloat16*>(out), m, k, n, ldq, lds);
  return (int)cudaGetLastError();
}

template <int kFmt, int kTileRows>
int dispatch_dtype(int x_bf16, int round_bf16, const void* x, const void* q,
                   const void* s, void* out, int m, int k, int n, int ldq,
                   int lds, cudaStream_t st) {
  if (x_bf16) {  // bf16 x: the decoded weight always rounds through bf16
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                         k % 8 == 0 && ldq % 16 == 0;
    return aligned ? launch_tc<kFmt, kTileRows, true>(x, q, s, out, m, k, n,
                                                      ldq, lds, st)
                   : launch_tc<kFmt, kTileRows, false>(x, q, s, out, m, k, n,
                                                       ldq, lds, st);
  }
  if (round_bf16)
    return launch<kFmt, kTileRows, true>(x, q, s, out, m, k, n, ldq, lds, st);
  return launch<kFmt, kTileRows, false>(x, q, s, out, m, k, n, ldq, lds, st);
}

}  // namespace

extern "C" {

// x (m, k) row-major, fp32 (x_bf16 = 0) or bf16; q (k, ldq) int8 (fmt 0,
// ldq = n) or packed nf4 (fmt 1, ldq = ceil(n / 2)); s (ceil(k / tile_rows),
// lds = ceil(n / 128)) fp32; out (m, n) in x's dtype.  round_bf16: round each
// decoded weight through bf16 (a bf16 template).
int dequant_matmul(const void* x, const void* q, const void* s, void* out,
                   int m, int k, int n, int ldq, int lds, int fmt,
                   int tile_rows, int x_bf16, int round_bf16, void* stream) {
  if (m < 0 || k < 0 || n < 0 || (fmt != 0 && fmt != 1) ||
      (tile_rows != 1 && tile_rows != 8))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fmt == 0)
    return tile_rows == 1
               ? dispatch_dtype<0, 1>(x_bf16, round_bf16, x, q, s, out, m, k,
                                      n, ldq, lds, st)
               : dispatch_dtype<0, 8>(x_bf16, round_bf16, x, q, s, out, m, k,
                                      n, ldq, lds, st);
  return tile_rows == 1
             ? dispatch_dtype<1, 1>(x_bf16, round_bf16, x, q, s, out, m, k, n,
                                    ldq, lds, st)
             : dispatch_dtype<1, 8>(x_bf16, round_bf16, x, q, s, out, m, k, n,
                                    ldq, lds, st);
}

}  // extern "C"
