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
// x reproduces dist.quant's decode bit for bit.
//
// Bound: operations.  2*M*K*N flops against x, codes and scales read once:
// at M = 2048 (batch 4 x 512) every llama2-7b projection is far above the
// card's flops-per-byte line, at the fp32 CUDA-core rate (this kernel does
// not use the tensor cores; bf16 x is widened to fp32).
//
// Design.  The TPU kernel holds one (K, 128) column block of the decoded
// weight in VMEM per grid step and feeds the MXU.  A Hopper SM has 227 KB of
// shared memory, so here each block computes a 128 x 128 tile of out and
// walks K in steps of 16: it stages an x tile (transposed, padded against
// bank conflicts) and a 16 x 128 weight tile decoded straight from the codes
// and scales in HBM into shared memory — no decoded weight ever reaches HBM.
// A block's 128 columns are exactly one lane tile, so each thread needs one
// scale per weight row it decodes.  The NF4 codebook sits in shared memory:
// its 16 entries fill 16 banks, so a gather of them never conflicts.  Each of
// the 256 threads accumulates an 8 x 8 sub-tile in registers with fp32 FMAs
// (two float4 loads of x and two of w per 64 FMAs).  Ragged M, K and N are
// bounds checks: out-of-range x and w read as 0, and an odd NF4 width's pad
// nibble (code 7) is never read.  Tensor cores (mma/wgmma for bf16), TMA,
// and decoding into registers are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float load_x(const float* x, long long i) {
  return x[i];
}
__device__ __forceinline__ float load_x(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ void store_out(float* o, long long i, float v) {
  o[i] = v;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* o, long long i,
                                          float v) {
  o[i] = __float2bfloat16_rn(v);
}

template <bool kRoundBf16>
__device__ __forceinline__ float decode(float code, float scale) {
  const float w = __fmul_rn(code, scale);
  return kRoundBf16 ? __bfloat162float(__float2bfloat16_rn(w)) : w;
}

// kFmt: 0 int8, 1 nf4.  kTileRows: rows of W per scale (1 or 8).
template <int kFmt, int kTileRows, typename XT, bool kRoundBf16>
__global__ void __launch_bounds__(kThreads, 2)
dequant_matmul_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ q,
                      const float* __restrict__ s, XT* __restrict__ out,
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
      xs[c][r] = (gm < M && gk < K) ? load_x(x, (long long)gm * K + gk) : 0.f;
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
      if (gn < N) store_out(out, (long long)gm * N + gn, acc[i][j]);
    }
  }
}

template <int kFmt, int kTileRows, typename XT, bool kRoundBf16>
int launch(const void* x, const void* q, const void* s, void* out, int m,
           int k, int n, int ldq, int lds, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  dequant_matmul_kernel<kFmt, kTileRows, XT, kRoundBf16>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const XT*>(x), static_cast<const uint8_t*>(q),
          static_cast<const float*>(s), static_cast<XT*>(out), m, k, n, ldq,
          lds);
  return (int)cudaGetLastError();
}

template <int kFmt, int kTileRows>
int dispatch_dtype(int x_bf16, int round_bf16, const void* x, const void* q,
                   const void* s, void* out, int m, int k, int n, int ldq,
                   int lds, cudaStream_t st) {
  if (x_bf16)   // bf16 x: the decoded weight always rounds through bf16
    return launch<kFmt, kTileRows, __nv_bfloat16, true>(x, q, s, out, m, k, n,
                                                        ldq, lds, st);
  if (round_bf16)
    return launch<kFmt, kTileRows, float, true>(x, q, s, out, m, k, n, ldq,
                                                lds, st);
  return launch<kFmt, kTileRows, float, false>(x, q, s, out, m, k, n, ldq,
                                               lds, st);
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
