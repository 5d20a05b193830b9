// Chunked gated linear scan (the Mamba2 SSD core), written by hand for
// Hopper (sm_90a) behind a plain C entry point that returns
// cudaGetLastError().
//
// ssm_scan_kernel  replaces ssm_scan_pallas
//   (src/repro/kernels/ssm_scan.py:57, _ssm_kernel :21), the chunked form of
//       h_t = exp(a_log_t) h_{t-1} + x_t (x) b_t,    y_t = h_t . c_t,
//   from a zero state, per (batch row, head).  x (B,S,H,P) and y in T
//   (float32 or bfloat16), a_log (B,S,H) fp32, b and c (B,S,N) in T,
//   h_final (B,H,P,N) fp32.  The arithmetic is fp32 (the chunk's cumulative
//   log-decay fp64); y is rounded to T once, at the store (the reference's
//   jnp scan rounds every product to T).
//
//   Bound.  At zamba2-2.7b's prefill (B 4, S 512, H 80, P = N = 64) the
//   scan needs ~3.0 GFLOP (the chunked form at its cheapest chunk, 8 rows:
//   the masked half of C B^T and of its product with x, C h^T, the state
//   update) against ~90 MB of x, y and h_final in fp32 (~48 MB in bf16):
//   operations bound it in fp32 on the CUDA cores (~0.045 ms at
//   67 TFLOP/s), bytes in bf16 (~0.014 ms).  Its 64-row chunks do ~4.1
//   GFLOP.  This first version keeps every product on the CUDA cores in
//   fp32.
//
//   Design.  On the TPU the chunks were a sequential fori_loop with the
//   state in VMEM scratch; here one block per (head, batch row) walks its
//   chunks in a loop and keeps the 64 x 64 fp32 state in shared memory
//   from chunk to chunk.  Per chunk of kLc = 64 rows:
//     1. x, b (row-major) and b, c (transposed) into shared memory as
//        fp32; rows past S are zeros, with a_log = 0, so a ragged last
//        chunk adds nothing to the state and decays nothing;
//     2. warp 0 scans a_log (in fp64): cum, exp(cum), exp(total - cum),
//        exp(total);
//     3. scores[i][j] = (c_i . b_j) exp(cum_i - cum_j) for j <= i, else 0,
//        by a select: above the diagonal the exponent is positive and may
//        overflow, and an inf times a 0/1 mask would be NaN;
//     4. y_i = sum_j scores[i][j] x_j + exp(cum_i) (h c_i), the entering
//        state's term read before the update;
//     5. h = exp(total) h + sum_j exp(total - cum_j) x_j (x) b_j.
//   Each product is a 64 x 64 output over a 16 x 16 thread grid, 4 x 4
//   outputs a thread, operands read as float4 from shared memory (a
//   broadcast or 16 consecutive words a quarter-warp, free of bank
//   conflicts).  b and c are read per batch row, never broadcast per head
//   in device memory (the Pallas wrapper materialises them per head).
//   Shared memory: six 64 x 64 fp32 tiles and three 64-vectors, 99,328
//   bytes of dynamic shared memory (above the default 48 KB, hence the
//   attribute): two blocks fit an SM.  The grid is only B*H blocks (320 at
//   batch 4, 80 at batch 1: fewer than the 132 SMs); splitting P across
//   blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "load_f32.cuh"

namespace {

constexpr int kLc = 64;          // rows per chunk
constexpr int kThreads = 256;    // a 16 x 16 grid of 4 x 4 output tiles

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Dynamic shared memory, in floats.
template <int P, int N>
struct Smem {
  static constexpr int xs = 0;                   // [kLc][P]  x rows
  static constexpr int bs = xs + kLc * P;        // [kLc][N]  b rows
  static constexpr int bT = bs + kLc * N;        // [N][kLc]  b transposed
  static constexpr int cT = bT + N * kLc;        // [N][kLc]  c transposed
  static constexpr int hT = cT + N * kLc;        // [N][P]    state h[p][n] at hT[n][p]
  static constexpr int sT = hT + N * P;          // [kLc][kLc] scores[i][j] at sT[j][i]
  static constexpr int cum = sT + kLc * kLc;     // [kLc] doubles (8-byte aligned)
  static constexpr int ecum = cum + 2 * kLc;     // exp(cum)
  static constexpr int wdec = ecum + kLc;        // exp(total - cum)
  static constexpr int dec = wdec + kLc;         // exp(total), one float
  static constexpr int floats = dec + 4;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ a_log,
                const T* __restrict__ bm, const T* __restrict__ cm,
                T* __restrict__ y, float* __restrict__ h_final, int S, int H) {
  static_assert(P == 64 && N == 64 && kLc == 64,
                "4 x 4 tiles of a 16 x 16 thread grid cover 64 x 64");
  using L = Smem<P, N>;
  constexpr int V = 16 / sizeof(T);                 // elements per 16 bytes
  extern __shared__ __align__(16) float sm[];
  float* xs = sm + L::xs;
  float* bs = sm + L::bs;
  float* bT = sm + L::bT;
  float* cT = sm + L::cT;
  float* hT = sm + L::hT;
  float* sT = sm + L::sT;
  double* cum = reinterpret_cast<double*>(sm + L::cum);
  float* ecum = sm + L::ecum;
  float* wdec = sm + L::wdec;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int i = tid; i < N * P; i += kThreads) hT[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kLc) {
    __syncthreads();                     // the last chunk's readers are done
    // 1. x and b rows, row-major (a warp reads and writes whole rows)
    for (int w = tid; w < kLc * P / V; w += kThreads) {
      const int r = w / (P / V), col = (w % (P / V)) * V;
      float v[V] = {};
      if (t0 + r < S) load_f32<T, V>(x + ((size_t)(b * S + t0 + r) * H + h) * P + col, v);
#pragma unroll
      for (int e = 0; e < V; e += 4) store4(xs + r * P + col + e, v + e);
    }
    for (int w = tid; w < kLc * N / V; w += kThreads) {
      const int r = w / (N / V), col = (w % (N / V)) * V;
      float v[V] = {};
      if (t0 + r < S) load_f32<T, V>(bm + (size_t)(b * S + t0 + r) * N + col, v);
#pragma unroll
      for (int e = 0; e < V; e += 4) store4(bs + r * N + col + e, v + e);
    }
    //    b and c transposed (consecutive threads take consecutive rows, so
    //    the scattered stores land in distinct banks)
    for (int w = tid; w < kLc * N / V; w += kThreads) {
      const int r = w % kLc, col = (w / kLc) * V;
      float vb[V] = {}, vc[V] = {};
      if (t0 + r < S) {
        const size_t off = (size_t)(b * S + t0 + r) * N + col;
        load_f32<T, V>(bm + off, vb);
        load_f32<T, V>(cm + off, vc);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        bT[(col + e) * kLc + r] = vb[e];
        cT[(col + e) * kLc + r] = vc[e];
      }
    }
    if (tid < kLc)
      cum[tid] = t0 + tid < S ? a_log[(size_t)(b * S + t0 + tid) * H + h] : 0.0;
    __syncthreads();

    // 2. inclusive scan of a_log over the chunk, two rows a lane, in fp64:
    //    exp(cum_i - cum_j) from fp32 prefix sums loses ~1e-4 of relative
    //    precision where |cum| nears 1000 (the published init's fast heads
    //    reach that within a chunk); the 64 adds cost nothing
    if (tid < 32) {
      const double v0 = cum[2 * tid], v1 = cum[2 * tid + 1];
      double s = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += u;
      }
      double before = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) before = 0.0;
      const double c0 = before + v0, c1 = c0 + v1;
      const double total = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * tid] = c0;
      cum[2 * tid + 1] = c1;
      ecum[2 * tid] = expf((float)c0);
      ecum[2 * tid + 1] = expf((float)c1);
      wdec[2 * tid] = expf((float)(total - c0));
      wdec[2 * tid + 1] = expf((float)(total - c1));
      if (tid == 0) sm[L::dec] = expf((float)total);
    }
    __syncthreads();

    // 3. scores, tile rows i0 = 4 tx, columns j0 = 4 ty; tiles wholly above
    //    the diagonal are never read (step 4 stops at its own diagonal)
    {
      const int i0 = 4 * tx, j0 = 4 * ty;
      if (ty <= tx) {
        float acc[4][4] = {};
#pragma unroll 8
        for (int n = 0; n < N; ++n) {
          const float4 c4 = lds4(cT + n * kLc + i0);
          const float4 b4 = lds4(bT + n * kLc + j0);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] += cv[r] * bv[k];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + k;
          float out[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + r;
            out[r] = i >= j ? acc[r][k] * expf((float)(cum[i] - cum[j])) : 0.f;
          }
          store4(sT + j * kLc + i0, out);
        }
      }
    }
    __syncthreads();

    // 4. y rows i0 = 4 ty, columns p0 = 4 tx
    {
      const int i0 = 4 * ty, p0 = 4 * tx;
      float acc[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < i0 + 4; ++j) {
        const float4 s4 = lds4(sT + j * kLc + i0);
        const float4 x4 = lds4(xs + j * P + p0);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += sv[r] * xv[q];
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float4 c4 = lds4(cT + n * kLc + i0);
        const float4 h4 = lds4(hT + n * P + p0);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) inter[r][q] += cv[r] * hv[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + i0 + r;
        if (t < S) {
          const float e = ecum[i0 + r];
          float out[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) out[q] = acc[r][q] + e * inter[r][q];
          store4(y + ((size_t)(b * S + t) * H + h) * P + p0, out);
        }
      }
    }
    __syncthreads();

    // 5. state, columns p0 = 4 tx, state dims n0 = 4 ty; each thread
    //    updates only the entries it owns
    {
      const int p0 = 4 * tx, n0 = 4 * ty;
      float acc[4][4] = {};
#pragma unroll 8
      for (int j = 0; j < kLc; ++j) {
        const float4 x4 = lds4(xs + j * P + p0);
        const float4 b4 = lds4(bs + j * N + n0);
        const float w = wdec[j];
        const float bw[4] = {b4.x * w, b4.y * w, b4.z * w, b4.w * w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[k][q] += bw[k] * xv[q];
      }
      const float dec = sm[L::dec];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float* row = hT + (n0 + k) * P + p0;
        const float4 old = lds4(row);
        const float nv[4] = {dec * old.x + acc[k][0], dec * old.y + acc[k][1],
                             dec * old.z + acc[k][2], dec * old.w + acc[k][3]};
        store4(row, nv);
      }
    }
  }
  __syncthreads();

  // h_final[b][h][p][n] = hT[n][p]: transpose through a padded tile (the
  // free x and b rows) so both the shared reads and the device writes are
  // consecutive
  float* tile = sm + L::xs;                          // [P][N + 1]
  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P, p = i % P;
    tile[p * (N + 1) + n] = hT[i];
  }
  __syncthreads();
  float* out = h_final + (size_t)(b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    out[i] = tile[p * (N + 1) + n];
  }
}

template <typename T, int P, int N>
int launch(const void* x, const void* a_log, const void* b, const void* c,
           void* y, void* h_final, int B, int S, int H, cudaStream_t st) {
  using L = Smem<P, N>;
  static_assert(P * (N + 1) <= 2 * kLc * P, "the final transpose fits xs and bs");
  auto kernel = ssm_scan_kernel<T, P, N>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kernel<<<dim3(H, B), kThreads, L::bytes, st>>>(
      (const T*)x, (const float*)a_log, (const T*)b, (const T*)c, (T*)y,
      (float*)h_final, S, H);
  return (int)cudaGetLastError();
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
    return launch<float, 64, 64>(x, a_log, b, c, y, h_final, B, S, H, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, 64, 64>(x, a_log, b, c, y, h_final, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
