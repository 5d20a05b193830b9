// Chunked gated linear scan at a wide state, (P, N) = (1025, 1024): the
// mLSTM's prompt pass (xlstm-1.3b: head dim 1024, its value rows and the
// normalizer's ones-channel), on Hopper (sm_90a), behind a plain C entry
// point that returns cudaGetLastError().
//
// ssm_wide_scores_kernel<T> + ssm_wide_walk_kernel<T>  replace
//   ssm_scan_pallas (src/repro/kernels/ssm_scan.py:57, pl.pallas_call :74)
//   at the width the mLSTM calls the shared chunked scan with
//   (src/repro/models/xlstm.py:414-429: heads folded into the batch,
//   P = hd + 1, N = hd), the chunked form of
//       h_t = exp(a_log_t) h_{t-1} + x_t (x) b_t,    y_t = h_t . c_t,
//   from a zero state, per (batch row, head).  x (B,S,H,P) and y in T
//   (float32 or bfloat16), a_log (B,S,H) fp32, b and c (B,S,N) in T,
//   h_final (B,H,P,N) fp32.  The (64, 64) scan of csrc/ssm_scan.cu cannot
//   take this width: one 64-row chunk of b and c alone is 256 KiB in bf16,
//   over the 227 KiB a block may hold, and one (row, head) state is 1025 x
//   1024 fp32 = 4.2 MB.
//
// Bound.  At 4 prompts x 4 heads x 512 tokens the scan needs ~35.5 GFLOP
//   (the chunked form at its cheapest chunk) against 134 MB of x, a_log,
//   b, c, y and h_final in bf16 (201 MB in fp32): in bf16 the bytes bound
//   it (0.040 ms), in fp32 the operations (0.215 ms at TF32's rate x 3,
//   0.53 ms at the CUDA cores' 67 TFLOP/s).
//
// Design.  Two kernels on the caller's stream:
//   1. ssm_wide_scores_kernel, one block a (batch row, head, 64-row
//      chunk), all chunks in parallel: the chunk's decayed scores
//      G = (C B^T) * exp(segsum) (64 x 64, 0 above the diagonal; C B^T in
//      fp64 on the CUDA cores, streamed through shared memory in 32-column
//      tiles of N, a 4 x 4 register tile a thread), and the chunk's
//      decays exp(cum_i), exp(total - cum_j) and exp(total) in fp64, the
//      cumulative log decay summed in fp64.  G does not depend on the
//      state, so it is computed once, not in every P-slice.  Into a
//      workspace the wrapper allocates: 64 x 64 floats and 129 doubles a
//      chunk.
//   2. ssm_wide_walk_kernel, one block a (P-slice of 16 rows of the state,
//      head, batch row), walking the chunks in order with its 16 x 1024
//      fp32 state slice in shared memory (64 KiB, stored n-major).  Per
//      chunk: the x slice (64 x 16, loaded one element at a time: a row of
//      x is P = 1025 elements, so it is not 16-byte aligned) and x scaled
//      by exp(total - cum_j) in fp64; then, over 64-column tiles of N (C
//      and B through shared memory, the next tile's loads in flight in
//      registers), on the tensor cores, y's state term C h^T (3xTF32
//      mma.sync m16n8k8; warp w chunk rows 16 (w % 4) .., state rows
//      8 (w / 4) ..) and the state update h = exp(total) h +
//      (x exp(total - cum))^T B (fp64 mma.sync m8n8k4; warp w the tile's
//      columns 8w .. 8w + 7), each tile's old state read before it is
//      overwritten; then y = exp(cum_i) (C h^T) + G x in fp64 on the CUDA
//      cores, rounded to T once and stored one element at a time.  The
//      last slice holds one row (1025 = 64 x 16 + 1: the normalizer
//      channel); rows past P are zero and not stored.
//
// Precision.  The fp32 tolerance (2e-5, absolute where y is near 0) is
//   tight beside this width's sums: y runs to ~170 at the mLSTM's decay,
//   and an fp32 chain of 64 or 1024 terms drifts by ~sqrt(n) half-ulps of
//   its partial sums (measured 4.6e-5 over 8.4 M outputs with every sum in
//   fp32).  So the sums whose error reaches y are fp64: C B^T, the state
//   update's 64 products (an fp32 rounding of a state entry enters y
//   through 1024 products), the 32-column partial sums of C h^T, G x and
//   the decays.  Each partial sum of C h^T stays fp32: 3xTF32 products
//   (big x big + big x small + small x big, each part tf32-rounded to
//   nearest), each k8 step's three summed from zero and then added in
//   fp32, since the tensor cores truncate as they add (ssm_scan.cu); the
//   state is fp32, rounded once a chunk.  Rows past S are zero-filled
//   with a_log 0, so a ragged last chunk adds nothing and decays nothing.
//
// Shared memory: scores kernel 34,304 bytes (static); walk kernel 115,712
//   bytes (dynamic): two blocks an SM, the SM's 228 KiB exactly.  Rows are
//   padded so that the mma operands' loads are free of bank conflicts
//   (x w 20 doubles, C 68 floats, B 72 floats); the state's B operand of
//   C h^T meets 2-way conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "load_f32.cuh"

namespace {

constexpr int kLc = 64;                  // rows per chunk
constexpr int kP = 1025;                 // state rows (x and y columns)
constexpr int kN = 1024;                 // state columns (b and c width)
constexpr int kPS = 16;                  // state rows a walk block owns
constexpr int kNT = 64;                  // N columns a walk tile
constexpr int kLD = kNT + 4;             // padded row of the walk's C tile
constexpr int kST = 32;                  // N columns a scores tile
constexpr int kSLD = kST + 1;            // padded row of a scores tile
constexpr int kThreads = 256;
constexpr int kDec = 2 * kLc + 1;        // exp(cum), exp(total - cum), exp(total)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, double v) { *p = (float)v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, double v) {
  *p = __double2bfloat16(v);
}

// N contiguous elements of a row of b or c into floats; rows past S are
// zeros.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ row, bool ok,
                                         float* v) {
  if (ok) {
    load_f32<T, N>(row, v);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = 0.f;
  }
}

// ---------------------------------------------------------------- scores

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_wide_scores_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
                       const float* __restrict__ a_log, float* __restrict__ g,
                       double* __restrict__ dec, int S, int H) {
  __shared__ double cs[kLc * kSLD];
  __shared__ double bs[kLc * kSLD];
  __shared__ double cum[kLc];
  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int t0 = ci * kLc;
  const size_t chunk = ((size_t)b * H + h) * nc + ci;

  // the chunk's cumulative log decay in fp64 (rows past S add 0)
  if (tid == 0) {
    double run = 0.0;
    for (int r = 0; r < kLc; ++r) {
      if (t0 + r < S) run += (double)a_log[((size_t)b * S + t0 + r) * H + h];
      cum[r] = run;
    }
  }

  // C B^T: thread (ri, cj) sums rows ri + 16a of C against rows cj + 16c
  // of B; tile loads: row lr, columns lc .. lc + 7
  const int ri = tid / 16, cj = tid % 16;
  const int lr = tid / 4, lc = 8 * (tid % 4);
  const bool ok = t0 + lr < S;
  const size_t roff = ((size_t)b * S + (ok ? t0 + lr : 0)) * kN + lc;
  double acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0;
  for (int n0 = 0; n0 < kN; n0 += kST) {
    float cv[8], bv[8];
    load_row<T, 8>(cm + roff + n0, ok, cv);
    load_row<T, 8>(bm + roff + n0, ok, bv);
    __syncthreads();                              // the last tile is read
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cs[lr * kSLD + lc + k] = cv[k];
      bs[lr * kSLD + lc + k] = bv[k];
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < kST; ++n) {
      double cr[4], br[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cr[a] = cs[(ri + 16 * a) * kSLD + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) br[c] = bs[(cj + 16 * c) * kSLD + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fma(cr[a], br[c], acc[a][c]);
    }
  }

  // G_ij = (C B^T)_ij exp(cum_i - cum_j) for j <= i, 0 above the diagonal
  float* gout = g + chunk * (kLc * kLc);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ri + 16 * a, j = cj + 16 * c;
      gout[i * kLc + j] = j <= i ? (float)(acc[a][c] * exp(cum[i] - cum[j]))
                                 : 0.f;
    }
  double* d = dec + chunk * kDec;
  if (tid < kLc) {
    d[tid] = exp(cum[tid]);
    d[kLc + tid] = exp(cum[kLc - 1] - cum[tid]);
  }
  if (tid == 0) d[2 * kLc] = exp(cum[kLc - 1]);
}

// ---------------------------------------------------------------- walk

// x rounded to TF32 (10 mantissa bits), to nearest with ties away, and x
// as a pair (tf32(x), tf32(x - tf32(x))): the split of ssm_scan.cu's
// 3xTF32 products.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
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

// d (8 x 8 fp64) += a (8 x 4) * b (4 x 8) on the fp64 tensor cores.  Per
// thread (g = lane / 4, t = lane % 4): a = A[g][t], b = B[t][g], d = D[g][2t],
// D[g][2t + 1].
__device__ __forceinline__ void mma_f64(double* d, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

constexpr int kXLD = kPS + 4;            // padded row of x w, in doubles
constexpr int kBLD = kNT + 8;            // padded row of the B tile

struct WalkSmem {                                  // offsets in bytes
  static constexpr int xw = 0;                     // [kLc][kXLD] double
  static constexpr int hs = xw + kLc * kXLD * 8;   // [kN][kPS] float state
  static constexpr int ct = hs + kN * kPS * 4;     // [kLc][kLD] C, then G
  static constexpr int bt = ct + kLc * kLD * 4;    // [kLc][kBLD] B
  static constexpr int xs = bt + kLc * kBLD * 4;   // [kLc][kPS] x
  static constexpr int bytes = xs + kLc * kPS * 4;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssm_wide_walk_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ g,
                     const double* __restrict__ dec, T* __restrict__ y,
                     float* __restrict__ h_final, int S, int H) {
  using M = WalkSmem;
  extern __shared__ __align__(16) unsigned char smem[];
  double* xw = reinterpret_cast<double*>(smem + M::xw);
  float* hs = reinterpret_cast<float*>(smem + M::hs);
  float* ct = reinterpret_cast<float*>(smem + M::ct);
  float* bt = reinterpret_cast<float*>(smem + M::bt);
  float* xs = reinterpret_cast<float*>(smem + M::xs);
  const int p0 = blockIdx.x * kPS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int nc = (S + kLc - 1) / kLc;
  // thread roles: tile loads, row lr, columns lc .. lc + 15; C h^T and G x,
  // warp w the chunk rows 16 (w % 4) .. and the state rows 8 (w / 4) ..;
  // the update, warp w the tile's columns 8w .. 8w + 7
  const int lr = tid / 4, lc = 16 * (tid % 4);

  for (int e = tid; e < kN * kPS; e += kThreads) hs[e] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * kLc;
    const size_t chunk = ((size_t)b * H + h) * nc + ci;
    const double* dch = dec + chunk * kDec;       // the chunk's decays
    const bool ok = t0 + lr < S;
    const size_t roff = ((size_t)b * S + (ok ? t0 + lr : 0)) * kN + lc;
    float cv[16], bv[16];                         // the next tile in flight
    load_row<T, 16>(cm + roff, ok, cv);
    load_row<T, 16>(bm + roff, ok, bv);
    __syncthreads();                              // the last chunk is done
    for (int e = tid; e < kLc * kPS; e += kThreads) {
      const int j = e / kPS, p = e % kPS;
      const float v =
          t0 + j < S && p0 + p < kP
              ? to_f32(x[(((size_t)b * S + t0 + j) * H + h) * kP + p0 + p])
              : 0.f;
      xs[e] = v;
      xw[j * kXLD + p] = (double)v * __ldg(dch + kLc + j);
    }
    const double dc = __ldg(dch + 2 * kLc);

    // (C h^T) at rows i0, i0 + 8 (i0 = 16 (warp % 4) + gq), state rows
    // pc, pc + 1 (pc = 8 (warp / 4) + 2 tq), in the mma's order
    double ya[4] = {0.0, 0.0, 0.0, 0.0};
    for (int n0 = 0; n0 < kN; n0 += kNT) {
      // the last tile's reads of ct and bt ended at its state barrier, the
      // last chunk's at the chunk's first barrier
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        ct[lr * kLD + lc + k] = cv[k];
        bt[lr * kBLD + lc + k] = bv[k];
      }
      __syncthreads();
      if (n0 + kNT < kN) {
        load_row<T, 16>(cm + roff + n0 + kNT, ok, cv);
        load_row<T, 16>(bm + roff + n0 + kNT, ok, bv);
      }
      if (ci > 0) {                               // the state is 0 before
        // C h^T's tile (16 x 8: rows 16 (warp % 4) .., state rows 8 (warp
        // / 4) ..) as 3xTF32 products, each k8 step's three summed from
        // zero and added in fp32 (the tensor cores truncate as they add),
        // every 32 columns into the fp64 sums
        const float* cr = ct + (16 * (warp % 4) + gq) * kLD + tq;
        const float* hr = hs + (n0 + tq) * kPS + 8 * (warp / 4) + gq;
#pragma unroll
        for (int half = 0; half < kNT; half += kNT / 2) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = half; kk < half + kNT / 2; kk += 8) {
            uint32_t a_big[4], a_small[4], b_big[2], b_small[2];
            split_tf32(cr[kk], a_big[0], a_small[0]);
            split_tf32(cr[8 * kLD + kk], a_big[1], a_small[1]);
            split_tf32(cr[kk + 4], a_big[2], a_small[2]);
            split_tf32(cr[8 * kLD + kk + 4], a_big[3], a_small[3]);
            split_tf32(hr[kk * kPS], b_big[0], b_small[0]);
            split_tf32(hr[(kk + 4) * kPS], b_big[1], b_small[1]);
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(part, a_small, b_big[0], b_big[1]);
            mma_tf32(part, a_big, b_small[0], b_small[1]);
            mma_tf32(part, a_big, b_big[0], b_big[1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[e] += part[e];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) ya[e] += acc[e];
        }
      }
      // the update's products: U (16 x 8) = (x w)^T B[:, 8 warp ..], on the
      // fp64 tensor cores, rows gq and 8 + gq, columns 2 tq, 2 tq + 1
      double u[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll 4
      for (int j0 = 0; j0 < kLc; j0 += 4) {
        const double bj = bt[(j0 + tq) * kBLD + 8 * warp + gq];
        const double* wr = xw + (j0 + tq) * kXLD + gq;
        mma_f64(u[0], wr[0], bj);
        mma_f64(u[1], wr[8], bj);
      }
      __syncthreads();                            // the tile's old state read
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float* hp = hs + (n0 + 8 * warp + 2 * tq + i) * kPS + 8 * mt + gq;
          *hp = (float)fma(dc, (double)*hp, u[mt][i]);
        }
    }

    // G into the C tile's place (its last reads were before the barrier
    // above), then y = exp(cum_i) (C h^T) + G x
    const float4* gin =
        reinterpret_cast<const float4*>(g + chunk * (kLc * kLc));
    for (int e = tid; e < kLc * kLc / 4; e += kThreads) {
      const float4 v = gin[e];
      float* dst = ct + (e / 16) * kLD + 4 * (e % 16);
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    __syncthreads();
    const int i0 = 16 * (warp % 4) + gq, pc = 8 * (warp / 4) + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      const double e0 = __ldg(dch + i);
      double yv[2] = {ya[2 * r] * e0, ya[2 * r + 1] * e0};
      for (int j = 0; j <= i; ++j) {              // G is 0 above the diagonal
        const double gv = ct[i * kLD + j];
        const float2 xv = *reinterpret_cast<const float2*>(xs + j * kPS + pc);
        yv[0] = fma(gv, (double)xv.x, yv[0]);
        yv[1] = fma(gv, (double)xv.y, yv[1]);
      }
      if (t0 + i < S) {
        T* yr = y + (((size_t)b * S + t0 + i) * H + h) * kP + p0 + pc;
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (p0 + pc + k < kP) store(yr + k, yv[k]);
      }
    }
  }
  __syncthreads();

  // h_final[b][h][p0 + p][n]
  float* hf = h_final + ((size_t)b * H + h) * kP * kN;
  for (int e = tid; e < kPS * kN; e += kThreads) {
    const int p = e / kN, n = e % kN;
    if (p0 + p < kP) hf[(size_t)(p0 + p) * kN + n] = hs[n * kPS + p];
  }
}

template <typename T>
int launch(const void* x, const void* a_log, const void* b, const void* c,
           void* y, void* h_final, void* work, int B, int S, int H,
           cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssm_wide_walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WalkSmem::bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssm_wide_walk_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int nc = (S + kLc - 1) / kLc;
  float* g = static_cast<float*>(work);
  double* dec = reinterpret_cast<double*>(g + (size_t)B * H * nc * kLc * kLc);
  ssm_wide_scores_kernel<T><<<dim3(nc, H, B), kThreads, 0, st>>>(
      (const T*)b, (const T*)c, (const float*)a_log, g, dec, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssm_wide_walk_kernel<T>
      <<<dim3((kP + kPS - 1) / kPS, H, B), kThreads, WalkSmem::bytes, st>>>(
          (const T*)x, (const T*)b, (const T*)c, g, dec, (T*)y,
          (float*)h_final, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes shared with kernels/ssm_scan.py
enum { kFloat32 = 0, kBFloat16 = 1 };

extern "C" {

// x (B,S,H,P) and y in the dtype; a_log (B,S,H) fp32; b, c (B,S,N) in the
// dtype; h_final (B,H,P,N) fp32; work: B H ceil(S / 64) (64 x 64 + 2 x 129)
// floats (per chunk its decayed scores, then per chunk its 129 decays in
// fp64).  (P, N) = (1025, 1024) only; S >= 1.
int ssm_scan_wide_fwd(const void* x, const void* a_log, const void* b,
                      const void* c, void* y, void* h_final, void* work, int B,
                      int S, int H, int P, int N, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P != kP || N != kN || S < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch<float>(x, a_log, b, c, y, h_final, work, B, S, H, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, a_log, b, c, y, h_final, work, B, S, H,
                                 st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
