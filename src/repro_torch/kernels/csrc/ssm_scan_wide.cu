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
//      workspace the wrapper allocates (G's rows padded to 68 floats, 16
//      bytes aligned), from which the walk reads them through L2.
//   2. ssm_wide_walk_kernel, 33 blocks a (head, batch row), walking the
//      chunks in order.  Blocks 0..31 each own 32 rows of the state, a
//      32 x 1024 fp32 slice in shared memory (128 KiB, n-major, the rows
//      swizzled by n so that every access below is free of bank
//      conflicts): one block an SM.  In each, a producer warp streams the
//      chunk's C and then its B, 64 x 64 tiles of each, into a ring of
//      shared-memory stages (4 in fp32, 8 in bf16: the shared memory the
//      state and x leave) with cp.async, 16 bytes a lane, rows past S
//      zero-filled (one cp.async.bulk a row took ~3 us a tile: the copy
//      engine's cost per request), under mbarriers (full: the producer's
//      copies landed; empty: the 8 consumer warps read it).
//      The 8 consumer warps take each tile as it lands, with no barrier per
//      tile: per chunk (i) y's state term C h^T (64 x 32 over 1024
//      columns; warp w the chunk rows 16 (w % 4) .., the state rows
//      16 (w / 4) ..), (ii) y = exp(cum_i) (C h^T) + G x in fp64 on the
//      CUDA cores, rounded to T once, (iii) after one barrier among the 8
//      warps (the old state is read), the state update h = exp(total) h +
//      (x exp(total - cum))^T B tile by tile (warp w the state rows
//      16 (w % 2) .., the tile's columns 16 (w / 2) ..; its A operand,
//      x exp(total - cum) split in two, held in registers for the chunk).
//      x (64 x 32 a chunk; a row of 1025 elements is not 16-byte aligned)
//      is loaded one element a thread into registers a chunk ahead, and
//      kept in fp64.  Block 32 walks the normalizer row (row 1024) alone
//      on the CUDA cores in fp64: C h^T, G x and the update over C and B
//      read straight from L2, cheaper than a 32-row slice that streams
//      all of C and B for one row.
//   What bounds it now: compute, not L2 (with no copy at all the walk
//   keeps ~80 % of its time, tools/wide_scan_variants.py): it issues ~4
//   other instructions (operand loads and TF32 splits) for each mma.sync
//   with 2 warps a scheduler (288 threads cap a thread at 168 registers),
//   so it reaches ~13 % of the fp32 bound (PERF.md, row 8w).  Sharing
//   each tile across a cluster by TMA multicast was slower.
//
// Precision.  The fp32 tolerance (2e-5, absolute where y is near 0) is
//   tight beside this width's sums: y runs to ~170 at the mLSTM's decay,
//   and an fp32 chain of 64 or 1024 terms drifts by ~sqrt(n) half-ulps of
//   its partial sums.  So the sums whose error reaches y most are fp64:
//   C B^T, G x, the decays and the 32-column partial sums of C h^T; a
//   state update's 8 k-step partials are summed in fp32 and the state
//   updated by one fp32 fma with exp(total) rounded to fp32 (in fp64
//   their conversions took ~15 % of the walk and bought no accuracy the
//   tolerance sees).  The products run on the tensor cores as TF32
//   mma.sync m16n8k8: in fp32 three passes (big x big, big x small, small
//   x big, each part tf32-rounded to nearest), in bf16 two, since a bf16
//   value is exact in TF32 (C x small(h), C x big(h); small(xw) x B,
//   big(xw) x B); each k8 step's passes summed from zero, since the
//   tensor cores truncate as they add (ssm_scan.cu).  The state is fp32,
//   rounded once a chunk.  tests/test_torch_wide_scan_numerics.py models
//   this arithmetic at full width against the reference and fp64.  Rows
//   past S are zeros with a_log 0: they add nothing to the state, and
//   their y is not stored.
//
// Shared memory: scores kernel 34,304 bytes (static); walk kernel 221,248
//   bytes in fp32, 221,312 in bf16 (dynamic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "load_f32.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kLc = 64;                  // rows per chunk
constexpr int kP = 1025;                 // state rows (x and y columns)
constexpr int kN = 1024;                 // state columns (b and c width)
constexpr int kPS = 32;                  // state rows a walk block owns
constexpr int kSlices = kN / kPS;        // 32 slices, then the normalizer
constexpr int kNT = 64;                  // N columns a tile
constexpr int kTiles = kN / kNT;         // tiles of C, then of B, a chunk
constexpr int kConsumers = 256;          // 8 warps of products
constexpr int kWalkThreads = kConsumers + 32;   // and a producer warp
constexpr int kST = 32;                  // N columns a scores tile
constexpr int kSLD = kST + 1;            // padded row of a scores tile
constexpr int kScoresThreads = 256;
constexpr int kDec = 2 * kLc + 1;        // exp(cum), exp(total - cum), exp(total)
constexpr int kGLD = kLc + 4;            // row of G: 272 bytes, 16-aligned

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
__global__ void __launch_bounds__(kScoresThreads)
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
  float* gout = g + chunk * (kLc * kGLD);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ri + 16 * a, j = cj + 16 * c;
      gout[i * kGLD + j] = j <= i ? (float)(acc[a][c] * exp(cum[i] - cum[j]))
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
// 3xTF32 products; an fp64 value splits from its fp32 rounding, its small
// part from the fp64 remainder.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}
__device__ __forceinline__ void split_tf32(double x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna((float)x);
  small = tf32_rna((float)(x - (double)__uint_as_float(big)));
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

// ---- mbarriers and copies (the ring's producer and consumers)

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Wait for the phase of the given parity to complete.  A wait that lasts
// ~2^35 cycles (seconds) means a lost arrival: trap, so that the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}
// An arrival on `bar` once every cp.async this thread issued has landed
// (the barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// The 8 consumer warps only (the producer warp runs on).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// The state slice, [n][p] with the rows of each n swizzled: (n, p) at
// n * 32 + (p ^ 8 (n % 4)).  A warp's 8 rows p (g) by 4 columns n (t, or
// t + 4) then fall on 32 banks.
__device__ __forceinline__ int hidx(int n, int p) {
  return n * kPS + (p ^ ((n & 3) << 3));
}

template <typename T>
struct WalkSmem {                                      // offsets in bytes
  static constexpr int ldc = sizeof(T) == 4 ? kNT + 4 : kNT + 8;  // C row
  static constexpr int ldb = kNT + 8;                             // B row
  static constexpr int stage = kLc * ldb * (int)sizeof(T);
  static constexpr int stages = sizeof(T) == 4 ? 4 : 8;           // the ring
  static constexpr int hs = 0;                         // [kN][kPS] fp32
  static constexpr int ring = hs + kN * kPS * 4;       // the ring's tiles
  static constexpr int xs = ring + stages * stage;     // [kLc][kPS] x fp64
  static constexpr int bars = xs + kLc * kPS * 8;      // full[], empty[]
  static constexpr int bytes = bars + 2 * stages * 8;
};

// Block kSlices: the normalizer row (row kN) walked on the CUDA cores in
// fp64, C and B read from L2, its state row fp32 in shared memory; the
// 8 consumer warps only.
template <typename T>
__device__ void normalizer_walk(const T* __restrict__ x,
                                const T* __restrict__ bm,
                                const T* __restrict__ cm,
                                const float* __restrict__ g,
                                const double* __restrict__ dec,
                                T* __restrict__ y, float* __restrict__ h_final,
                                int S, int H, unsigned char* smem) {
  float* hn = reinterpret_cast<float*>(smem);               // [kN]
  double* xv = reinterpret_cast<double*>(smem + kN * 4);    // [kLc] x
  double* xw = xv + kLc;                    // [kLc] x exp(total - cum)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + kLc - 1) / kLc;
  for (int n = tid; n < kN; n += kConsumers) hn[n] = 0.f;
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * kLc, rows = min(kLc, S - t0);
    const size_t chunk = ((size_t)b * H + h) * nc + ci;
    const double* dch = dec + chunk * kDec;
    const float* gch = g + chunk * (kLc * kGLD);
    if (tid < kLc) {
      const size_t row = (size_t)b * S + t0 + tid;
      const double v =
          tid < rows ? (double)to_f32(x[(row * H + h) * kP + kN]) : 0.0;
      xv[tid] = v;
      xw[tid] = v * dch[kLc + tid];
    }
    consumer_sync();                // x in place
    // y_i = exp(cum_i) (C_i . h) + sum_j G_ij x_j: warp w rows 8w .. 8w + 7,
    // each lane 4 columns of every 128
    for (int r = 0; r < kLc / 8; ++r) {
      const int i = (kLc / 8) * warp + r;
      if (i >= rows) break;
      double ch = 0.0;
      if (ci > 0) {
        const T* crow = cm + ((size_t)b * S + t0 + i) * kN + 4 * lane;
#pragma unroll
        for (int k = 0; k < kN / 128; ++k) {
          float cv[4];
          load_f32<T, 4>(crow + 128 * k, cv);
          const int n = 128 * k + 4 * lane;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ch = fma((double)cv[e], (double)hn[n + e], ch);
        }
      }
      double v = ch * dch[i];
      for (int j = lane; j <= i; j += 32)
        v = fma((double)gch[i * kGLD + j], xv[j], v);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0)
        store(y + (((size_t)b * S + t0 + i) * H + h) * kP + kN, v);
    }
    consumer_sync();                // every read of the old state is done
    // h = exp(total) h + sum_j xw_j B_j: thread tid columns 4 tid .. + 3
    const double dc = dch[2 * kLc];
    double u[4] = {0.0, 0.0, 0.0, 0.0};
    const T* brow = bm + ((size_t)b * S + t0) * kN + 4 * tid;
#pragma unroll 8
    for (int j = 0; j < rows; ++j) {
      float bv[4];
      load_f32<T, 4>(brow + (size_t)j * kN, bv);
#pragma unroll
      for (int e = 0; e < 4; ++e) u[e] = fma(xw[j], (double)bv[e], u[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* hp = hn + 4 * tid + e;
      *hp = (float)fma(dc, (double)*hp, u[e]);
    }
    consumer_sync();                // every read of xw is done
  }
  float* hf = h_final + (((size_t)b * H + h) * kP + kN) * kN;
  for (int n = tid; n < kN; n += kConsumers) hf[n] = hn[n];
}

template <typename T>
__global__ void __launch_bounds__(kWalkThreads, 1)
ssm_wide_walk_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ g,
                     const double* __restrict__ dec, T* __restrict__ y,
                     float* __restrict__ h_final, int S, int H) {
  using M = WalkSmem<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (blockIdx.x == kSlices) {                    // the normalizer row
    if (warp < kConsumers / 32)
      normalizer_walk<T>(x, bm, cm, g, dec, y, h_final, S, H, smem);
    return;
  }
  float* hs = reinterpret_cast<float*>(smem + M::hs);
  double* xs = reinterpret_cast<double*>(smem + M::xs);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + M::bars);
  uint64_t* empty = full + M::stages;
  const int p0 = blockIdx.x * kPS, h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + kLc - 1) / kLc;

  // a zero state
  for (int e = tid; e < kN * kPS / 4; e += kWalkThreads)
    reinterpret_cast<float4*>(hs)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == 0) {
    for (int s = 0; s < M::stages; ++s) {
      mbar_init(&full[s], 32);              // the producer's 32 lanes
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {                  // the producer warp
    int s = 0;
    uint32_t ph = 0;
    for (int ci = 0; ci < nc; ++ci) {
      const int t0 = ci * kLc, rows = min(kLc, S - t0);
      constexpr int kPieceElems = 16 / (int)sizeof(T);
      constexpr int kPieces = kNT / kPieceElems;  // 16-byte pieces a row
      for (int m = 0; m < 2; ++m) {               // C's tiles, then B's
        const T* src = (m == 0 ? cm : bm) + ((size_t)b * S + t0) * kN;
        const int ld = m == 0 ? M::ldc : M::ldb;
        for (int tile = 0; tile < kTiles; ++tile) {
          if (lane == 0) mbar_wait(&empty[s], ph ^ 1);
          __syncwarp();
          const uint32_t dst = smem_u32(smem + M::ring + s * M::stage);
          // 16 bytes a lane and copy, a row's 16-byte pieces on
          // neighbouring lanes; rows past S zero-filled
#pragma unroll 4
          for (int q = lane; q < kLc * kPieces; q += 32) {
            const int r = q / kPieces, c = q % kPieces;
            cp_async16(dst + (r * ld + c * kPieceElems) * (int)sizeof(T),
                       src + (size_t)(r < rows ? r : 0) * kN + tile * kNT +
                           c * kPieceElems,
                       r < rows ? 16 : 0);
          }
          cp_async_arrive(&full[s]);
          if (++s == M::stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers (g = lane / 4, t = lane % 4 as in mma_tf32)
  const int gq = lane / 4, tq = lane % 4;
  // x of a chunk, a warp a row of 32: element tid + 256 k, in registers a
  // chunk ahead
  constexpr int kXR = kLc * kPS / kConsumers;
  float xr[kXR];
  auto load_x = [&](int ci) {
#pragma unroll
    for (int k = 0; k < kXR; ++k) {
      const int e = tid + kConsumers * k, row = ci * kLc + e / kPS;
      xr[k] = row < S
                  ? to_f32(x[(((size_t)b * S + row) * H + h) * kP + p0 +
                             e % kPS])
                  : 0.f;
    }
  };
  load_x(0);
  int s = 0;
  uint32_t ph = 0;
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * kLc;
    consumer_sync();                // the last chunk's state and x are done
#pragma unroll
    for (int k = 0; k < kXR; ++k) xs[tid + kConsumers * k] = (double)xr[k];
    consumer_sync();
    if (ci + 1 < nc) load_x(ci + 1);

    // (i) C h^T: warp w rows 16 (w % 4) + gq (+ 8), state rows 16 (w / 4) +
    // 8 nt + gq as the B operand; the accumulator's columns 2 tq, 2 tq + 1
    // are state rows 16 (w / 4) + 8 nt + 2 tq (+ 1)
    double ya[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[nt][e] = 0.0;
    for (int tile = 0; tile < kTiles; ++tile) {
      mbar_wait(&full[s], ph);
      if (ci > 0) {                               // the state is 0 before
        const T* cr =
            reinterpret_cast<const T*>(smem + M::ring + s * M::stage) +
            (16 * (warp % 4) + gq) * M::ldc + tq;
        const int n0 = tile * kNT + tq;
#pragma unroll
        for (int half = 0; half < kNT; half += 32) {
          float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = half; kk < half + 32; kk += 8) {
            const float av[4] = {to_f32(cr[kk]), to_f32(cr[8 * M::ldc + kk]),
                                 to_f32(cr[kk + 4]),
                                 to_f32(cr[8 * M::ldc + kk + 4])};
            uint32_t a_big[4], a_small[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if constexpr (kF32) split_tf32(av[q], a_big[q], a_small[q]);
              else a_big[q] = __float_as_uint(av[q]);   // exact in TF32
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int p = 16 * (warp / 4) + 8 * nt + gq;
              uint32_t h_big[2], h_small[2];
              split_tf32(hs[hidx(n0 + kk, p)], h_big[0], h_small[0]);
              split_tf32(hs[hidx(n0 + kk + 4, p)], h_big[1], h_small[1]);
              float part[4] = {0.f, 0.f, 0.f, 0.f};
              if constexpr (kF32) mma_tf32(part, a_small, h_big[0], h_big[1]);
              mma_tf32(part, a_big, h_small[0], h_small[1]);
              mma_tf32(part, a_big, h_big[0], h_big[1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[nt][e] += part[e];
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) ya[nt][e] += acc[nt][e];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == M::stages) {
        s = 0;
        ph ^= 1;
      }
    }

    // (ii) y = exp(cum_i) (C h^T) + G x in fp64, rounded once; G's row
    // and the decays from L2 (each read by the 32 slices of a head)
    const size_t chunk = ((size_t)b * H + h) * nc + ci;
    const double* dch = dec + chunk * kDec;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 16 * (warp % 4) + gq + 8 * r;
      const float4* gr =
          reinterpret_cast<const float4*>(g + (chunk * kLc + i) * kGLD);
      const double e0 = __ldg(dch + i);
      double yv[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        yv[nt][0] = ya[nt][2 * r] * e0;
        yv[nt][1] = ya[nt][2 * r + 1] * e0;
      }
      for (int j4 = 0; j4 <= i; j4 += 4) {        // G is 0 above the diagonal
        const float4 g4 = __ldg(gr + j4 / 4);
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const double2 xv = *reinterpret_cast<const double2*>(
                xs + (j4 + k) * kPS + 16 * (warp / 4) + 8 * nt + 2 * tq);
            yv[nt][0] = fma((double)gv[k], xv.x, yv[nt][0]);
            yv[nt][1] = fma((double)gv[k], xv.y, yv[nt][1]);
          }
      }
      if (t0 + i < S) {
        T* yr = y + (((size_t)b * S + t0 + i) * H + h) * kP + p0 +
                16 * (warp / 4) + 2 * tq;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          store(yr + 8 * nt, yv[nt][0]);
          store(yr + 8 * nt + 1, yv[nt][1]);
        }
      }
    }

    // the update's A operand, (x exp(total - cum))^T split in two: warp w
    // state rows 16 (w % 2) + gq (+ 8), chunk rows 8 ks + tq (+ 4)
    uint32_t xa_big[kLc / 8][4], xa_small[kLc / 8][4];
#pragma unroll
    for (int ks = 0; ks < kLc / 8; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = 16 * (warp % 2) + gq + 8 * (q % 2);
        const int j = 8 * ks + tq + 4 * (q / 2);
        split_tf32(xs[j * kPS + p] * __ldg(dch + kLc + j), xa_big[ks][q],
                   xa_small[ks][q]);
      }
    const float dc = (float)__ldg(dch + 2 * kLc);
    consumer_sync();                              // the old state is read

    // (iii) h = exp(total) h + (x exp(total - cum))^T B, tile by tile: warp
    // w the tile's columns 16 (w / 2) + 8 nt + sigma(.), where the
    // accumulator's columns 2 tq, 2 tq + 1 are tq, tq + 4 and the B
    // operand's column gq is 4 (gq % 2) + gq / 2
    for (int tile = 0; tile < kTiles; ++tile) {
      mbar_wait(&full[s], ph);
      const T* bt = reinterpret_cast<const T*>(smem + M::ring + s * M::stage) +
                    tq * M::ldb + 16 * (warp / 2) + 4 * (gq % 2) + gq / 2;
      float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < kLc / 8; ++ks) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float b0 = to_f32(bt[8 * ks * M::ldb + 8 * nt]);
          const float b1 = to_f32(bt[(8 * ks + 4) * M::ldb + 8 * nt]);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (kF32) {
            uint32_t b_big[2], b_small[2];
            split_tf32(b0, b_big[0], b_small[0]);
            split_tf32(b1, b_big[1], b_small[1]);
            mma_tf32(part, xa_small[ks], b_big[0], b_big[1]);
            mma_tf32(part, xa_big[ks], b_small[0], b_small[1]);
            mma_tf32(part, xa_big[ks], b_big[0], b_big[1]);
          } else {                                // exact in TF32
            mma_tf32(part, xa_small[ks], __float_as_uint(b0),
                     __float_as_uint(b1));
            mma_tf32(part, xa_big[ks], __float_as_uint(b0),
                     __float_as_uint(b1));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) u[nt][e] += part[e];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == M::stages) {
        s = 0;
        ph ^= 1;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 16 * (warp % 2) + gq + 8 * (e / 2);
          const int n =
              tile * kNT + 16 * (warp / 2) + 8 * nt + tq + 4 * (e % 2);
          float* hp = hs + hidx(n, p);
          *hp = fmaf(dc, *hp, u[nt][e]);
        }
    }
  }
  consumer_sync();

  // h_final[b][h][p0 + p][n]: a warp 8 rows p by 4 columns n at a time
  float* hf = h_final + (((size_t)b * H + h) * kP + p0) * kN;
  for (int q = warp; q < (kPS / 8) * (kN / 4); q += kConsumers / 32) {
    const int p = 8 * (q % (kPS / 8)) + gq, n = 4 * (q / (kPS / 8)) + tq;
    hf[(size_t)p * kN + n] = hs[hidx(n, p)];
  }
}

template <typename T>
int launch(const void* x, const void* a_log, const void* b, const void* c,
           void* y, void* h_final, void* work, int B, int S, int H,
           cudaStream_t st) {
  using M = WalkSmem<T>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssm_wide_walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        M::bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssm_wide_walk_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int nc = (S + kLc - 1) / kLc;
  float* g = static_cast<float*>(work);
  double* dec = reinterpret_cast<double*>(g + (size_t)B * H * nc * kLc * kGLD);
  ssm_wide_scores_kernel<T><<<dim3(nc, H, B), kScoresThreads, 0, st>>>(
      (const T*)b, (const T*)c, (const float*)a_log, g, dec, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssm_wide_walk_kernel<T>
      <<<dim3(kSlices + 1, H, B), kWalkThreads, M::bytes, st>>>(
          (const T*)x, (const T*)b, (const T*)c, g, dec, (T*)y,
          (float*)h_final, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes shared with kernels/ssm_scan.py
enum { kFloat32 = 0, kBFloat16 = 1 };

extern "C" {

// x (B,S,H,P) and y in the dtype; a_log (B,S,H) fp32; b, c (B,S,N) in the
// dtype; h_final (B,H,P,N) fp32; work: B H ceil(S / 64) (64 x 68 + 2 x 129)
// floats (per chunk its decayed scores, rows padded to 68, then per chunk
// its 129 decays in fp64).  (P, N) = (1025, 1024) only;
// S >= 1; every pointer 16-byte aligned.
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
