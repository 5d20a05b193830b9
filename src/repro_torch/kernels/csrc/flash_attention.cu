// Attention kernels for the dense serving path, written by hand for Hopper
// (sm_90a), each behind a plain C entry point that returns cudaGetLastError().
//
// Shared rules (those of the JAX package's attention):
//   - scores and the softmax are fp32; the output is written in q's dtype;
//   - masked scores are the finite -1e30, never -inf, so a row that sees no
//     key stays finite and no 0*NaN can arise;
//   - dtypes float32 and bfloat16, head dim 64, 80 (zamba2's shared block)
//     or 128 (a template argument);
//   - GQA by index: query head h reads kv head h / (H / KV); kv is never
//     repeated in memory.
//
// Prefill (replaces flash_attention_pallas, src/repro/kernels/
//   flash_attention.py:63, _flash_kernel :24).  Two instantiations:
//
// flash_attention_tc_kernel<HD>  bf16 q/k/v, on the tensor cores.  Bound:
//   at llama2-7b's prefill (1 x 512, 32 heads of 128) the work is ~1.9
//   GFLOP against ~16 MB of q/k/v/out, 5 us by bytes and 2 us by bf16
//   operations, so a launch this small is held back by latency (one K/V
//   tile after another, up to 8 on the diagonal) more than by either
//   roof.  Design: one warpgroup per (head, batch row, 64-row q tile).
//   Q and two stages of K/V tiles of 64 keys come in by cp.async (keys
//   past S zero-filled), the next tile's copy overlapping this tile's
//   products, into the 128-byte swizzled layout wgmma reads (head dims
//   past a multiple of 64, as 80, in a zero-filled second atom).
//   S = Q K^T is one chain of wgmma.m64n64k16 (Q and K both K-major in
//   shared memory); the online softmax runs on the fp32 accumulator in
//   registers (row max by two quad shuffles, exp2 with the scale folded
//   into log2 e, row sums summed per thread and reduced once at the end);
//   P is rounded to bf16 in registers (the rounding the reference applies
//   to its probabilities) and is the register A operand of O += P V, a
//   wgmma.m64n{HD}k16 with V read from shared memory through the transpose
//   bit (the head dim contiguous).  q tiles are launched longest first
//   (the diagonal tiles do up to 8x the work of the first), and a causal
//   q tile wholly inside the left pad is written as zeros without reading
//   a key.
//
// flash_attention_kernel<float, HD>  fp32, on the CUDA cores (TF32 stays
//   off, as in the reference).  Bound: operations at 67 TFLOP/s.  One
//   block per (64-row q tile, head, batch); K/V tiles of 32 keys are
//   staged in shared memory, four threads share a query row (each owns a
//   quarter of the head dim, read as float4 so the shared loads are free
//   of bank conflicts), and the online softmax lives in registers.
//
// Both start the kv loop at the tile that holds starts[b] (left pad) and
// stop at the diagonal; the ragged edge is masked, so S need not divide
// the tile.  A q row inside the pad sees no key and comes out finite (the
// mean of the visited values, or 0 for a skipped tile).
//
// flash_decode_kernel<.., PAGED=false>  replaces flash_decode_pallas
//   (:141, _decode_kernel :109).  Bound: bytes.  One query per row reads
//   the whole valid window of its kv head once, 2*hd*elem bytes per key,
//   against 4*hd operations.  One block per (head, batch row); 32 groups of
//   8 lanes each own every 32nd key, so a warp reads 4 whole kv rows per
//   load (coalesced 16-byte loads); a group loads 4 keys before it uses
//   any, to keep enough bytes in flight with only B*H blocks on the card,
//   and keeps its own online softmax state; the 32 partial (m, l, acc) are
//   combined through shared memory at the end.  Only keys in
//   [starts[b], lengths[b]) are read.
//
// flash_decode_kernel<.., PAGED=true>  replaces paged_flash_decode_pallas
//   (:230, _paged_decode_kernel :187).  Bound: bytes, as above.  On the TPU
//   the pages were the sequential inner grid dimension with the softmax
//   carried in scratch; blocks here run in no order, so the walk over the
//   logical pages that overlap the window moves inside the block: the block
//   first copies its row of the block table into shared memory, each key of
//   the window resolves its physical page there, and the rest is the
//   contiguous kernel.
//
// Rows whose window is empty come out as 0 here, where JAX's kernels give
// the mean of the visited values; both are finite garbage that callers
// never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "load_f32.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------------------------ prefill

constexpr int kFaBQ = 64;                    // query rows per block
constexpr int kFaBK = 32;                    // keys per shared-memory tile
constexpr int kFaTPR = 4;                    // threads per query row
constexpr int kFaThreads = kFaBQ * kFaTPR;   // 256

template <typename T, int HD>
__global__ void __launch_bounds__(kFaThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ starts,
                       T* __restrict__ out, int S, int H, int KV, int causal,
                       float scale) {
  // Thread `part` of a row owns dims 16*g + 4*part + e (g < HD/16, e < 4):
  // four float4 granules side by side, so one LDS.128 per granule serves a
  // quarter-warp with no bank conflict (the 8 rows of a warp broadcast).
  constexpr int G = HD / 16;
  constexpr int D = 4 * G;
  constexpr int V = 16 / sizeof(T);
  __shared__ __align__(16) float ks[kFaBK][HD];
  __shared__ __align__(16) float vs[kFaBK][HD];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kFaBQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int row = tid / kFaTPR, part = tid % kFaTPR;
  const int qi = q0 + row;
  const bool active = qi < S;
  const int start = starts ? starts[b] : 0;

  float qr[D], acc[D];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t off = ((size_t)(b * S + qi) * H + h) * HD + 16 * g + 4 * part + e;
      qr[4 * g + e] = active ? to_f(q[off]) : 0.f;
      acc[4 * g + e] = 0.f;
    }
  float m = kNeg, l = 0.f;

  const int q_last = min(q0 + kFaBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;            // keys [.., kv_end)
  const int t_lo = min(max(start, 0), kv_end) / kFaBK;
  const int t_hi = (kv_end + kFaBK - 1) / kFaBK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kFaBK;
    __syncthreads();                                     // last tile consumed
    for (int c = tid; c < kFaBK * HD / V; c += kFaThreads) {
      const int r = c / (HD / V), col = (c % (HD / V)) * V;
      const int kp = k0 + r;
      float tk[V], tv[V];
      if (kp < S) {
        const size_t off = ((size_t)(b * S + kp) * KV + kvh) * HD + col;
        load_f32<T, V>(k + off, tk);
        load_f32<T, V>(v + off, tv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) tk[e] = tv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        *reinterpret_cast<float4*>(&ks[r][col + e]) = make_float4(tk[e], tk[e + 1], tk[e + 2], tk[e + 3]);
        *reinterpret_cast<float4*>(&vs[r][col + e]) = make_float4(tv[e], tv[e + 1], tv[e + 2], tv[e + 3]);
      }
    }
    __syncthreads();

    float sc[kFaBK];
    float tile_max = kNeg;
#pragma unroll
    for (int j = 0; j < kFaBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][16 * g + 4 * part]);
        dot += qr[4 * g] * kk.x + qr[4 * g + 1] * kk.y + qr[4 * g + 2] * kk.z + qr[4 * g + 3] * kk.w;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kp = k0 + j;
      const bool ok = kp < S && kp >= start && (!causal || kp <= qi);
      sc[j] = ok ? dot * scale : kNeg;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kFaBK; ++j) {
      const float p = expf(sc[j] - m_new);
      l += p;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][16 * g + 4 * part]);
        acc[4 * g] += p * vv.x;
        acc[4 * g + 1] += p * vv.y;
        acc[4 * g + 2] += p * vv.z;
        acc[4 * g + 3] += p * vv.w;
      }
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t off = ((size_t)(b * S + qi) * H + h) * HD + 16 * g + 4 * part + e;
        out[off] = from_f<T>(acc[4 * g + e] * inv);
      }
  }
}

// ------------------------------------------------------- prefill, bf16

// d (64 x 64 fp32) += A (64 x 16, K-major, shared) * B (16 x 64, shared,
// K-major).
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers: a[4] per thread) * B
// (16 x 64, shared, N-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80 fp32) += A (64 x 16 bf16, registers: a[4] per thread) * B
// (16 x 80, shared, N-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_m64n80k16(float* d, const uint32_t* a,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
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
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers: a[4] per thread) * B
// (16 x 128, shared, N-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int kTcBQ = 64;                    // query rows per block
constexpr int kTcBK = 64;                    // keys per K/V tile
constexpr int kTcThreads = 128;              // one warpgroup

// A tile of 64 rows of a head: ceil(HD / 64) atoms of 64 rows x 128 bytes.
template <int HD>
__host__ __device__ constexpr int tc_tile_bytes() {
  return ((HD + 63) / 64) * 64 * 128;
}

// Dynamic shared memory: the Q tile and two stages of K and V tiles, each
// 1024-byte aligned (+ slack to align the base).
template <int HD>
constexpr int tc_smem_bytes() { return 5 * tc_tile_bytes<HD>() + 1024; }

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_m64n64k16(o, a, db);
  else if constexpr (HD == 80) wgmma_rs_m64n80k16(o, a, db);
  else wgmma_rs_m64n128k16(o, a, db);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ starts,
                          __nv_bfloat16* __restrict__ out, int S, int H,
                          int KV, int causal, float scale_log2) {
  constexpr int CH = HD / 8;                 // 16-byte chunks of a row
  constexpr int ATOMS = (HD + 63) / 64;      // 64-column atoms of a tile
  constexpr int TILE = tc_tile_bytes<HD>();
  constexpr int KS = HD / 16;                // k16 steps of Q K^T

  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  const uint32_t raw = smem_u32(tc_smem_raw);
  unsigned char* qs = tc_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* ks = qs + TILE;             // [2][TILE]
  unsigned char* vs = ks + 2 * TILE;         // [2][TILE]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBQ;   // longest first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int start = starts ? max(starts[b], 0) : 0;
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * S * KV + kvh) * HD;
  __nv_bfloat16* ob = out + ((size_t)b * S * H + h) * HD;
  const int q_end = min(q0 + kTcBQ, S);

  if (causal && q_end <= start) {            // every row in the pad
    for (int c = tid; c < (q_end - q0) * CH; c += kTcThreads)
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + c / CH) * q_stride +
                                (c % CH) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }

  // 64 rows from position r0 on into a swizzled tile: rows past S and the
  // columns past HD of the last atom (head dim 80) are zero-filled.
  auto load_rows = [&](unsigned char* dst, const __nv_bfloat16* src,
                       size_t stride, int r0) {
    for (int c = tid; c < 64 * ATOMS * 8; c += kTcThreads) {
      const int r = c / (ATOMS * 8), cc = c % (ATOMS * 8), pos = r0 + r;
      const bool ok = pos < S && cc < CH;
      cp_async16(smem_u32(dst + (cc / 8) * 8192 + r * 128 +
                          (((cc % 8) ^ (r & 7)) << 4)),
                 ok ? src + (size_t)pos * stride + cc * 8 : src, ok ? 16 : 0);
    }
  };

  const int kv_end = causal ? q_end : S;     // keys [.., kv_end)
  const int t_lo = min(start, kv_end) / kTcBK;
  const int t_hi = (kv_end + kTcBK - 1) / kTcBK;
  load_rows(qs, qb, q_stride, q0);
  load_rows(ks, kb, kv_stride, t_lo * kTcBK);
  load_rows(vs, vb, kv_stride, t_lo * kTcBK);
  cp_async_commit();

  const int g = lane / 4, cq = 2 * (lane % 4);
  const int row0 = q0 + 16 * warp + g;       // this thread's rows: row0, +8
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};
  const uint32_t qa = smem_u32(qs);

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) {                      // next tile into the other stage
      load_rows(ks + (st ^ 1) * TILE, kb, kv_stride, (t + 1) * kTcBK);
      load_rows(vs + (st ^ 1) * TILE, vb, kv_stride, (t + 1) * kTcBK);
    }
    cp_async_commit();
    cp_async_wait<1>();                      // this tile (and Q) landed
    fence_proxy_async();                     // cp.async writes -> wgmma reads
    __syncthreads();
    const uint32_t ka = smem_u32(ks + st * TILE), va = smem_u32(vs + st * TILE);

    // S = Q K^T (64 x 64), both K-major: k16 step kk is 32 bytes into
    // atom kk / 4.
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      wgmma_ss_m64n64k16(sc, wg_desc(qa + off, 16, 1024),
                         wg_desc(ka + off, 16, 1024));
    }
    wg_commit();
    wg_wait0();
    fence_regs<32>(sc);

    // Scale into log2 units and mask; the online softmax of rows row0 and
    // row0 + 8, each row's 64 scores spread over the 4 threads of a quad.
    const int k0 = t * kTcBK;
    const bool edge = k0 < start || k0 + kTcBK > S ||
                      (causal && k0 + kTcBK - 1 > q0 + 16 * warp);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[4 * n + e] * scale_log2;
        if (edge) {
          const int kp = k0 + 8 * n + cq + (e & 1);
          const int qi = row0 + (e >> 1) * 8;
          if (kp < start || kp >= S || (causal && kp > qi)) s = kNeg;
        }
        sc[4 * n + e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float corr = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
      l_r[i] *= corr;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n + 2 * i] *= corr;
        o[4 * n + 2 * i + 1] *= corr;
      }
    }
    // P = exp2(s - m) in fp32 (summed unrounded), then bf16 A fragments:
    // key chunk j (16 keys) is n8 tiles 2j and 2j + 1.
    uint32_t pf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(sc[4 * n + e] - m_r[e >> 1]);
        l_r[e >> 1] += p[e];
      }
      pf[n / 2][(n % 2) * 2] = pack_bf16(p[0], p[1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O += P V: V is the B operand with the head dim contiguous (the
    // transpose bit); k16 step j is keys 16 j.. (16 rows of 128 bytes).
    fence_regs<HD / 2>(o);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_pv<HD>(o, pf[j], wg_desc(va + j * 2048, 8192, 1024));
    wg_commit();
    wg_wait0();
    fence_regs<HD / 2>(o);
    __syncthreads();                         // stage st free for reuse
  }
  if (t_lo >= t_hi) cp_async_wait<0>();      // no key tile: drain Q's copy

  // Normalise and write the rows (columns past HD are the zero padding).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    l_r[i] = 1.f / fmaxf(l_r[i], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < CH; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + 8 * i;
      if (qi < S)
        *reinterpret_cast<uint32_t*>(ob + (size_t)qi * q_stride + 8 * n + cq) =
            pack_bf16(o[4 * n + 2 * i] * l_r[i], o[4 * n + 2 * i + 1] * l_r[i]);
    }
}

// ------------------------------------------------------------------- decode

constexpr int kDecThreads = 256;
constexpr int kDecLPK = 8;                          // lanes per key
constexpr int kDecGroups = kDecThreads / kDecLPK;   // 32 groups of 8 lanes
constexpr int kDecUnroll = 4;                       // keys per group per step

// Contiguous cache: k/v (B, S, KV, HD), `seq` = S.
// Paged cache:      k/v (n_blocks, bs, KV, HD), `seq` = bs, tables (B, max_blocks).
template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ tables,
                    const int* __restrict__ starts, const int* __restrict__ lengths,
                    T* __restrict__ out, int seq, int H, int KV, int max_blocks,
                    float scale) {
  constexpr int DPL = HD / kDecLPK;                 // dims per lane, contiguous
  __shared__ float sm_m[kDecGroups], sm_l[kDecGroups];
  __shared__ float sm_acc[kDecGroups][HD];
  extern __shared__ int sm_table[];                 // PAGED: this row's table

  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int grp = tid / kDecLPK, lane = tid % kDecLPK;
  const unsigned gmask = 0xffu << ((threadIdx.x & 31) & ~(kDecLPK - 1));

  float qv[DPL], acc[DPL];
  load_f32<T, DPL>(q + ((size_t)b * H + h) * HD + lane * DPL, qv);
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  if (PAGED) {
    for (int i = tid; i < max_blocks; i += kDecThreads)
      sm_table[i] = tables[(size_t)b * max_blocks + i];
    __syncthreads();
  }
  const int start = starts ? max(starts[b], 0) : 0;
  const int len = min(lengths[b], PAGED ? max_blocks * seq : seq);
  // kDecUnroll keys per group per iteration, all loaded before any is used,
  // so each lane keeps 2*kDecUnroll row loads in flight instead of 2.
  for (int base = start + grp; base < len; base += kDecUnroll * kDecGroups) {
    float kr[kDecUnroll][DPL], vr[kDecUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int pos = base + u * kDecGroups;
      if (pos < len) {
        size_t row;
        if (PAGED) {
          const int page = sm_table[pos / seq];
          row = ((size_t)page * seq + pos % seq) * KV + kvh;
        } else {
          row = ((size_t)b * seq + pos) * KV + kvh;
        }
        load_f32<T, DPL>(k + row * HD + lane * DPL, kr[u]);
        load_f32<T, DPL>(v + row * HD + lane * DPL, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      if (base + u * kDecGroups >= len) break;        // uniform per group
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) dot += qv[i] * kr[u][i];
#pragma unroll
      for (int o = 1; o < kDecLPK; o <<= 1) dot += __shfl_xor_sync(gmask, dot, o);
      const float s = dot * scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = acc[i] * corr + p * vr[u][i];
      m = m_new;
    }
  }

  if (lane == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[grp][lane * DPL + i] = acc[i];
  __syncthreads();
  if (tid < HD) {
    float mx = kNeg;
    for (int g = 0; g < kDecGroups; ++g) mx = fmaxf(mx, sm_m[g]);
    float lsum = 0.f, o = 0.f;
    for (int g = 0; g < kDecGroups; ++g) {
      const float w = expf(sm_m[g] - mx);
      lsum += sm_l[g] * w;
      o += sm_acc[g][tid] * w;
    }
    out[((size_t)b * H + h) * HD + tid] = from_f<T>(o / fmaxf(lsum, 1e-30f));
  }
}

}  // namespace

// dtype codes shared with kernels/flash_attention.py
enum { kFloat32 = 0, kBFloat16 = 1 };

#define REPRO_DISPATCH(DTYPE, HD_, LAUNCH)                                    \
  do {                                                                        \
    if ((DTYPE) == kFloat32 && (HD_) == 64) { LAUNCH(float, 64); }            \
    else if ((DTYPE) == kFloat32 && (HD_) == 80) { LAUNCH(float, 80); }       \
    else if ((DTYPE) == kFloat32 && (HD_) == 128) { LAUNCH(float, 128); }     \
    else if ((DTYPE) == kBFloat16 && (HD_) == 64) { LAUNCH(__nv_bfloat16, 64); } \
    else if ((DTYPE) == kBFloat16 && (HD_) == 80) { LAUNCH(__nv_bfloat16, 80); } \
    else if ((DTYPE) == kBFloat16 && (HD_) == 128) { LAUNCH(__nv_bfloat16, 128); } \
    else return (int)cudaErrorInvalidValue;                                   \
  } while (0)

extern "C" {

// q (B,S,H,hd); k, v (B,S,KV,hd); starts (B,) int32 or NULL; out like q.
// bf16 runs on the tensor cores, fp32 on the CUDA cores.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* starts, void* out, int B, int S, int H,
                        int KV, int hd, int dtype, int causal, float scale,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_qt = (S + kFaBQ - 1) / kFaBQ;
  if (dtype == kBFloat16) {
    const dim3 grid(H, B, (S + kTcBQ - 1) / kTcBQ);
    const float scale_log2 = scale * 1.4426950408889634f;
#define LAUNCH_TC(HD)                                                         \
  do {                                                                        \
    constexpr int bytes = tc_smem_bytes<HD>();                                \
    static bool attr_set = false;                                             \
    if (!attr_set) {                                                          \
      const cudaError_t e = cudaFuncSetAttribute(                             \
          flash_attention_tc_kernel<HD>,                                      \
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);                \
      if (e != cudaSuccess) return (int)e;                                    \
      attr_set = true;                                                        \
    }                                                                         \
    flash_attention_tc_kernel<HD><<<grid, kTcThreads, bytes, st>>>(           \
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,                     \
        (const __nv_bfloat16*)v, (const int*)starts, (__nv_bfloat16*)out, S,  \
        H, KV, causal, scale_log2);                                           \
  } while (0)
    if (hd == 64) LAUNCH_TC(64);
    else if (hd == 80) LAUNCH_TC(80);
    else if (hd == 128) LAUNCH_TC(128);
    else return (int)cudaErrorInvalidValue;
#undef LAUNCH_TC
    return (int)cudaGetLastError();
  }
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_qt, H, B);
#define LAUNCH(HD)                                                            \
  flash_attention_kernel<float, HD><<<grid, kFaThreads, 0, st>>>(             \
      (const float*)q, (const float*)k, (const float*)v, (const int*)starts,  \
      (float*)out, S, H, KV, causal, scale)
  if (hd == 64) LAUNCH(64);
  else if (hd == 80) LAUNCH(80);
  else if (hd == 128) LAUNCH(128);
  else return (int)cudaErrorInvalidValue;
#undef LAUNCH
  return (int)cudaGetLastError();
}

// q (B,H,hd); k, v (B,S,KV,hd); starts, lengths (B,) int32 (starts may be
// NULL); out (B,H,hd).
int flash_decode_fwd(const void* q, const void* k, const void* v,
                     const void* starts, const void* lengths, void* out, int B,
                     int S, int H, int KV, int hd, int dtype, float scale,
                     void* stream) {
  const dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, HD)                                                         \
  flash_decode_kernel<T, HD, false><<<grid, kDecThreads, 0, st>>>(            \
      (const T*)q, (const T*)k, (const T*)v, nullptr, (const int*)starts,     \
      (const int*)lengths, (T*)out, S, H, KV, 0, scale)
  REPRO_DISPATCH(dtype, hd, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// q (B,H,hd); k_pool, v_pool (n_blocks, block_size, KV, hd); block_tables
// (B, max_blocks) int32; starts, lengths (B,) int32; out (B,H,hd).
int paged_flash_decode_fwd(const void* q, const void* k_pool,
                           const void* v_pool, const void* block_tables,
                           const void* starts, const void* lengths, void* out,
                           int B, int H, int KV, int hd, int block_size,
                           int max_blocks, int dtype, float scale,
                           void* stream) {
  const dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, HD)                                                         \
  flash_decode_kernel<T, HD, true>                                            \
      <<<grid, kDecThreads, max_blocks * sizeof(int), st>>>(                  \
      (const T*)q, (const T*)k_pool, (const T*)v_pool,                        \
      (const int*)block_tables, (const int*)starts, (const int*)lengths,      \
      (T*)out, block_size, H, KV, max_blocks, scale)
  REPRO_DISPATCH(dtype, hd, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
