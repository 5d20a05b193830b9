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
// flash_attention_kernel  replaces flash_attention_pallas
//   (src/repro/kernels/flash_attention.py:63, _flash_kernel :24), the prefill
//   attention.  Bound: at S=512, hd=128 one (batch, head) needs ~0.06 GFLOP
//   against ~0.5 MB of q/k/v/out, which on bf16 tensor cores sits just
//   below the card's ridge (bytes-bound, ~5 us for 32 heads); this first
//   version runs the products on the CUDA cores in fp32 (no tensor cores
//   yet), so its own limit is operations at 67 TFLOP/s.  One block per
//   (64-row q tile, head, batch); K/V tiles of 32 keys are staged in shared
//   memory as fp32, four threads share a query row (each owns a quarter of
//   the head dim, read as float4 so the shared loads are free of bank
//   conflicts), and the online softmax lives in registers.  The kv loop
//   starts at the tile that holds starts[b] (left pad) and stops at the
//   diagonal; the ragged edge is masked, so S need not divide the tile.
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

namespace {

constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* starts, void* out, int B, int S, int H,
                        int KV, int hd, int dtype, int causal, float scale,
                        void* stream) {
  const dim3 grid((S + kFaBQ - 1) / kFaBQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, HD)                                                         \
  flash_attention_kernel<T, HD><<<grid, kFaThreads, 0, st>>>(                 \
      (const T*)q, (const T*)k, (const T*)v, (const int*)starts, (T*)out, S,  \
      H, KV, causal, scale)
  REPRO_DISPATCH(dtype, hd, LAUNCH);
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
