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
//   flash_attention.py:63, _flash_kernel :24).  Two kernels, both on the
//   tensor cores:
//
// flash_attention_tc_kernel<HD>  bf16 q/k/v.  Bound: at llama2-7b's
//   prefill (1 x 512, 32 heads of 128) the work is ~1.9 GFLOP against ~16
//   MB of q/k/v/out, 5 us by bytes and 2 us by bf16 operations, so a
//   launch this small is held back by latency (one K/V tile after another,
//   up to 8 on the diagonal) more than by either roof.  Design: one
//   warpgroup per (head, batch row, 64-row q tile).  Q and two stages of
//   K/V tiles of 64 keys come in by cp.async (keys past Sk zero-filled), the
//   next tile's copy overlapping this tile's products, into the 128-byte
//   swizzled layout wgmma reads (head dims past a multiple of 64, as 80, in
//   a zero-filled second atom).  S = Q K^T is one chain of wgmma.m64n64k16
//   (Q and K both K-major in shared memory); the online softmax runs on the
//   fp32 accumulator in registers (row max by two quad shuffles, exp2 with
//   the scale folded into log2 e, row sums summed per thread and reduced
//   once at the end); P is rounded to bf16 in registers (the rounding the
//   reference applies to its probabilities) and is the register A operand
//   of O += P V, a wgmma.m64n{HD}k16 with V read from shared memory through
//   the transpose bit (the head dim contiguous).
//
// flash_attention_3xtf32_kernel<HD>  fp32 q/k/v, at fp32 accuracy.  TF32
//   stays off as in the reference: each product a * b is taken as three
//   TF32 products, a_big b_big + a_big b_small + a_small b_big, where
//   x_big = tf32(x) and x_small = tf32(x - x_big) (both rounded to
//   nearest) and the sums are fp32; the dropped a_small b_small and the
//   rounding of the small parts are ~2^-21 of each product.  Bound: at
//   llama2-7b's 1 x 256 the bytes (16 MB, 4.8 us) over the three passes'
//   TF32 operations (3 x 0.49 GFLOP at 495 TFLOP/s, 3.0 us); what holds a
//   launch this small back is the chain of dependent products in the
//   longest q tile.  Design: wgmma takes TF32 only K-major on both sides,
//   which V (the head dim contiguous) is not, so this kernel uses
//   mma.sync.m16n8k8, whose fragments the threads load themselves from any
//   layout.  One block per (head, batch row, 32-row q tile), so llama2-7b's
//   1 x 256 is 256 blocks on 132 SMs; its four warps are two key parts of
//   two warps (16 rows each): part p takes the p-th, (p + 2)-th, .. of the
//   row's 16-key tiles, so the diagonal tile's chain is halved and an SM
//   holds two warps a scheduler, and the parts merge their (m, l, o)
//   through shared memory at the end (four parts, or 8-key tiles, measured
//   no faster).  Q is split once into big and small parts in shared
//   memory; each part's K/V tiles come in raw by cp.async (16 bytes a
//   thread) into padded rows (HD + 4 floats, so every fragment load is
//   free of bank conflicts), two stages, the next tile's copy overlapping
//   this tile's products, the part's warps meeting at their own named
//   barrier; each thread splits its K and V fragments as it loads them.  The S accumulator's layout is the A fragment of P V with the
//   keys of each k8 step permuted (thread t holds keys 2t and 2t + 1; V's B
//   fragment reads those two key rows), so P is split in registers with no
//   shuffle.  The online softmax runs in fp32 registers with exp2 and the
//   scale folded into log2 e.
//
// Both take `prefix` (a vlm's vision tokens, 0 otherwise): key j of row b
// is valid iff j < prefix or j >= prefix + starts[b], so the left pad sits
// behind the prefix.  The kv loop visits the prefix's tiles, then starts
// again at the tile that holds prefix + starts[b] and stops at the
// diagonal; the pad's and the ragged edge's keys are masked, so S need not
// divide the tile.  k and v hold Sk rows a batch row (Sk == S when
// causal; a non-causal call may attend over another length, as an
// encoder-decoder's cross attention over its encoder's memory): the kv
// loop ends at Sk and the last key tile masks keys at or past Sk.  With
// prefix 0 the loop is the plain left-pad one.  q tiles are launched
// longest first (the diagonal tiles do the most work), a warp whose rows
// all precede a key tile skips its products, and with no prefix a causal
// q tile wholly inside the left pad is written as zeros without reading a
// key (with one, pad rows see the prefix).  A q row that
// sees no key comes out finite (the mean of the visited values).
//
// Decode (replaces flash_decode_pallas, :141, _decode_kernel :109, and
//   paged_flash_decode_pallas, :230, _paged_decode_kernel :187):
//
// flash_decode_split_kernel<T, HD, GM, PAGED>  Bound: bytes.  One query
//   per row reads the whole valid window of its kv head once, 2*hd*elem
//   bytes per key, against 4*hd operations per query head.  Split-KV
//   ("flash-decoding"): the grid is (kv head x head group, batch row,
//   split), and each block takes the keys of its row's window ([0, prefix)
//   and [prefix + starts[b], lengths[b]); the paged cache has no prefix)
//   that fall in [split * chunk, (split + 1) * chunk); the host
//   picks the chunk from the cache's capacity so the longest row is cut
//   into enough pieces to fill the card, and a block whose chunk misses
//   the window exits at once.  One block serves GM query heads of its kv
//   head (all of them where they fit in registers: GQA reads each K/V row
//   once, not H / KV times).  K/V rows come into a three-stage ring of
//   32-key tiles by cp.async, 16 bytes a thread, so two tiles (32 KB in
//   bf16 at hd 128) stay in flight per block without registers (deeper
//   rings, at fewer blocks an SM, measured slower); 16 groups of 8 lanes
//   each take a key of the tile at a time (a lane owns 16-byte chunks lane,
//   lane + 8, .. of the row, so a quarter-warp's shared loads are
//   contiguous) and
//   keep their own online softmax per head (one exp2 a key and head), and
//   the block merges its 16 partial (m, l, acc) by shuffles and shared
//   memory.  With one split the block writes the output; with more it
//   writes its partial (m, l, acc) in fp32 to scratch, and
//   flash_decode_combine_kernel, launched as its programmatic dependent,
//   merges a row's splits into the output.
//   The paged kernel resolves each key's page from block_tables once (a
//   lane per key of a tile) as it issues the copies, for its own chunk
//   only, so a table has no size limit.
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
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------------- prefill, fp32

// x -> (tf32(x), tf32(x - tf32(x))), both rounded to nearest (ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
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

// d += a * b in three passes, the small products first.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* a_big,
                                           const uint32_t* a_small, float b0,
                                           float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split_tf32(b0, b0_big, b0_small);
  split_tf32(b1, b1_big, b1_small);
  mma_tf32(d, a_small, b0_big, b1_big);
  mma_tf32(d, a_big, b0_small, b1_small);
  mma_tf32(d, a_big, b0_big, b1_big);
}

constexpr int kF3BQ = 32;                    // query rows per block
constexpr int kF3BK = 16;                    // keys per K/V tile
constexpr int kF3NT = kF3BK / 8;             // n8 tiles of keys
constexpr int kF3Stages = 2;                 // K/V tiles in flight per part
constexpr int kF3Parts = 2;                  // key parts, two warps each
constexpr int kF3Threads = 64 * kF3Parts;

// Dynamic shared memory (floats of HD + 4 per row): Q big and small (32
// rows each) and, for each key part, a ring of K and V tiles.
template <int HD>
constexpr int f3_smem_bytes() {
  return (2 * kF3BQ + kF3Parts * 2 * kF3Stages * kF3BK) * (HD + 4) * 4;
}

template <int HD>
__global__ void __launch_bounds__(kF3Threads)
flash_attention_3xtf32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int* __restrict__ starts,
                              float* __restrict__ out, int S, int Sk, int H,
                              int KV, int causal, int prefix,
                              float scale_log2) {
  constexpr int LD = HD + 4;                 // padded row, in floats
  constexpr int C4 = HD / 4;                 // 16-byte chunks of a row
  constexpr int TILE = kF3BK * LD;
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
  static_assert((kF3Parts - 1) * 64 * (HD / 2 + 4) <=
                kF3Parts * 2 * kF3Stages * TILE, "the merge slots fit the rings");
  extern __shared__ __align__(16) float f3_smem[];
  float* q_big = f3_smem;                    // [32][LD]
  float* q_small = q_big + kF3BQ * LD;       // [32][LD]
  float* ring = q_small + kF3BQ * LD;        // [parts][K, V][stages][BK][LD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kF3BQ;   // longest first
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int part = warp / 2, pt = tid % 64;  // key part; thread in the part
  float* ks = ring + part * 2 * kF3Stages * TILE;
  float* vs = ks + kF3Stages * TILE;
  // The two warps of a key part meet at their own named barrier.
  auto part_sync = [&]() {
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + part) : "memory");
  };
  const int start = starts ? max(starts[b], 0) : 0;
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  const float* qb = q + ((size_t)b * S * H + h) * HD;
  const float* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  float* ob = out + ((size_t)b * S * H + h) * HD;
  const int q_end = min(q0 + kF3BQ, S);

  if (causal && prefix == 0 && q_end <= start) {   // every row in the pad
    for (int c = tid; c < (q_end - q0) * C4; c += kF3Threads)
      *reinterpret_cast<float4*>(ob + (size_t)(q0 + c / C4) * q_stride +
                                 (c % C4) * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  // The part's K and V rows from position k0 on into stage st; rows past
  // Sk are zero-filled.
  auto load_kv = [&](int st, int k0) {
    for (int c = pt; c < kF3BK * C4; c += 64) {
      const int r = c / C4, cc = c % C4, pos = k0 + r;
      const bool ok = pos < Sk;
      const size_t off = ok ? (size_t)pos * kv_stride + cc * 4 : 0;
      const uint32_t dst = (st * TILE + r * LD + cc * 4) * 4;
      cp_async16(smem_u32(ks) + dst, kb + off, ok ? 16 : 0);
      cp_async16(smem_u32(vs) + dst, vb + off, ok ? 16 : 0);
    }
  };

  // Key tiles: the prefix's [0, n_pre), then [t_b, t_hi) from the tile
  // that holds prefix + start on; part p takes the tiles p, p + parts, ..
  // of that list.
  const int kv_end = causal ? q_end : Sk;    // keys [.., kv_end)
  const int n_pre = (min(prefix, kv_end) + kF3BK - 1) / kF3BK;
  const int t_b = max(n_pre, min(prefix + start, kv_end) / kF3BK);
  const int t_hi = (kv_end + kF3BK - 1) / kF3BK;
  const int n_tiles = n_pre + t_hi - t_b;
  const int n_mine = max(0, (n_tiles - part + kF3Parts - 1) / kF3Parts);
  auto tile_k0 = [&](int i) {                // first key of my i-th tile
    const int j = part + kF3Parts * i;
    return (j < n_pre ? j : t_b + j - n_pre) * kF3BK;
  };
#pragma unroll
  for (int i = 0; i < kF3Stages - 1; ++i) {
    if (i < n_mine) load_kv(i, tile_k0(i));
    cp_async_commit();
  }

  // Q, split once: rows past S read as zeros.
  for (int c = tid; c < kF3BQ * C4; c += kF3Threads) {
    const int r = c / C4, cc = c % C4, pos = q0 + r;
    const float4 x = pos < S
        ? __ldg(reinterpret_cast<const float4*>(qb + (size_t)pos * q_stride + cc * 4))
        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t big, small;
      split_tf32(xs[e], big, small);
      q_big[r * LD + cc * 4 + e] = __uint_as_float(big);
      q_small[r * LD + cc * 4 + e] = __uint_as_float(small);
    }
  }

  __syncthreads();                           // Q's split is visible
  const int g = lane / 4, t4 = lane % 4;
  const int rw = 16 * (warp % 2);            // this warp's first row in the tile
  const int row0 = q0 + rw + g;              // this thread's rows: row0, +8
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};
  const uint32_t* qbg = reinterpret_cast<const uint32_t*>(q_big) + (rw + g) * LD + t4;
  const uint32_t* qsm = reinterpret_cast<const uint32_t*>(q_small) + (rw + g) * LD + t4;

  for (int i = 0; i < n_mine; ++i) {
    const int st = i % kF3Stages;
    if (i + kF3Stages - 1 < n_mine)
      load_kv((i + kF3Stages - 1) % kF3Stages, tile_k0(i + kF3Stages - 1));
    cp_async_commit();
    cp_async_wait<kF3Stages - 1>();          // this tile landed
    part_sync();
    const int k0 = tile_k0(i);
    if (causal && k0 > q0 + rw + 15) {       // every key after this warp's rows
      part_sync();
      continue;
    }
    const float* kt = ks + st * TILE;
    const float* vt = vs + st * TILE;

    // S = Q K^T (16 x 16 per warp): k8 steps over the head dim, two n8
    // tiles of keys; K's B fragment is (dim 8kk + t4 (+4), key 8n + g).
    // The three passes sum into three accumulators, so no product waits
    // for another of the same k8 step.
    float sc[kF3NT][4], s1[kF3NT][4], s2[kF3NT][4];
#pragma unroll
    for (int n = 0; n < kF3NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = s1[n][e] = s2[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const uint32_t a_big[4] = {qbg[8 * kk], qbg[8 * LD + 8 * kk],
                                 qbg[8 * kk + 4], qbg[8 * LD + 8 * kk + 4]};
      const uint32_t a_small[4] = {qsm[8 * kk], qsm[8 * LD + 8 * kk],
                                   qsm[8 * kk + 4], qsm[8 * LD + 8 * kk + 4]};
#pragma unroll
      for (int n = 0; n < kF3NT; ++n) {
        const float* kr = kt + (8 * n + g) * LD + 8 * kk + t4;
        uint32_t b0_big, b0_small, b1_big, b1_small;
        split_tf32(kr[0], b0_big, b0_small);
        split_tf32(kr[4], b1_big, b1_small);
        mma_tf32(s1[n], a_small, b0_big, b1_big);
        mma_tf32(s2[n], a_big, b0_small, b1_small);
        mma_tf32(sc[n], a_big, b0_big, b1_big);
      }
    }
#pragma unroll
    for (int n = 0; n < kF3NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] += s1[n][e] + s2[n][e];

    // Scale into log2 units and mask; the online softmax of rows row0 and
    // row0 + 8, each row's 16 scores spread over the 4 threads of a quad.
    const bool edge = (k0 < prefix + start && k0 + kF3BK > prefix) ||
                      k0 + kF3BK > Sk || (causal && k0 + kF3BK - 1 > q0 + rw);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < kF3NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[n][e] * scale_log2;
        if (edge) {
          const int kp = k0 + 8 * n + 2 * t4 + (e & 1);
          const int qi = row0 + (e >> 1) * 8;
          if ((kp >= prefix && kp < prefix + start) || kp >= Sk ||
              (causal && kp > qi)) s = kNeg;
        }
        sc[n][e] = s;
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
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
    }

    // O += P V: k8 step j is the S tile n = j.  Its accumulator (g, 2t4),
    // (g, 2t4 + 1), (g + 8, 2t4), (g + 8, 2t4 + 1) serves as the A
    // fragment with k index t4 -> key 2t4 and t4 + 4 -> key 2t4 + 1, so
    // V's B fragment reads key rows 8j + 2t4 and 8j + 2t4 + 1 at dim 8n + g.
#pragma unroll
    for (int j = 0; j < kF3NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(sc[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += p[e];
      }
      uint32_t p_big[4], p_small[4];
      split_tf32(p[0], p_big[0], p_small[0]);   // (g, key 2t4)
      split_tf32(p[2], p_big[1], p_small[1]);   // (g + 8, key 2t4)
      split_tf32(p[1], p_big[2], p_small[2]);   // (g, key 2t4 + 1)
      split_tf32(p[3], p_big[3], p_small[3]);   // (g + 8, key 2t4 + 1)
      const float* vr = vt + (8 * j + 2 * t4) * LD + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        mma_3xtf32(o[n], p_big, p_small, vr[8 * n], vr[LD + 8 * n]);
    }
    part_sync();                             // stage st free for reuse
  }
  cp_async_wait<0>();                        // drain (no key tile: Q only)

  // Parts 1.. hand their (m, l, o) to the thread of part 0 that holds the
  // same rows and columns, through the rings (free once all are here).
  constexpr int SLOT = HD / 2 + 4;
  __syncthreads();
  if (part > 0) {
    float* slot = ring + (((part - 1) * 2 + warp % 2) * 32 + lane) * SLOT;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) slot[4 * n + e] = o[n][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      slot[HD / 2 + i] = m_r[i];
      slot[HD / 2 + 2 + i] = l_r[i];
    }
  }
  __syncthreads();
  if (part > 0) return;
#pragma unroll
  for (int p = 1; p < kF3Parts; ++p) {
    const float* slot = ring + (((p - 1) * 2 + warp % 2) * 32 + lane) * SLOT;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = slot[HD / 2 + i], mx = fmaxf(m_r[i], m1);
      const float a = exp2f(m_r[i] - mx), c = exp2f(m1 - mx);
      l_r[i] = l_r[i] * a + slot[HD / 2 + 2 + i] * c;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][2 * i] = o[n][2 * i] * a + slot[4 * n + 2 * i] * c;
        o[n][2 * i + 1] = o[n][2 * i + 1] * a + slot[4 * n + 2 * i + 1] * c;
      }
      m_r[i] = mx;
    }
  }

  // Normalise and write the rows.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    l_r[i] = 1.f / fmaxf(l_r[i], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + 8 * i;
      if (qi < S)
        *reinterpret_cast<float2*>(ob + (size_t)qi * q_stride + 8 * n + 2 * t4) =
            make_float2(o[n][2 * i] * l_r[i], o[n][2 * i + 1] * l_r[i]);
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
                          __nv_bfloat16* __restrict__ out, int S, int Sk,
                          int H, int KV, int causal, int prefix,
                          float scale_log2) {
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
  const __nv_bfloat16* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  __nv_bfloat16* ob = out + ((size_t)b * S * H + h) * HD;
  const int q_end = min(q0 + kTcBQ, S);

  if (causal && prefix == 0 && q_end <= start) {   // every row in the pad
    for (int c = tid; c < (q_end - q0) * CH; c += kTcThreads)
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + c / CH) * q_stride +
                                (c % CH) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }

  // 64 rows from position r0 on into a swizzled tile: rows at or past n
  // (S for Q, Sk for K and V) and the columns past HD of the last atom
  // (head dim 80) are zero-filled.
  auto load_rows = [&](unsigned char* dst, const __nv_bfloat16* src,
                       size_t stride, int r0, int n) {
    for (int c = tid; c < 64 * ATOMS * 8; c += kTcThreads) {
      const int r = c / (ATOMS * 8), cc = c % (ATOMS * 8), pos = r0 + r;
      const bool ok = pos < n && cc < CH;
      cp_async16(smem_u32(dst + (cc / 8) * 8192 + r * 128 +
                          (((cc % 8) ^ (r & 7)) << 4)),
                 ok ? src + (size_t)pos * stride + cc * 8 : src, ok ? 16 : 0);
    }
  };

  // Key tiles: the prefix's [0, n_pre), then [t_b, t_hi) from the tile
  // that holds prefix + start on.
  const int kv_end = causal ? q_end : Sk;    // keys [.., kv_end)
  const int n_pre = (min(prefix, kv_end) + kTcBK - 1) / kTcBK;
  const int t_b = max(n_pre, min(prefix + start, kv_end) / kTcBK);
  const int t_hi = (kv_end + kTcBK - 1) / kTcBK;
  const int n_tiles = n_pre + t_hi - t_b;
  auto tile_k0 = [&](int i) {                // first key of the i-th tile
    return (i < n_pre ? i : t_b + i - n_pre) * kTcBK;
  };
  load_rows(qs, qb, q_stride, q0, S);
  load_rows(ks, kb, kv_stride, tile_k0(0), Sk);
  load_rows(vs, vb, kv_stride, tile_k0(0), Sk);
  cp_async_commit();

  const int g = lane / 4, cq = 2 * (lane % 4);
  const int row0 = q0 + 16 * warp + g;       // this thread's rows: row0, +8
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};
  const uint32_t qa = smem_u32(qs);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    if (i + 1 < n_tiles) {                   // next tile into the other stage
      load_rows(ks + (st ^ 1) * TILE, kb, kv_stride, tile_k0(i + 1), Sk);
      load_rows(vs + (st ^ 1) * TILE, vb, kv_stride, tile_k0(i + 1), Sk);
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
    const int k0 = tile_k0(i);
    const bool edge = (k0 < prefix + start && k0 + kTcBK > prefix) ||
                      k0 + kTcBK > Sk ||
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
          if ((kp >= prefix && kp < prefix + start) || kp >= Sk ||
              (causal && kp > qi)) s = kNeg;
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
  if (n_tiles == 0) cp_async_wait<0>();      // no key tile: drain Q's copy

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

constexpr int kDecThreads = 128;
constexpr int kDecLPK = 8;                          // lanes per key
constexpr int kDecGroups = kDecThreads / kDecLPK;   // 16 key groups
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecTK = 32;                          // keys per ring stage
constexpr int kDecStages = 3;

// Query heads one block serves at most: q and acc take 2 * GM * (the
// lane's slice of the row) registers, 8 floats a head at hd 64, 12-16 at
// hd 80 and 128.
template <int HD> __host__ __device__ constexpr int dec_gmax() {
  return HD <= 64 ? 8 : 4;
}

template <typename T, int HD>
struct DecShape {
  static constexpr int V = 16 / sizeof(T);                  // elements a chunk
  static constexpr int CH = HD / V;                         // chunks a row
  static constexpr int CPL = (CH + kDecLPK - 1) / kDecLPK;  // chunks a lane
  static constexpr int ROW = HD * sizeof(T);                // bytes a row
  static_assert(HD % V == 0, "a row must be whole 16-byte chunks");
};

// Dynamic shared memory: the ring of K/V tiles, reused after the key loop
// for the per-warp partials (acc, then m and l).
template <typename T, int HD, int GM>
__host__ __device__ constexpr int dec_smem_bytes() {
  constexpr int ring = kDecStages * 2 * kDecTK * DecShape<T, HD>::ROW;
  constexpr int merge = kDecWarps * GM * (HD + 2) * 4;
  return ring > merge ? ring : merge;
}

// 16 bytes of shared memory -> 4 floats (fp32) or 8 floats (bf16).
template <typename T>
__device__ __forceinline__ void smem_f32(const unsigned char* p, float* o) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) unpack(u[i], o + i * (4 / sizeof(T)), T());
}

// The keys of row b's window, [0, prefix) and [prefix + start, len), that
// split sp covers: n_a keys from lo_a on, then the rest from lo_b on, n in
// all.  Window key v (0 <= v < n) is at position pos(v).
struct Window {
  int lo_a, n_a, lo_b, n;
  __device__ __forceinline__ int pos(int v) const {
    return v < n_a ? lo_a + v : lo_b + v - n_a;
  }
};
__device__ __forceinline__ Window split_window(int prefix, int start, int len,
                                               int sp, int chunk) {
  const int c0 = sp * chunk, c1 = c0 + chunk;
  Window w;
  w.lo_a = c0;
  w.n_a = max(0, min(min(prefix, len), c1) - c0);
  w.lo_b = max(prefix + start, c0);
  w.n = w.n_a + max(0, min(len, c1) - w.lo_b);
  return w;
}

// Contiguous cache: k/v (B, S, KV, HD), `seq` = S.
// Paged cache:      k/v (n_blocks, bs, KV, HD), `seq` = bs, tables (B, max_blocks).
// part: (B, H, n_split, HD) acc, then (B, H, n_split, 2) (m, l), fp32, in
// log2 units; written only with more than one split.
template <typename T, int HD, int GM, bool PAGED>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ tables,
                          const int* __restrict__ starts,
                          const int* __restrict__ lengths, T* __restrict__ out,
                          float* __restrict__ part, int seq, int H, int KV,
                          int max_blocks, int prefix, int chunk,
                          float scale_log2) {
  using Sh = DecShape<T, HD>;
  constexpr int V = Sh::V, CH = Sh::CH, CPL = Sh::CPL, ROW = Sh::ROW;
  constexpr int D = CPL * V;                        // floats a lane holds
  extern __shared__ __align__(16) unsigned char dec_smem[];

  const int G = H / KV;                             // query heads a kv head
  const int n_hg = (G + GM - 1) / GM;
  const int kvh = blockIdx.x / n_hg, hg = blockIdx.x % n_hg;
  const int h0 = kvh * G + hg * GM;                 // this block's first head
  const int gn = min(GM, G - hg * GM);              // and its number of heads
  const int b = blockIdx.y, sp = blockIdx.z, n_split = gridDim.z;
  const int B = gridDim.y;
  const int tid = threadIdx.x, grp = tid / kDecLPK, lane = tid % kDecLPK;
  const int warp = tid / 32, wl = tid % 32;
  const unsigned gmask = 0xffu << (wl & ~(kDecLPK - 1));

  // The combine may be scheduled now: it waits for this grid to finish
  // before it reads a partial.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int start = starts ? max(starts[b], 0) : 0;
  const int len = min(lengths[b], PAGED ? max_blocks * seq : seq);
  const Window w = split_window(prefix, start, len, sp, chunk);
  if (w.n == 0) {                                   // nothing of the window here
    if (n_split == 1)                               // (the combine skips it)
      for (int i = tid; i < gn * HD; i += kDecThreads)
        out[((size_t)b * H + h0) * HD + i] = from_f<T>(0.f);
    return;
  }

  // Tile i (window keys 32 i ..) into ring stage i % kDecStages: one
  // 16-byte copy per chunk of a K and a V row; keys past the window are not
  // read.
  const int n_tiles = (w.n + kDecTK - 1) / kDecTK;
  static_assert(kDecTK == 32, "a paged tile's keys are resolved one a lane");
  auto row_of = [&](int pos) -> size_t {             // element offset of a row
    if (PAGED) {
      const int page = __ldg(tables + (size_t)b * max_blocks + pos / seq);
      return (((size_t)page * seq + pos % seq) * KV + kvh) * HD;
    }
    return (((size_t)b * seq + pos) * KV + kvh) * HD;
  };
  auto load_tile = [&](int i) {
    const int t0 = i * kDecTK;
    const uint32_t ks = smem_u32(dec_smem) + (i % kDecStages) * 2 * kDecTK * ROW;
    const uint32_t vs = ks + kDecTK * ROW;
    // The paged cache resolves each key's page once: lane l looks up key
    // t0 + l, and the copies of a row take its offset by a shuffle (a
    // warp's trip count below is uniform: kDecTK * CH is a multiple of 32).
    unsigned long long lane_row = 0;
    if (PAGED && t0 + wl < w.n) lane_row = row_of(w.pos(t0 + wl));
    for (int c = tid; c < kDecTK * CH; c += kDecThreads) {
      const int r = c / CH, cc = c % CH;
      size_t row = 0;
      if (PAGED) row = __shfl_sync(0xffffffffu, lane_row, r);
      if (t0 + r < w.n) {
        if (!PAGED) row = row_of(w.pos(t0 + r));
        const size_t off = row + cc * V;
        cp_async16(ks + r * ROW + cc * 16, k + off, 16);
        cp_async16(vs + r * ROW + cc * 16, v + off, 16);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kDecStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  // This lane's chunks of the row: lane, lane + 8, ..; q pre-scaled into
  // log2 units.
  float qr[GM][D], acc[GM][D], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = i * kDecLPK + lane;
      if (g < gn && c < CH) {
        load_f32<T, V>(q + ((size_t)b * H + h0 + g) * HD + c * V, &qr[g][i * V]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) qr[g][i * V + e] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < D; ++e) {
      qr[g][e] *= scale_log2;
      acc[g][e] = 0.f;
    }
    m[g] = kNeg;
    l[g] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    if (i + kDecStages - 1 < n_tiles) load_tile(i + kDecStages - 1);
    cp_async_commit();
    cp_async_wait<kDecStages - 1>();                // tile i landed
    __syncthreads();
    const unsigned char* ks = dec_smem + (i % kDecStages) * 2 * kDecTK * ROW;
    const unsigned char* vs = ks + kDecTK * ROW;
    const int t0 = i * kDecTK;
#pragma unroll
    for (int u = 0; u < kDecTK / kDecGroups; ++u) {
      const int r = grp + u * kDecGroups;
      if (t0 + r >= w.n) break;                     // uniform per group
      float kr[D], vr[D];
#pragma unroll
      for (int i2 = 0; i2 < CPL; ++i2) {
        const int c = i2 * kDecLPK + lane;
        if (c < CH) {
          smem_f32<T>(ks + r * ROW + c * 16, &kr[i2 * V]);
          smem_f32<T>(vs + r * ROW + c * 16, &vr[i2 * V]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) kr[i2 * V + e] = vr[i2 * V + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) s += qr[g][e] * kr[e];
#pragma unroll
        for (int o = 1; o < kDecLPK; o <<= 1) s += __shfl_xor_sync(gmask, s, o);
        // One exp2 a key: the larger of (m, s) becomes the new max, and
        // the other's weight is exp2(smaller - larger).
        const bool grow = s > m[g];
        const float w = exp2f(fminf(m[g], s) - fmaxf(m[g], s));
        const float corr = grow ? w : 1.f, p = grow ? 1.f : w;
        m[g] = fmaxf(m[g], s);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < D; ++e) acc[g][e] = acc[g][e] * corr + p * vr[e];
      }
    }
    __syncthreads();                                // stage free for reuse
  }
  cp_async_wait<0>();

  // Merge the 4 key groups of a warp (lanes 8 and 16 apart), then the
  // warps through shared memory (the ring is free: every thread passed the
  // loop's last barrier).
#pragma unroll
  for (int off = kDecLPK; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mx), c = exp2f(mo - mx);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int e = 0; e < D; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * c;
      m[g] = mx;
    }
  float* sm_acc = reinterpret_cast<float*>(dec_smem);   // [warps][GM][HD]
  float* sm_ml = sm_acc + kDecWarps * GM * HD;          // [warps][GM][2]
  if (wl < kDecLPK) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = i * kDecLPK + lane;
        if (c < CH)
#pragma unroll
          for (int e = 0; e < V; ++e)
            sm_acc[(warp * GM + g) * HD + c * V + e] = acc[g][i * V + e];
      }
      if (wl == 0) {
        sm_ml[(warp * GM + g) * 2] = m[g];
        sm_ml[(warp * GM + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < gn * HD; i += kDecThreads) {
    const int g = i / HD, d = i % HD;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sm_ml[(w * GM + g) * 2]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = exp2f(sm_ml[(w * GM + g) * 2] - mx);
      lsum += sm_ml[(w * GM + g) * 2 + 1] * f;
      o += sm_acc[(w * GM + g) * HD + d] * f;
    }
    const size_t bh = (size_t)b * H + h0 + g;
    if (n_split == 1) {
      out[bh * HD + d] = from_f<T>(o / fmaxf(lsum, 1e-30f));
    } else {
      part[(bh * n_split + sp) * HD + d] = o;
      if (d == 0) {
        float* ml = part + (size_t)B * H * n_split * HD + (bh * n_split + sp) * 2;
        ml[0] = mx;
        ml[1] = lsum;
      }
    }
  }
}

// Merges each (row, head)'s non-empty splits: one block per (head, row),
// one thread per head dim.  A row whose window is empty comes out as 0.
// Launched as a programmatic dependent of the split kernel, so its launch
// and its reads of the windows overlap that kernel's tail; it reads the
// partials only after griddepcontrol.wait (the split kernel done, its
// writes visible).
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
flash_decode_combine_kernel(const float* __restrict__ part,
                            const int* __restrict__ starts,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, int H, int n_split,
                            int prefix, int chunk, int cap) {
  const int h = blockIdx.x, b = blockIdx.y, B = gridDim.y, d = threadIdx.x;
  const int start = starts ? max(starts[b], 0) : 0;
  const int len = min(lengths[b], cap);
  const size_t bh = (size_t)b * H + h;
  const float* acc = part + bh * n_split * HD;
  const float* ml = part + (size_t)B * H * n_split * HD + bh * n_split * 2;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // One online pass; the loads are unconditional (an empty split's slots
  // hold garbage that is never used) so unrolled splits load together.
  float mx = kNeg, lsum = 0.f, o = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < n_split; ++sp) {
    const float m = ml[2 * sp], l = ml[2 * sp + 1], a = acc[sp * HD + d];
    if (split_window(prefix, start, len, sp, chunk).n == 0) continue;
    const float mn = fmaxf(mx, m);
    const float f0 = exp2f(mx - mn), f1 = exp2f(m - mn);
    lsum = lsum * f0 + l * f1;
    o = o * f0 + a * f1;
    mx = mn;
  }
  out[bh * HD + d] = from_f<T>(o / fmaxf(lsum, 1e-30f));
}

}  // namespace

// dtype codes shared with kernels/flash_attention.py
enum { kFloat32 = 0, kBFloat16 = 1 };

// Sets a kernel's dynamic shared memory limit once per instantiation.
#define REPRO_SMEM_ATTR(KERNEL, BYTES)                                        \
  do {                                                                        \
    static bool attr_set = false;                                             \
    if (!attr_set) {                                                          \
      const cudaError_t e = cudaFuncSetAttribute(                             \
          KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (BYTES));      \
      if (e != cudaSuccess) return (int)e;                                    \
      attr_set = true;                                                        \
    }                                                                         \
  } while (0)

// The decode's instantiations: GM = 1 (one query head a kv head) or the
// head dim's most.
#define REPRO_DECODE_DISPATCH(DTYPE, HD_, G, LAUNCH)                          \
  do {                                                                        \
    const bool one = (G) == 1;                                                \
    if ((DTYPE) == kFloat32 && (HD_) == 64) {                                 \
      if (one) LAUNCH(float, 64, 1); else LAUNCH(float, 64, dec_gmax<64>());  \
    } else if ((DTYPE) == kFloat32 && (HD_) == 80) {                          \
      if (one) LAUNCH(float, 80, 1); else LAUNCH(float, 80, dec_gmax<80>());  \
    } else if ((DTYPE) == kFloat32 && (HD_) == 128) {                         \
      if (one) LAUNCH(float, 128, 1); else LAUNCH(float, 128, dec_gmax<128>()); \
    } else if ((DTYPE) == kBFloat16 && (HD_) == 64) {                         \
      if (one) LAUNCH(__nv_bfloat16, 64, 1);                                  \
      else LAUNCH(__nv_bfloat16, 64, dec_gmax<64>());                         \
    } else if ((DTYPE) == kBFloat16 && (HD_) == 80) {                         \
      if (one) LAUNCH(__nv_bfloat16, 80, 1);                                  \
      else LAUNCH(__nv_bfloat16, 80, dec_gmax<80>());                         \
    } else if ((DTYPE) == kBFloat16 && (HD_) == 128) {                        \
      if (one) LAUNCH(__nv_bfloat16, 128, 1);                                 \
      else LAUNCH(__nv_bfloat16, 128, dec_gmax<128>());                       \
    } else {                                                                  \
      return (int)cudaErrorInvalidValue;                                      \
    }                                                                         \
  } while (0)

namespace {

// Both decodes: the split kernel over grid (KV x head groups, B, n_split),
// then, with more than one split, the combine over (H, B).
template <typename T, int HD, int GM, bool PAGED>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* tables, const void* starts, const void* lengths,
                  void* out, void* part, int B, int seq, int H, int KV,
                  int max_blocks, int prefix, int n_split, int chunk,
                  float scale, cudaStream_t st) {
  constexpr int bytes = dec_smem_bytes<T, HD, GM>();
  REPRO_SMEM_ATTR((flash_decode_split_kernel<T, HD, GM, PAGED>), bytes);
  const int n_hg = (H / KV + GM - 1) / GM;
  const dim3 grid(KV * n_hg, B, n_split);
  flash_decode_split_kernel<T, HD, GM, PAGED><<<grid, kDecThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)tables,
      (const int*)starts, (const int*)lengths, (T*)out, (float*)part, seq, H,
      KV, max_blocks, prefix, chunk, scale * kLog2e);
  if (n_split > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(H, B);
    cfg.blockDim = dim3(HD);
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(
        &cfg, flash_decode_combine_kernel<T, HD>, (const float*)part,
        (const int*)starts, (const int*)lengths, (T*)out, H, n_split, prefix,
        chunk, PAGED ? max_blocks * seq : seq);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,S,H,hd); k, v (B,Sk,KV,hd) (Sk == S when causal); starts (B,) int32
// or NULL; out like q.  Key j of row b is valid iff j < Sk and (j < prefix
// or j >= prefix + starts[b]) (a vision prefix in front of the left pad;
// prefix 0: j >= starts[b]).
// bf16 runs through wgmma, fp32 as three-pass TF32 mma.sync.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* starts, void* out, int B, int S, int Sk,
                        int H, int KV, int hd, int dtype, int causal,
                        int prefix, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  if (dtype == kBFloat16) {
    const dim3 grid(H, B, (S + kTcBQ - 1) / kTcBQ);
#define LAUNCH_TC(HD)                                                         \
  do {                                                                        \
    constexpr int bytes = tc_smem_bytes<HD>();                                \
    REPRO_SMEM_ATTR(flash_attention_tc_kernel<HD>, bytes);                    \
    flash_attention_tc_kernel<HD><<<grid, kTcThreads, bytes, st>>>(           \
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,                     \
        (const __nv_bfloat16*)v, (const int*)starts, (__nv_bfloat16*)out, S,  \
        Sk, H, KV, causal, prefix, scale_log2);                               \
  } while (0)
    if (hd == 64) LAUNCH_TC(64);
    else if (hd == 80) LAUNCH_TC(80);
    else if (hd == 128) LAUNCH_TC(128);
    else return (int)cudaErrorInvalidValue;
#undef LAUNCH_TC
    return (int)cudaGetLastError();
  }
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B, (S + kF3BQ - 1) / kF3BQ);
#define LAUNCH_F3(HD)                                                         \
  do {                                                                        \
    constexpr int bytes = f3_smem_bytes<HD>();                                \
    REPRO_SMEM_ATTR(flash_attention_3xtf32_kernel<HD>, bytes);                \
    flash_attention_3xtf32_kernel<HD><<<grid, kF3Threads, bytes, st>>>(       \
        (const float*)q, (const float*)k, (const float*)v,                    \
        (const int*)starts, (float*)out, S, Sk, H, KV, causal, prefix,        \
        scale_log2);                                                          \
  } while (0)
  if (hd == 64) LAUNCH_F3(64);
  else if (hd == 80) LAUNCH_F3(80);
  else if (hd == 128) LAUNCH_F3(128);
  else return (int)cudaErrorInvalidValue;
#undef LAUNCH_F3
  return (int)cudaGetLastError();
}

// q (B,H,hd); k, v (B,S,KV,hd); starts, lengths (B,) int32 (starts may be
// NULL); out (B,H,hd); part fp32 scratch of B*H*n_split*(hd+2) floats (read
// only with n_split > 1); keys [c * chunk, (c + 1) * chunk) are split c.
// Keys [0, min(prefix, lengths[b])) and [prefix + starts[b], lengths[b])
// attend.
int flash_decode_fwd(const void* q, const void* k, const void* v,
                     const void* starts, const void* lengths, void* out,
                     void* part, int B, int S, int H, int KV, int hd,
                     int dtype, int prefix, int n_split, int chunk,
                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, HD, GM)                                                     \
  return launch_decode<T, HD, GM, false>(q, k, v, nullptr, starts, lengths,   \
                                         out, part, B, S, H, KV, 0, prefix,   \
                                         n_split, chunk, scale, st)
  REPRO_DECODE_DISPATCH(dtype, hd, H / KV, LAUNCH);
#undef LAUNCH
  return (int)cudaErrorInvalidValue;               // (not reached)
}

// q (B,H,hd); k_pool, v_pool (n_blocks, block_size, KV, hd); block_tables
// (B, max_blocks) int32; starts, lengths (B,) int32; out (B,H,hd); part
// and the splits as for flash_decode_fwd, over max_blocks * block_size.
int paged_flash_decode_fwd(const void* q, const void* k_pool,
                           const void* v_pool, const void* block_tables,
                           const void* starts, const void* lengths, void* out,
                           void* part, int B, int H, int KV, int hd,
                           int block_size, int max_blocks, int dtype,
                           int n_split, int chunk, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, HD, GM)                                                     \
  return launch_decode<T, HD, GM, true>(q, k_pool, v_pool, block_tables,      \
                                        starts, lengths, out, part, B,        \
                                        block_size, H, KV, max_blocks, 0,     \
                                        n_split, chunk, scale, st)
  REPRO_DECODE_DISPATCH(dtype, hd, H / KV, LAUNCH);
#undef LAUNCH
  return (int)cudaErrorInvalidValue;               // (not reached)
}

}  // extern "C"
