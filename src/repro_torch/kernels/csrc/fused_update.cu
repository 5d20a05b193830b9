// Fused optimizer updates for the HiFT training path, written by hand for
// Hopper (sm_90a), each behind a plain C entry point that returns
// cudaGetLastError().
//
// fused_adamw    replaces fused_adamw_pallas   (src/repro/kernels/fused_adamw.py:41)
// fused_sgdm     replaces fused_sgdm_pallas    (src/repro/kernels/fused_sgdm.py:29)
// fused_adagrad  replaces fused_adagrad_pallas (src/repro/kernels/fused_adagrad.py:30)
// (all three reach pl.pallas_call through elementwise_update_call,
// src/repro/kernels/ops.py:70, call :103.)
//
// What they compute: src/repro/kernels/ref.py:45-71, in its operation order,
// all math in fp32:
//   AdamW:  m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g;  mhat = m/c1;
//           vhat = v/c2;  p -= lr*(mhat/(sqrt(vhat)+eps) + wd*p)
//   SGD-m:  g += wd*p;  mu = momentum*mu + g;  p -= lr*mu
//   AdaGrad: g += wd*p;  a += g*g;  p -= (lr*g)/(sqrt(a)+eps)
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into a fused
// multiply-add and the kernel equals its plain PyTorch version
// (kernels/ref.py, one eager op per operation) bit for bit.  Loads and
// stores use each leaf's own dtype (float32 or bfloat16); stores round to
// nearest even, as astype does.  The host folds 1-b1, 1-b2 in double and
// passes every constant as float, as JAX does with its weakly typed Python
// scalars; c1 and c2 come from the host's step count.
//
// Bound: bytes.  An element costs 8-15 flops against 20 B (SGD-m, AdaGrad)
// or 28 B (AdamW) of fp32 traffic: read p, g and the moments once, write p
// and the moments once.  One llama2-7b layer group (202,383,360 elements)
// is 1.69 ms of AdamW traffic at 3.35 TB/s.
//
// Design.  The reference concatenates a group's leaves into one stream per
// dtype bucket (ops.py:129-162), which on this card would cost an extra
// pass over HBM and a transient copy of the group.  Here one launch covers
// a bucket in place: a table of per-leaf pointers and sizes rides by value
// in the kernel's parameters (__grid_constant__, read from the constant
// bank), each block owns a contiguous chunk of kChunk elements of one leaf
// (its leaf found by a scan of the table's block offsets), and params and
// moments are written where they lie — the counterpart of the reference's
// buffer donation (ops.py:101-109).  Each thread loads all kUnroll of its
// elements before it computes any, so 8 loads per stream are in flight per
// thread.  Scalar loads only: vector loads and a persistent grid are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 32;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr long long kChunk = (long long)kThreads * kUnroll;

struct LeafTable {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  void* s0[kMaxLeaves];
  void* s1[kMaxLeaves];
  long long n[kMaxLeaves];
  long long first_block[kMaxLeaves + 1];
  int count;
};

struct AdamWArgs { float lr, b1, omb1, b2, omb2, eps, wd, c1, c2; };
struct SgdmArgs { float lr, momentum, wd; };
struct AdagradArgs { float lr, eps, wd; };

__device__ __forceinline__ float ld(const float* x, long long i) { return x[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ void st(float* x, long long i, float v) { x[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* x, long long i, float v) {
  x[i] = __float2bfloat16_rn(v);
}

// This block's leaf and the first element of its chunk.
struct Chunk { int leaf; long long base, n; };

__device__ __forceinline__ Chunk my_chunk(const LeafTable& t) {
  const long long b = blockIdx.x;
  int l = 0;
  while (l + 1 < t.count && b >= t.first_block[l + 1]) ++l;
  return {l, (b - t.first_block[l]) * kChunk, t.n[l]};
}

template <class P, class G, class S>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ LeafTable t, const AdamWArgs a) {
  const Chunk c = my_chunk(t);
  P* p = static_cast<P*>(t.p[c.leaf]);
  const G* g = static_cast<const G*>(t.g[c.leaf]);
  S* m = static_cast<S*>(t.s0[c.leaf]);
  S* v = static_cast<S*>(t.s1[c.leaf]);
  float pr[kUnroll], gr[kUnroll], mr[kUnroll], vr[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = c.base + u * kThreads + threadIdx.x;
    if (i < c.n) { pr[u] = ld(p, i); gr[u] = ld(g, i); mr[u] = ld(m, i); vr[u] = ld(v, i); }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = c.base + u * kThreads + threadIdx.x;
    if (i >= c.n) continue;
    const float gg = gr[u];
    const float mn = __fadd_rn(__fmul_rn(a.b1, mr[u]), __fmul_rn(a.omb1, gg));
    const float vn = __fadd_rn(__fmul_rn(a.b2, vr[u]),
                               __fmul_rn(a.omb2, __fmul_rn(gg, gg)));
    const float mhat = __fdiv_rn(mn, a.c1);
    const float vhat = __fdiv_rn(vn, a.c2);
    const float step = __fmul_rn(
        a.lr, __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), a.eps)),
                        __fmul_rn(a.wd, pr[u])));
    st(p, i, __fsub_rn(pr[u], step));
    st(m, i, mn);
    st(v, i, vn);
  }
}

template <class P, class G, class S>
__global__ void __launch_bounds__(kThreads)
sgdm_kernel(const __grid_constant__ LeafTable t, const SgdmArgs a) {
  const Chunk c = my_chunk(t);
  P* p = static_cast<P*>(t.p[c.leaf]);
  const G* g = static_cast<const G*>(t.g[c.leaf]);
  S* mu = static_cast<S*>(t.s0[c.leaf]);
  float pr[kUnroll], gr[kUnroll], mr[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = c.base + u * kThreads + threadIdx.x;
    if (i < c.n) { pr[u] = ld(p, i); gr[u] = ld(g, i); mr[u] = ld(mu, i); }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = c.base + u * kThreads + threadIdx.x;
    if (i >= c.n) continue;
    const float gg = __fadd_rn(gr[u], __fmul_rn(a.wd, pr[u]));
    const float mn = __fadd_rn(__fmul_rn(a.momentum, mr[u]), gg);
    st(p, i, __fsub_rn(pr[u], __fmul_rn(a.lr, mn)));
    st(mu, i, mn);
  }
}

template <class P, class G, class S>
__global__ void __launch_bounds__(kThreads)
adagrad_kernel(const __grid_constant__ LeafTable t, const AdagradArgs a) {
  const Chunk c = my_chunk(t);
  P* p = static_cast<P*>(t.p[c.leaf]);
  const G* g = static_cast<const G*>(t.g[c.leaf]);
  S* acc = static_cast<S*>(t.s0[c.leaf]);
  float pr[kUnroll], gr[kUnroll], ar[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = c.base + u * kThreads + threadIdx.x;
    if (i < c.n) { pr[u] = ld(p, i); gr[u] = ld(g, i); ar[u] = ld(acc, i); }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = c.base + u * kThreads + threadIdx.x;
    if (i >= c.n) continue;
    const float gg = __fadd_rn(gr[u], __fmul_rn(a.wd, pr[u]));
    const float an = __fadd_rn(ar[u], __fmul_rn(gg, gg));
    const float step = __fdiv_rn(__fmul_rn(a.lr, gg),
                                 __fadd_rn(__fsqrt_rn(an), a.eps));
    st(p, i, __fsub_rn(pr[u], step));
    st(acc, i, an);
  }
}

// Fill the table; returns the number of blocks, or -1 if it does not fit.
long long make_table(LeafTable* t, void** p, const void** g, void** s0,
                     void** s1, const long long* n, int count) {
  if (count < 1 || count > kMaxLeaves) return -1;
  t->count = count;
  long long blocks = 0;
  for (int l = 0; l < count; ++l) {
    t->p[l] = p[l];
    t->g[l] = g[l];
    t->s0[l] = s0[l];
    t->s1[l] = s1 ? s1[l] : nullptr;
    t->n[l] = n[l];
    t->first_block[l] = blocks;
    blocks += (n[l] + kChunk - 1) / kChunk;
  }
  t->first_block[count] = blocks;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

// Call f(P{}, G{}, S{}) for dtype codes 0 = float32, 1 = bfloat16.
template <class F>
void by_dtype(int dp, int dg, int ds, F f) {
  auto with_s = [&](auto pt, auto gt) {
    if (ds == 0) f(pt, gt, float{}); else f(pt, gt, __nv_bfloat16{});
  };
  auto with_g = [&](auto pt) {
    if (dg == 0) with_s(pt, float{}); else with_s(pt, __nv_bfloat16{});
  };
  if (dp == 0) with_g(float{}); else with_g(__nv_bfloat16{});
}

bool bad_dtypes(int dp, int dg, int ds) {
  return dp < 0 || dp > 1 || dg < 0 || dg > 1 || ds < 0 || ds > 1;
}

}  // namespace

extern "C" {

// p, g, m, v: arrays of `count` leaf pointers, n their element counts; the
// leaves of one call share (dp, dg, ds) dtype codes.  p, m, v in place.
int fused_adamw(void** p, const void** g, void** m, void** v,
                const long long* n, int count, int dp, int dg, int ds,
                float lr, float b1, float omb1, float b2, float omb2,
                float eps, float wd, float c1, float c2, void* stream) {
  LeafTable t;
  const long long blocks = make_table(&t, p, g, m, v, n, count);
  if (blocks < 0 || bad_dtypes(dp, dg, ds)) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const AdamWArgs a{lr, b1, omb1, b2, omb2, eps, wd, c1, c2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  by_dtype(dp, dg, ds, [&](auto pt, auto gt, auto s) {
    adamw_kernel<decltype(pt), decltype(gt), decltype(s)>
        <<<(unsigned)blocks, kThreads, 0, st>>>(t, a);
  });
  return (int)cudaGetLastError();
}

// p, g, mu as fused_adamw's p, g, m.
int fused_sgdm(void** p, const void** g, void** mu, const long long* n,
               int count, int dp, int dg, int ds, float lr, float momentum,
               float wd, void* stream) {
  LeafTable t;
  const long long blocks = make_table(&t, p, g, mu, nullptr, n, count);
  if (blocks < 0 || bad_dtypes(dp, dg, ds)) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const SgdmArgs a{lr, momentum, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  by_dtype(dp, dg, ds, [&](auto pt, auto gt, auto s) {
    sgdm_kernel<decltype(pt), decltype(gt), decltype(s)>
        <<<(unsigned)blocks, kThreads, 0, st>>>(t, a);
  });
  return (int)cudaGetLastError();
}

// p, g, accum as fused_adamw's p, g, m.
int fused_adagrad(void** p, const void** g, void** accum, const long long* n,
                  int count, int dp, int dg, int ds, float lr, float eps,
                  float wd, void* stream) {
  LeafTable t;
  const long long blocks = make_table(&t, p, g, accum, nullptr, n, count);
  if (blocks < 0 || bad_dtypes(dp, dg, ds)) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const AdagradArgs a{lr, eps, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  by_dtype(dp, dg, ds, [&](auto pt, auto gt, auto s) {
    adagrad_kernel<decltype(pt), decltype(gt), decltype(s)>
        <<<(unsigned)blocks, kThreads, 0, st>>>(t, a);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
