"""The arithmetic of the port's bf16 tensor-core kernels, modelled on the
CPU and held against the JAX package.

The kernels themselves (``csrc/flash_attention.cu``
``flash_attention_tc_kernel``, ``csrc/dequant_matmul.cu``
``dequant_matmul_wgmma_kernel``) run only on a card; these tests model, in
torch on the CPU, the roundings they make, and check that those stay
inside the tolerances ``chip_smoke.py`` holds the kernels to on the card
(``TOL["bfloat16"]`` and ``DEQUANT_TOL["bfloat16"]``, both atol = rtol =
2e-2, read from the script itself):

- prefill attention: 64-key tiles from the tile that holds the left-pad
  start, fp32 scores scaled into log2 units, an online softmax in fp32
  (exp2), the probabilities rounded to bf16 before ``P V`` while the row
  sums add them unrounded, fp32 accumulators, one reciprocal, a bf16
  output; a causal q tile wholly inside the pad is written as zeros.
  Held against an fp64 attention and against
  ``repro.kernels.ref.flash_attention_ref`` (whose own scores and
  normalised probabilities are rounded to bf16) on each row's valid
  window, at llama2-7b's head dim 128 (S = 512, starts inside a tile,
  GQA) and zamba2's head dim 80 (S = 301, a whole q tile in the pad,
  whose rows must be finite);
- the dequant product: bf16 x times the bf16-rounded decoded weight,
  products exact in fp32 and summed in fp32 sixteen at a time (one
  ``wgmma`` k16 step), the sum rounded to bf16; held against the fp64
  product of the same x and the reference's decode
  (``repro.dist.quant.dequantize_leaf`` rounded to bf16).

The inputs are made with numpy from seeds and cross as numpy arrays.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.dist import quant as JQ  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.dist import quant as Q  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
ATTN_TOL = chip_smoke.TOL["bfloat16"]
DEQUANT_TOL = chip_smoke.DEQUANT_TOL["bfloat16"]

BQ = BK = 64                      # the attention kernel's q and key tiles
LOG2E = 1.4426950408889634
NEG = -1e30


def tc_attention_model(q, k, v, starts, causal=True):
    """The tensor-core prefill kernel's arithmetic.  q (B,S,H,hd), k/v
    (B,S,KV,hd) bf16; starts (B,) ints.  Returns (B,S,H,hd) bf16."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    scale_log2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((b, s, h, hd), dtype=torch.float32)
    for bi in range(b):
        st = max(int(starts[bi]), 0)
        for q0 in range(0, s, BQ):
            q_end = min(q0 + BQ, s)
            if causal and q_end <= st:           # the kernel writes zeros
                continue
            kv_end = q_end if causal else s
            qi = torch.arange(q0, q_end)
            m = torch.full((h, q_end - q0), NEG)
            l = torch.zeros((h, q_end - q0))
            acc = torch.zeros((h, q_end - q0, hd))
            for t in range(min(st, kv_end) // BK, -(-kv_end // BK)):
                k0 = t * BK
                kp = torch.arange(k0, k0 + BK)
                kt = torch.zeros((BK, h, hd))    # keys past S zero-filled
                vt = torch.zeros((BK, h, hd))
                n = min(k0 + BK, s) - k0
                kt[:n] = kf[bi, k0:k0 + n].repeat_interleave(rep, dim=1)
                vt[:n] = vf[bi, k0:k0 + n].repeat_interleave(rep, dim=1)
                sc = torch.einsum("rhd,khd->hrk", qf[bi, q0:q_end], kt)
                sc = sc * scale_log2
                ok = (kp[None] >= st) & (kp[None] < s)
                if causal:
                    ok = ok & (kp[None] <= qi[:, None])
                sc = torch.where(ok[None], sc, torch.full_like(sc, NEG))
                mx = torch.maximum(m, sc.amax(-1))
                corr = torch.exp2(m - mx)
                m = mx
                p = torch.exp2(sc - mx[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "hrk,khd->hrd", p.bfloat16().float(), vt)
            inv = 1.0 / torch.clamp(l, min=1e-30)
            out[bi, q0:q_end] = (acc * inv[..., None]).permute(1, 0, 2)
    return out.bfloat16()


def _bf16(rng, *shape, scale=1.0):
    """numpy fp32 values rounded to bf16, as (torch bf16, jax bf16)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _within(got, want, tol):
    err = np.abs(got - want)
    return float(err.max()), bool((err <= tol + tol * np.abs(want)).all())


def exact_attention(q, k, v, st):
    """fp64 causal attention of one batch row's valid window [st, S):
    (S - st, H, hd)."""
    rep = q.shape[1] // k.shape[1]
    qq = q[st:].double()
    kk = k[st:].double().repeat_interleave(rep, dim=1)
    vv = v[st:].double().repeat_interleave(rep, dim=1)
    sc = torch.einsum("qhd,khd->hqk", qq, kk) / math.sqrt(q.shape[-1])
    n = qq.shape[0]
    causal = torch.tril(torch.ones((n, n), dtype=torch.bool))
    sc = torch.where(causal, sc, torch.full_like(sc, -1e300))
    return torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), vv).numpy()


@pytest.mark.parametrize("b,s,h,kvh,hd,starts,q_scale", [
    (2, 512, 4, 2, 128, [37, 100], 1.0),  # llama2-7b's head dim, GQA
    (2, 512, 4, 2, 128, [37, 100], 2.0),  # the same with peaked rows
    (2, 301, 2, 2, 80, [0, 120], 1.0),    # zamba2's; rows 0-119 of row 1 pad
], ids=["hd128-s512", "hd128-s512-peaked", "hd80-s301"])
def test_tc_attention_arithmetic_within_tol_of_jax(b, s, h, kvh, hd, starts,
                                                   q_scale):
    """Valid rows within ``TOL`` of the fp64 attention and no further from
    it than JAX's bf16 reference; at chip_smoke.py's input scale (q, k, v
    ~ N(0, 1)) also within ``TOL`` of that reference.  (With peaked rows
    the reference's own bf16 scores and normalised bf16 probabilities are
    0.03 from fp64, over ``TOL``, so there the model is held to fp64
    only.)  Pad rows are finite, and the q tiles wholly in the pad are
    zeros."""
    rng = np.random.default_rng(15)
    q, jq = _bf16(rng, b, s, h, hd, scale=q_scale)
    k, jk = _bf16(rng, b, s, kvh, hd)
    v, jv = _bf16(rng, b, s, kvh, hd)
    got = tc_attention_model(q, k, v, starts).float().numpy()
    assert np.isfinite(got).all()                # pad rows included
    rep = h // kvh
    for bi, st in enumerate(starts):
        # the valid window [st, S) alone is causal attention from 0
        want = jax_ref.flash_attention_ref(
            jq[bi:bi + 1, st:], jnp.repeat(jk[bi:bi + 1, st:], rep, axis=2),
            jnp.repeat(jv[bi:bi + 1, st:], rep, axis=2))[0]
        want = np.asarray(want.astype(jnp.float32))
        exact = exact_attention(q[bi], k[bi], v[bi], st)
        err, ok = _within(got[bi, st:], exact, ATTN_TOL)
        assert ok, f"row {bi}: max |err| {err} from fp64 over {ATTN_TOL}"
        assert err <= float(np.abs(want - exact).max())
        if q_scale == 1.0:
            err, ok = _within(got[bi, st:], want, ATTN_TOL)
            assert ok, f"row {bi}: max |err| {err} from JAX over {ATTN_TOL}"
        full_pad = (st // BQ) * BQ               # q tiles wholly in the pad
        assert (got[bi, :full_pad] == 0).all()


def tc_dequant_model(x, w):
    """The tensor-core dequant kernel's arithmetic: x (M,K) bf16, w (K,N)
    the bf16-rounded decoded weight; fp32 sums of 16 exact products at a
    time, accumulated in fp32; the result rounded to bf16."""
    xf, wf = x.float(), w.float()
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    for k0 in range(0, x.shape[1], 16):
        acc = acc + xf[:, k0:k0 + 16] @ wf[k0:k0 + 16]
    return acc.bfloat16()


@pytest.mark.parametrize("m,k,n,stacked", [
    (64, 512, 384, True),                # a layer view, scale tile rows 8
    (48, 256, 640, False),               # a 2-d leaf (the head), rows 1
    (33, 1000, 200, True),               # ragged K and N, odd M
], ids=["layer", "head", "ragged"])
@pytest.mark.parametrize("fmt", ["int8", "nf4"])
def test_tc_dequant_arithmetic_within_tol_of_fp64(fmt, m, k, n, stacked):
    rng = np.random.default_rng(16)
    shape = (2, k, n) if stacked else (k, n)
    w = (rng.standard_normal(shape) / math.sqrt(k)).astype(np.float32)
    tw = torch.from_numpy(w).bfloat16()
    rec = Q.quantize_leaf(tw, fmt)
    view = Q.layer_of(rec, 1) if stacked else Q.view_of(rec)
    wd = view.decode().bfloat16()
    jw = JQ.dequantize_leaf(JQ.quantize_leaf(
        jnp.asarray(tw.float().numpy()).astype(jnp.bfloat16), fmt))
    jw = np.asarray(jw.astype(jnp.bfloat16).astype(jnp.float32))
    jw = jw[1] if stacked else jw
    np.testing.assert_array_equal(wd.float().numpy(), jw)  # same decode
    x, _ = _bf16(rng, m, k)
    got = tc_dequant_model(x, wd).float().numpy()
    want = x.double().numpy() @ jw.astype(np.float64)
    err, ok = _within(got, want, DEQUANT_TOL)
    assert ok, f"max |err| {err} over {DEQUANT_TOL}"
    # decoding through x = I stays exact: one nonzero product a sum
    eye = tc_dequant_model(torch.eye(k, dtype=torch.bfloat16), wd)
    assert torch.equal(eye, wd)


def test_cpu_wrappers_count_no_tensor_core_launches():
    """On CPU tensors the bf16 wrappers take their plain versions: neither
    ``launches`` nor the tensor-core count ``launches_tc`` moves, and
    ``reset_launches`` clears both."""
    from repro_torch.kernels import dequant_matmul as DM
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref
    rng = np.random.default_rng(17)
    q, _ = _bf16(rng, 1, 70, 2, 80)
    k, _ = _bf16(rng, 1, 70, 2, 80)
    starts = torch.tensor([5], dtype=torch.int32)
    K.flash_attention.launches_tc = DM.dequant_matmul.launches_tc = 3
    before = (K.flash_attention.launches, DM.dequant_matmul.launches)
    got = K.flash_attention(q, k, k, starts=starts)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, k, starts),
                               rtol=0, atol=0)
    view = Q.view_of(Q.quantize_leaf(torch.randn(64, 130).bfloat16(), "nf4"))
    x, _ = _bf16(rng, 3, 64)
    torch.testing.assert_close(DM.dequant_matmul(x, view),
                               ref.dequant_matmul_ref(x, view), rtol=0, atol=0)
    assert (K.flash_attention.launches, DM.dequant_matmul.launches) == before
    assert K.flash_attention.launches_tc == DM.dequant_matmul.launches_tc == 3
    K.reset_launches()
    DM.reset_launches()
    assert K.flash_attention.launches_tc == DM.dequant_matmul.launches_tc == 0
