"""The arithmetic of the port's fp32 prefill and split-KV decode kernels,
modelled on the CPU and held against the JAX package.

The kernels (``csrc/flash_attention.cu``: ``flash_attention_3xtf32_kernel``,
``flash_decode_split_kernel`` with ``flash_decode_combine_kernel``) run
only on a card; these tests model, in torch on the CPU, the arithmetic
they do, and check that it stays inside the tolerances ``chip_smoke.py``
holds the kernels to on the card (``TOL``, read from the script itself):

- the fp32 prefill as three TF32 products: each operand x is split into
  ``tf32(x)`` and ``tf32(x - tf32(x))`` (round to nearest, ties away: the
  low 13 mantissa bits cleared), and ``a b`` is taken as ``a_big b_big +
  a_big b_small + a_small b_big`` with fp32 sums, for Q K^T and for P V
  alike; the kernel's 32-row q tiles (a tile wholly in the left pad is
  zeros), its 16-key tiles from the tile that holds the start, its two key
  parts (alternate tiles) each with an online softmax in log2 units, and
  their merge.  Held against ``repro.kernels.ref.flash_attention_ref`` and
  an fp64 attention at ``TOL["float32"]``; one TF32 pass alone misses it;
- the split-KV decode: the host's split plan (``split_plan``), each
  split's 16 key groups with their own one-exp online softmax, the
  block's merge of its groups, the combine of a row's non-empty splits,
  and 0 for an empty window.  Held against
  ``repro.kernels.ref.flash_decode_ref`` and an fp64 decode (fp32 and
  bf16, ragged windows, GQA) and, over a paged pool, against
  ``paged_flash_decode_pallas`` run in interpret mode.

The wrappers' own checks (shapes, devices) and the arguments they hand
the C entry points are checked here too.  Inputs are made with numpy
from seeds and cross as numpy arrays.
"""
import ctypes
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import paged_flash_decode_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as K  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TOL = chip_smoke.TOL

BQ, BK, PARTS = 32, 16, 2        # the fp32 prefill's q rows, keys, key parts
GROUPS, TK = 16, 32              # the decode's key groups and ring tile
LOG2E = 1.4426950408889634
NEG = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 explicit mantissa bits,
    to nearest with ties away from zero (the bit pattern is
    sign-magnitude, so adding half of the dropped range rounds the
    magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """``einsum(eq, a, b)`` as the kernel takes it: three TF32 products
    summed in fp32 (the small ones apart), or one with ``passes=1``."""
    ab, asm = split(a)
    bb, bsm = split(b)
    out = torch.einsum(eq, ab, bb)
    if passes == 3:
        out = out + (torch.einsum(eq, asm, bb) + torch.einsum(eq, ab, bsm))
    return out


def prefill_model(q, k, v, starts, passes: int = 3, causal: bool = True):
    """The fp32 prefill kernel's arithmetic.  q (B,S,H,hd), k/v
    (B,Sk,KV,hd) fp32 (Sk == S when causal); starts (B,) ints.  Returns
    (B,S,H,hd) fp32."""
    b, s, h, hd = q.shape
    sk = k.shape[1]
    rep = h // k.shape[2]
    scale_log2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    out = torch.zeros((b, s, h, hd), dtype=torch.float32)
    for bi in range(b):
        st = max(int(starts[bi]), 0)
        kk = k[bi].repeat_interleave(rep, dim=1)
        vv = v[bi].repeat_interleave(rep, dim=1)
        for q0 in range(0, s, BQ):
            q_end = min(q0 + BQ, s)
            if causal and q_end <= st:            # the kernel writes zeros
                continue
            qi = torch.arange(q0, q_end)
            kv_end = q_end if causal else sk
            t_lo, t_hi = min(st, kv_end) // BK, -(-kv_end // BK)
            states = []
            for part in range(PARTS):
                m = torch.full((h, q_end - q0), NEG)
                l = torch.zeros((h, q_end - q0))
                acc = torch.zeros((h, q_end - q0, hd))
                for t in range(t_lo + part, t_hi, PARTS):
                    k0 = t * BK
                    kp = torch.arange(k0, k0 + BK)
                    kt = torch.zeros((BK, h, hd))  # keys past Sk zero-filled
                    vt = torch.zeros((BK, h, hd))
                    n = min(k0 + BK, sk) - k0
                    kt[:n], vt[:n] = kk[k0:k0 + n], vv[k0:k0 + n]
                    sc = product("rhd,khd->hrk", q[bi, q0:q_end], kt)
                    sc = sc * scale_log2
                    ok = (kp[None] >= st) & (kp[None] < sk) & \
                        ((kp[None] <= qi[:, None]) | (not causal))
                    sc = torch.where(ok[None], sc, torch.full_like(sc, NEG))
                    mx = torch.maximum(m, sc.amax(-1))
                    corr = torch.exp2(m - mx)
                    m = mx
                    p = torch.exp2(sc - mx[..., None])
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + product("hrk,khd->hrd", p,
                                                          vt, passes)
                states.append((m, l, acc))
            (m0, l0, a0), (m1, l1, a1) = states
            mx = torch.maximum(m0, m1)
            f0, f1 = torch.exp2(m0 - mx), torch.exp2(m1 - mx)
            l = l0 * f0 + l1 * f1
            acc = a0 * f0[..., None] + a1 * f1[..., None]
            out[bi, q0:q_end] = (acc / torch.clamp(l, min=1e-30)[..., None]
                                 ).permute(1, 0, 2)
    return out


def exact_attention(q, k, v, st):
    """fp64 causal attention of one batch row's valid window [st, S)."""
    rep = q.shape[1] // k.shape[1]
    qq = q[st:].double()
    kk = k[st:].double().repeat_interleave(rep, dim=1)
    vv = v[st:].double().repeat_interleave(rep, dim=1)
    sc = torch.einsum("qhd,khd->hqk", qq, kk) / math.sqrt(q.shape[-1])
    n = qq.shape[0]
    causal = torch.tril(torch.ones((n, n), dtype=torch.bool))
    sc = torch.where(causal, sc, torch.full_like(sc, -1e300))
    return torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), vv).numpy()


def _within(got, want, tol):
    err = np.abs(got - want)
    return float(err.max()), bool((err <= tol + tol * np.abs(want)).all())


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


PREFILL_CASES = {
    # llama2-7b's head dim; the start inside the first 16-key tile
    "hd128-s256": (1, 256, 2, 2, 128, [11]),
    # zamba2's; rows 0-69 of row 1 in the pad, q tiles 0-1 wholly in it;
    # S not a multiple of either tile
    "hd80-pad-tiles": (2, 150, 2, 2, 80, [0, 70]),
    # GQA, two query heads a kv head
    "gqa-hd64": (2, 100, 4, 2, 64, [5, 33]),
}


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_3xtf32_prefill_within_tol_of_jax_and_fp64(case):
    """Valid rows within ``TOL["float32"]`` of JAX's fp32 attention and of
    fp64; pad rows finite, q tiles wholly in the pad zeros."""
    b, s, h, kvh, hd, starts = PREFILL_CASES[case]
    rng = np.random.default_rng(16)
    q, k, v = _f32(rng, b, s, h, hd), _f32(rng, b, s, kvh, hd), \
        _f32(rng, b, s, kvh, hd)
    got = prefill_model(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), starts).numpy()
    assert np.isfinite(got).all()                   # pad rows included
    tol = TOL["float32"]
    rep = h // kvh
    for bi, st in enumerate(starts):
        want = np.asarray(jax_ref.flash_attention_ref(
            jnp.asarray(q[bi:bi + 1, st:]),
            jnp.asarray(np.repeat(k[bi:bi + 1, st:], rep, axis=2)),
            jnp.asarray(np.repeat(v[bi:bi + 1, st:], rep, axis=2))))[0]
        err, ok = _within(got[bi, st:], want, tol)
        assert ok, f"row {bi}: max |err| {err} from JAX over {tol}"
        exact = exact_attention(torch.from_numpy(q[bi]),
                                torch.from_numpy(k[bi]),
                                torch.from_numpy(v[bi]), st)
        err, ok = _within(got[bi, st:], exact, tol)
        assert ok, f"row {bi}: max |err| {err} from fp64 over {tol}"
        full_pad = (st // BQ) * BQ                  # q tiles wholly in the pad
        assert (got[bi, :full_pad] == 0).all()


CROSS_CASES = {
    # seamless's head dim; an encoder's self attention (Sk == S)
    "encoder-hd64": (2, 96, 2, 2, 64, 96),
    # cross attention, q and k tiles both partial (37 over 300)
    "cross-ragged-hd64": (2, 37, 2, 2, 64, 300),
    # fewer keys than one key tile
    "cross-short-hd80": (1, 40, 2, 2, 80, 9),
}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_3xtf32_prefill_non_causal_over_another_key_length(case):
    """The non-causal prefill over Sk keys (the kv loop to Sk, the last
    key tile masked at Sk): within ``TOL["float32"]`` of the reference's
    ``chunked_attention(causal=False)`` and of fp64."""
    from repro.models.layers import chunked_attention
    b, s, h, kvh, hd, sk = CROSS_CASES[case]
    rng = np.random.default_rng(23)
    q, k, v = _f32(rng, b, s, h, hd), _f32(rng, b, sk, kvh, hd), \
        _f32(rng, b, sk, kvh, hd)
    got = prefill_model(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), [0] * b, causal=False).numpy()
    rep = h // kvh
    kk, vv = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    want = np.asarray(chunked_attention(jnp.asarray(q), jnp.asarray(kk),
                                        jnp.asarray(vv), 16, 16,
                                        causal=False))
    tol = TOL["float32"]
    err, ok = _within(got, want, tol)
    assert ok, f"max |err| {err} from JAX over {tol}"
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / math.sqrt(hd)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    exact = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), vv)
    err, ok = _within(got, exact, tol)
    assert ok, f"max |err| {err} from fp64 over {tol}"


def test_one_tf32_pass_misses_the_fp32_tolerance():
    """TF32 alone (one pass, as PyTorch's TF32 flag would give) is ~1e-3
    off: the three passes are what holds the kernel to fp32."""
    b, s, h, kvh, hd, starts = PREFILL_CASES["hd128-s256"]
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(_f32(rng, b, s, n, hd)) for n in (h, kvh, kvh))
    exact = exact_attention(q[0], k[0], v[0], starts[0])
    one = prefill_model(q, k, v, starts, passes=1).numpy()[0, starts[0]:]
    three = prefill_model(q, k, v, starts).numpy()[0, starts[0]:]
    assert not _within(one, exact, TOL["float32"])[1]
    assert np.abs(three - exact).max() < np.abs(one - exact).max() / 50


def decode_model(q, k, v, starts, lengths, n_split, chunk, dtype):
    """The split-KV decode's arithmetic over a contiguous view of the
    cache.  q (B,H,hd), k/v (B,S,KV,hd) in ``dtype``; returns (B,H,hd) in
    ``dtype``."""
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale_log2 = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    qf = q.float() * scale_log2
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    out = torch.zeros((b, h, hd), dtype=torch.float32)
    for bi in range(b):
        st, ln = max(int(starts[bi]), 0), min(int(lengths[bi]), s)
        parts = []
        for sp in range(n_split):
            lo, hi = max(st, sp * chunk), min(ln, (sp + 1) * chunk)
            if lo >= hi:                            # the block exits at once
                continue
            m = torch.full((GROUPS, h), NEG)
            l = torch.zeros((GROUPS, h))
            acc = torch.zeros((GROUPS, h, hd))
            for t0 in range(lo, hi, TK):
                for u in range(TK // GROUPS):
                    pos = t0 + u * GROUPS + torch.arange(GROUPS)
                    live = pos < hi
                    p_ = torch.clamp(pos, max=s - 1)
                    sc = torch.einsum("hd,ghd->gh", qf[bi], kf[bi, p_])
                    grow = sc > m                   # one exp2 a key
                    w = torch.exp2(torch.minimum(m, sc) - torch.maximum(m, sc))
                    corr = torch.where(grow, w, torch.ones_like(w))
                    p = torch.where(grow, torch.ones_like(w), w)
                    nm = torch.maximum(m, sc)
                    nl = l * corr + p
                    nacc = acc * corr[..., None] + p[..., None] * vf[bi, p_]
                    m = torch.where(live[:, None], nm, m)
                    l = torch.where(live[:, None], nl, l)
                    acc = torch.where(live[:, None, None], nacc, acc)
            for off in (1, 2):                      # a warp's 4 groups
                j = torch.arange(GROUPS) ^ off
                mx = torch.maximum(m, m[j])
                fa, fb = torch.exp2(m - mx), torch.exp2(m[j] - mx)
                l, acc = l * fa + l[j] * fb, \
                    acc * fa[..., None] + acc[j] * fb[..., None]
                m = mx
            m, l, acc = m[::4], l[::4], acc[::4]    # the 4 warps' partials
            mx = m.amax(0)
            f = torch.exp2(m - mx)
            parts.append((mx, (l * f).sum(0), (acc * f[..., None]).sum(0)))
        mx, lsum, o = torch.full((h,), NEG), torch.zeros(h), torch.zeros(h, hd)
        for pm, pl, po in parts:                    # the combine, one pass
            mn = torch.maximum(mx, pm)
            f0, f1 = torch.exp2(mx - mn), torch.exp2(pm - mn)
            lsum, o, mx = lsum * f0 + pl * f1, \
                o * f0[:, None] + po * f1[:, None], mn
        out[bi] = o / torch.clamp(lsum, min=1e-30)[:, None]   # empty: 0
    return out.to(dtype)


def exact_decode(q, k, v, starts, lengths):
    rep = q.shape[1] // k.shape[2]
    kk = k.double().repeat_interleave(rep, dim=2)
    vv = v.double().repeat_interleave(rep, dim=2)
    sc = torch.einsum("bhd,bkhd->bhk", q.double(), kk) / math.sqrt(q.shape[-1])
    pos = torch.arange(k.shape[1])[None]
    ok = (pos >= torch.as_tensor(starts)[:, None]) & \
        (pos < torch.as_tensor(lengths)[:, None])
    sc = torch.where(ok[:, None], sc, torch.full_like(sc, -1e300))
    return torch.einsum("bhk,bkhd->bhd", torch.softmax(sc, -1), vv).numpy()


DECODE_CASES = {
    # llama2-7b's head dim: ragged windows, a row whose first split is
    # empty, a row whose window is empty
    "hd128-ragged": (4, 300, 2, 2, 128, [0, 70, 250, 5], [300, 200, 250, 33]),
    # qwen2-0.5b's GQA: 7 query heads a kv head, hd 64
    "gqa7-hd64": (3, 300, 14, 2, 64, [0, 37, 100], [300, 281, 101]),
    # zamba2's hd 80; one split (the direct write)
    "hd80-one-split": (2, 60, 2, 2, 80, [0, 9], [60, 41]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_split_decode_within_tol_of_jax_and_fp64(case, dtype):
    """Non-empty rows within ``TOL`` of JAX's decode reference and of
    fp64 (bf16 outputs round once, where JAX's reference also rounds its
    probabilities); an empty window comes out as 0."""
    b, s, h, kvh, hd, starts, lengths = DECODE_CASES[case]
    n_split, chunk = K.split_plan(s, b * kvh, 132)
    assert (n_split == 1) == (case == "hd80-one-split")
    rng = np.random.default_rng(17)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(_f32(rng, *shape)).to(dt) for shape in
               ((b, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)))
    got = decode_model(q, k, v, starts, lengths, n_split, chunk,
                       dt).float().numpy()
    live = np.array([ln > st for st, ln in zip(starts, lengths)])
    assert (got[~live] == 0).all()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rep = h // kvh
    want = np.asarray(jax_ref.flash_decode_ref(
        jnp.asarray(q.float().numpy()).astype(jdt),
        jnp.asarray(np.repeat(k.float().numpy(), rep, axis=2)).astype(jdt),
        jnp.asarray(np.repeat(v.float().numpy(), rep, axis=2)).astype(jdt),
        jnp.asarray(np.array(lengths, np.int32)),
        jnp.asarray(np.array(starts, np.int32))).astype(jnp.float32))
    exact = exact_decode(q, k, v, starts, lengths)
    tol = TOL[dtype]
    for name, ref_ in (("JAX", want), ("fp64", exact)):
        err, ok = _within(got[live], ref_[live], tol)
        assert ok, f"max |err| {err} from {name} over {tol}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_decode_over_pages_matches_pallas_interpret(dtype):
    """Over a shuffled page pool (pages resolved from the table, a window
    starting mid-page, an idle row on the null page), the split decode of
    the gathered cache equals the Pallas paged kernel in interpret mode."""
    b, bs, max_blocks, h, kvh, hd = 3, 16, 8, 4, 2, 64
    n_blocks = 1 + b * max_blocks
    rng = np.random.default_rng(18)
    q, kp, vp = _f32(rng, b, h, hd), _f32(rng, n_blocks, bs, kvh, hd), \
        _f32(rng, n_blocks, bs, kvh, hd)
    tables = (rng.permutation(n_blocks - 1) + 1).reshape(b, max_blocks)
    tables = tables.astype(np.int32)
    tables[2] = 0                                   # idle row: null page
    starts, lengths = [3, 70, 0], [128, 100, 1]
    dt = getattr(torch, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tq, tk, tv = (torch.from_numpy(a).to(dt) for a in (q, kp, vp))
    cap = max_blocks * bs
    n_split, chunk = K.split_plan(cap, b * kvh, 132)
    assert n_split > 1
    idx = torch.from_numpy(tables).long()
    kk = tk[idx].reshape(b, cap, kvh, hd)
    vv = tv[idx].reshape(b, cap, kvh, hd)
    got = decode_model(tq, kk, vv, starts, lengths, n_split, chunk,
                       dt).float().numpy()
    want = np.asarray(paged_flash_decode_pallas(
        *(jnp.asarray(a.float().numpy()).astype(jdt) for a in (tq, tk, tv)),
        jnp.asarray(tables), jnp.asarray(np.array(lengths, np.int32)),
        jnp.asarray(np.array(starts, np.int32)),
        interpret=True).astype(jnp.float32))
    err, ok = _within(got, want, TOL[dtype])
    assert ok, f"max |err| {err} over {TOL[dtype]}"


@pytest.mark.parametrize("cap,blocks", [(544, 128), (4096, 32), (544, 8),
                                        (128, 6), (40, 4), (0, 4)])
def test_split_plan_fills_the_card_in_whole_tiles(cap, blocks):
    """Splits are whole 32-key ring tiles of at least 64 keys and cover
    the capacity; the longest row is cut into pieces enough for two
    blocks an SM, unless that would make a split smaller than 64 keys."""
    sms = 132
    n_split, chunk = K.split_plan(cap, blocks, sms)
    assert chunk % TK == 0 and chunk >= 64
    assert (n_split - 1) * chunk < max(cap, 1) <= n_split * chunk
    if n_split * blocks < 2 * sms:
        assert chunk == 64 or n_split == 1 and cap <= 64


def test_wrappers_check_shapes_and_devices_on_every_path():
    """Shape errors raise on CPU tensors too, before the plain version;
    k and v must be on q's device; a device without a kernel raises; a
    block table has no size limit."""
    q = torch.zeros(2, 4, 64)
    k = torch.zeros(2, 10, 2, 64)
    lengths = torch.tensor([10, 3])
    with pytest.raises(ValueError, match="does not fit"):
        K.flash_decode(q, torch.zeros(3, 10, 2, 64), k, lengths)
    with pytest.raises(ValueError, match="!= v"):
        K.flash_decode(q, k, torch.zeros(2, 10, 2, 32), lengths)
    with pytest.raises(ValueError, match="heads over"):
        K.flash_decode(q, torch.zeros(2, 10, 3, 64),
                       torch.zeros(2, 10, 3, 64), lengths)
    with pytest.raises(ValueError, match="indices"):
        K.flash_decode(q, k, k, torch.tensor([10, 3, 1]))
    with pytest.raises(ValueError, match="is on meta"):
        K.flash_decode(q, k, torch.zeros(2, 10, 2, 64, device="meta"),
                       lengths)
    with pytest.raises(ValueError, match="no kernel"):
        K.flash_decode(q.to("meta"), k, k, lengths)
    with pytest.raises(ValueError, match="block_tables"):
        K.paged_flash_decode(q, k, k, torch.zeros(3, 4, dtype=torch.int32),
                             lengths)
    with pytest.raises(ValueError, match="does not fit"):
        K.flash_attention(torch.zeros(1, 8, 2, 64), torch.zeros(1, 9, 2, 64),
                          torch.zeros(1, 9, 2, 64))
    pools = torch.randn(8001, 1, 2, 64)             # 8000 pages a row
    tables = torch.arange(1, 8001, dtype=torch.int32).reshape(1, 8000)
    got = K.paged_flash_decode(q[:1], pools, pools, tables,
                               torch.tensor([7999]), torch.tensor([7990]))
    assert torch.isfinite(got).all()


def test_prefill_takes_another_key_length_when_not_causal():
    """Non-causal, k and v may hold Sk != S rows (cross attention): on the
    CPU the plain version equals the reference's ``chunked_attention(...,
    causal=False)`` (fp32, within 1e-6).  Causal attention over another
    key length raises, and so do ``starts`` and ``prefix`` with Sk != S
    (they index the queries' own keys); an empty key axis raises."""
    from repro.models.layers import chunked_attention
    rng = np.random.default_rng(31)
    q, k, v = _f32(rng, 2, 37, 4, 64), _f32(rng, 2, 300, 2, 64), \
        _f32(rng, 2, 300, 2, 64)
    got = K.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=False)
    assert got.shape == (2, 37, 4, 64)
    want = chunked_attention(jnp.asarray(q),
                             jnp.asarray(np.repeat(k, 2, axis=2)),
                             jnp.asarray(np.repeat(v, 2, axis=2)), 512, 512,
                             causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    with pytest.raises(ValueError, match="causal attention needs"):
        K.flash_attention(tq, tk, tk)
    with pytest.raises(ValueError, match="takes neither"):
        K.flash_attention(tq, tk, tk, starts=torch.zeros(2), causal=False)
    with pytest.raises(ValueError, match="takes neither"):
        K.flash_attention(tq, tk, tk, causal=False, prefix=4)
    with pytest.raises(ValueError, match="does not fit"):
        K.flash_attention(tq, tk[:, :0], tk[:, :0], causal=False)


def test_prefill_wrapper_hands_the_entry_point_the_key_length(monkeypatch):
    """With the kernel path forced on CPU tensors and the C entry point
    replaced by a check of its ctypes signature: every argument is passed,
    S and Sk in their places (Sk = S for the causal and the encoder's
    calls, the memory's length for cross attention), the causal flag and
    one launch a call (``launches_tc`` for bf16 only)."""
    calls = []
    sig = K._SIGNATURES["flash_attention_fwd"]

    def entry(*args):
        assert len(args) == len(sig)
        for a, t in zip(args, sig):
            if t is ctypes.c_int:
                assert isinstance(a, int)
            elif t is ctypes.c_float:
                assert isinstance(a, float)
            else:
                assert a is None or isinstance(a, int)
        calls.append(args)
        return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(K, "_fn", lambda name: entry)
    monkeypatch.setattr(K, "_plain", lambda name, q: False)
    monkeypatch.setattr(K.torch.cuda, "current_stream", lambda: Stream())
    K.reset_launches()
    q = torch.zeros(4, 64, 16, 64, dtype=torch.bfloat16)
    mem = torch.zeros(4, 512, 16, 64, dtype=torch.bfloat16)
    K.flash_attention(q, q, q)
    K.flash_attention(mem, mem, mem, causal=False)
    K.flash_attention(q, mem, mem, causal=False)
    K.flash_attention(q.float(), mem.float(), mem.float(), causal=False)
    # B, S, Sk, H, KV, hd, dtype, causal, prefix follow the 5 pointers
    assert [c[5:14] for c in calls] == [
        (4, 64, 64, 16, 16, 64, 1, 1, 0),
        (4, 512, 512, 16, 16, 64, 1, 0, 0),
        (4, 64, 512, 16, 16, 64, 1, 0, 0),
        (4, 64, 512, 16, 16, 64, 0, 0, 0)]
    assert (K.flash_attention.launches, K.flash_attention.launches_tc) == \
        (4, 3)
    K.reset_launches()


def test_decode_wrappers_hand_the_entry_points_their_arguments(monkeypatch):
    """With the kernel path forced on CPU tensors and the C entry points
    replaced by a check of their ctypes signatures, each decode passes
    every argument its signature names, sizes the combine's scratch
    B*H*n_split*(hd+2) fp32, and counts one launch a call and one
    ``launches_split`` a call that needs the combine."""
    calls = []

    def fake(name):
        sig = K._SIGNATURES[name]

        def entry(*args):
            assert len(args) == len(sig)
            for a, t in zip(args, sig):
                if t is ctypes.c_int:
                    assert isinstance(a, int)
                elif t is ctypes.c_float:
                    assert isinstance(a, float)
                else:
                    assert a is None or isinstance(a, int)
            calls.append((name, args))
            return 0
        return entry

    scratch = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        scratch.append((t.numel(), t.dtype))
        return t

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(K, "_fn", fake)
    monkeypatch.setattr(K, "_plain", lambda name, q: False)
    monkeypatch.setattr(K, "_sm_count", lambda index: 132)
    monkeypatch.setattr(K.torch.cuda, "current_stream", lambda: Stream())
    monkeypatch.setattr(K.torch, "empty", empty)
    K.reset_launches()
    b, h, kvh, hd = 4, 32, 32, 128
    q = torch.randn(b, h, hd)
    cache = torch.randn(b, 544, kvh, hd)
    lengths, starts = torch.tensor([544, 520, 300, 33]), \
        torch.tensor([0, 37, 100, 5])
    K.flash_decode(q, cache, cache, lengths, starts)
    n_split, chunk = K.split_plan(544, b * kvh, 132)
    assert n_split > 1
    assert scratch == [(b * h * n_split * (hd + 2), torch.float32)]
    name, args = calls[-1]
    assert name == "flash_decode_fwd" and args[-5:-2] == (0, n_split, chunk)
    pools = torch.randn(1 + 4 * 34, 16, kvh, hd)
    tables = torch.arange(1, 137, dtype=torch.int32).reshape(4, 34)
    K.paged_flash_decode(q, pools, pools, tables, lengths, starts)
    assert calls[-1][0] == "paged_flash_decode_fwd"
    short = torch.randn(b, 64, kvh, hd)             # fits one split
    K.flash_decode(q, short, short, torch.tensor([64, 9, 1, 30]))
    assert calls[-1][1][-4] == 1 and len(scratch) == 2
    assert (K.flash_decode.launches, K.flash_decode.launches_split) == (2, 1)
    assert (K.paged_flash_decode.launches,
            K.paged_flash_decode.launches_split) == (1, 1)
    K.reset_launches()
    assert K.flash_decode.launches_split == \
        K.paged_flash_decode.launches_split == 0
