"""The arithmetic of the port's SSM scan kernel, modelled on the CPU and
held against the JAX package.

The kernel (``csrc/ssm_scan.cu``: ``ssm_scan_tc_kernel``) runs only on a
card; these tests model, in torch on the CPU, the arithmetic it does, and
check that it stays inside the tolerances ``chip_smoke.py`` holds the
kernel to on the card (``TOL``, read from the script itself):

- the P-split: each slice of 32 columns of x walks the sequence on its
  own, with its own rows of the state (the kernel's slices of 16, bf16 at
  a small batch, do the same arithmetic a column);
- 64-row chunks, rows past S zero (a_log 0), the chunk's cumulative decay
  summed in fp64 and held in log2 units as fp32 pairs hi + lo, each
  ``exp(cum_i - cum_j)`` an ``ex2.approx.ftz`` of ``(hi_i - hi_j) + (lo_i
  - lo_j)`` in fp32 (modelled as ``exp2`` flushed to 0 below 2^-126 and
  pushed by its error bound, 2^-22, toward 0);
- the scores ``C B^T`` decayed and masked by a select (0 above the
  diagonal), ``y = S x + exp(cum) (C h^T)``, and the state update ``h =
  exp(total) h + (x exp(total - cum))^T B``;
- every ``mma.sync`` as the tensor cores add: the products of one k step
  (8 for TF32, 16 for bf16) exact, their sum with the accumulator
  truncated toward zero to fp32, the steps in the kernel's order (the
  alignment of each addend to the largest, which may drop more of a
  small product's bits, is not modelled);
- fp32: every product as three TF32 products (``tf32(a) tf32(b)``,
  ``tf32(a) tf32(b - tf32(b))``, ``tf32(a - tf32(a)) tf32(b)``, round to
  nearest with ties away), the small ones first; each k step's three
  summed from zero and then added to the accumulator in fp32, as
  ``mma_3x`` does.  Chained into the accumulator instead, the truncations
  pile up and y misses ``TOL`` at a slow decay where the committed form
  meets it; one TF32 pass alone misses ``TOL`` too;
- bf16: bf16 products with fp32 sums (b, c and x enter as they are), and
  each fp32 operand as a bf16 pair (hi = bf16(v), lo = bf16(v - hi), two
  products): the decayed scores before ``S x``, the state before ``C
  h^T``, ``x exp(total - cum)`` before the state update; y rounded to bf16
  at the store.  With any one pair a single bf16 value, y misses ``TOL``.

Held against ``repro.kernels.ref.ssm_scan_ref`` (the sequential scan),
``repro.models.mamba2.gated_chunked_scan`` (the chunked scan the Mamba2
layer runs) and an fp64 scan, at slow and published decays, ragged S and
a few heads.  Inputs are made with numpy from seeds and cross as numpy
arrays.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TOL = chip_smoke.TOL

LC = 64                          # the kernel's chunk rows
PS = 32                          # the columns of P a block owns
LOG2E = 1.4426950408889634
P = N = 64                       # its only (P, N)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: fp32 rounded to 10 explicit mantissa bits,
    to nearest with ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest, ties to even), kept as fp32."""
    return x.to(torch.bfloat16).float()


def ex2_approx(x: torch.Tensor) -> torch.Tensor:
    """``ex2.approx.ftz.f32``: 2^x, results below 2^-126 flushed to 0, off
    by its relative error bound (2^-22) toward 0."""
    r = torch.exp2(x)
    return torch.where(r < 2.0 ** -126, torch.zeros(()), r) * (1 - 2.0 ** -22)


def rz32(v: torch.Tensor) -> torch.Tensor:
    """fp64 to fp32, truncated toward zero."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def k_steps(eq: str, a: torch.Tensor, b: torch.Tensor, kw: int):
    """``einsum(eq, a, b)`` in fp64 with its contraction cut into k steps
    of ``kw``: each step's sum of exact products, the steps in a new last
    axis."""
    ins, out = eq.split("->")
    ea, eb = ins.split(",")
    (k,) = (set(ea) & set(eb)) - set(out)
    a = a.double().unflatten(ea.index(k), (-1, kw))
    b = b.double().unflatten(eb.index(k), (-1, kw))
    return torch.einsum(f"{ea.replace(k, 'z' + k)},{eb.replace(k, 'z' + k)}"
                        f"->{out}z", a, b)


def mma(eq: str, passes: list, kw: int, acc=None, chain: bool = True):
    """``acc + einsum(eq, a, b)`` summed over ``passes`` (operand pairs (a,
    b)) as ``mma.sync`` sums them: k step by k step, each pass's products
    of the step exact and added with a truncation to fp32, either straight
    into ``acc`` (``chain``) or from zero and then into ``acc`` in fp32
    (``mma_3x``)."""
    steps = [k_steps(eq, a, b, kw) for a, b in passes]
    if acc is None:
        acc = torch.zeros(steps[0].shape[:-1])
    for z in range(steps[0].shape[-1]):
        part = acc if chain else torch.zeros_like(acc)
        for st in steps:
            part = rz32(part.double() + st[..., z])
        acc = part if chain else acc + part
    return acc


def tf32_passes(a: torch.Tensor, b: torch.Tensor, passes: int) -> list:
    """The fp32 route's TF32 products of a b in the kernel's order (the
    small ones first), or the one ``tf32(a) tf32(b)``."""
    ab, bb = tf32(a), tf32(b)
    if passes == 1:
        return [(ab, bb)]
    return [(tf32(a - ab), bb), (ab, tf32(b - bb)), (ab, bb)]


PAIRS = ("scores", "state", "weighted x")     # the bf16 route's pairs


def pair(v: torch.Tensor, split: bool) -> list:
    """A bf16 operand: ``[hi, lo]`` with hi = bf16(v), lo = bf16(v - hi),
    each the operand of its own product, or ``[hi]`` alone."""
    hi = bf16(v)
    return [hi, bf16(v - hi)] if split else [hi]


def scan_model(x, a_log, b, c, dtype: str, passes: int = 3,
               chain: bool = False, pairs=PAIRS):
    """The kernel's arithmetic.  x (Bt,S,H,P), b/c (Bt,S,N) fp32 tensors
    holding values of ``dtype``; a_log (Bt,S,H) fp32.  Returns (y (Bt,S,H,P)
    rounded to ``dtype``, as fp32; h_final (Bt,H,P,N) fp32).  The fp32
    route takes ``passes`` TF32 products a product, each k step's summed
    from zero and then added (``chain`` False, the kernel's) or chained
    into the accumulator; the bf16 route's fp32 operands enter as bf16
    pairs where ``pairs`` names them, else as one bf16 value."""
    bt, s, hh, _ = x.shape
    nc = -(-s // LC)
    pad = nc * LC - s
    zeros = lambda t: torch.zeros((bt, pad) + tuple(t.shape[2:]))  # noqa: E731
    x, b, c = (torch.cat([t, zeros(t)], 1) for t in (x, b, c))
    a = torch.cat([a_log, zeros(a_log)], 1).double()
    f32 = dtype == "float32"

    def product(eq, u, v, acc=None, pair_u=None, pair_v=None):
        if f32:
            return mma(eq, tf32_passes(u, v, passes), 8, acc,
                       chain=chain or passes == 1)
        us = [u] if pair_u is None else pair(u, pair_u)
        vs = [v] if pair_v is None else pair(v, pair_v)
        return mma(eq, [(p, q) for p in us for q in vs], 16, acc)

    y = torch.zeros((bt, nc * LC, hh, P))
    h_final = torch.zeros((bt, hh, P, N))
    ii = torch.arange(LC)
    below = ii[:, None] >= ii[None, :]                       # i >= j
    for p0 in range(0, P, PS):                               # one block each
        h = torch.zeros((bt, hh, PS, N))
        for ci in range(nc):
            rows = slice(ci * LC, (ci + 1) * LC)
            xc, bc, cc = x[:, rows, :, p0:p0 + PS], b[:, rows], c[:, rows]
            # the decay summed in fp64, in log2 units as fp32 pairs hi + lo
            cum = torch.cumsum(a[:, rows], 1) * LOG2E        # fp64 (Bt,L,H)
            total = cum[:, -1:]
            hi = cum.float()
            lo = (cum - hi.double()).float()
            # scores, decayed and masked by a select
            sc = product("bin,bjn->bij", cc, bc)
            diff = (hi[:, :, None, :] - hi[:, None, :, :]) + \
                (lo[:, :, None, :] - lo[:, None, :, :])
            dec = ex2_approx(diff).permute(0, 3, 1, 2)       # (Bt,H,i,j)
            S = torch.where(below, sc[:, None] * dec, torch.zeros(()))
            # the entering state's term, decayed from the chunk's start,
            # then S x into the same accumulator
            if ci:
                yc = product("bin,bhpn->bihp", cc, h, pair_v="state" in pairs)
                yc = yc * torch.exp2(hi + lo)[..., None]
            else:
                yc = torch.zeros_like(xc)
            yc = product("bhij,bjhp->bihp", S, xc, yc,
                         pair_u="scores" in pairs)
            y[:, rows, :, p0:p0 + PS] = yc if f32 else bf16(yc)
            # the state: exp(total) h + (x exp(total - cum))^T B
            xw = xc * torch.exp2((total - cum).float())[..., None]
            h = h * torch.exp2(total.float())[:, 0, :, None, None]
            h = product("bjhp,bjn->bhpn", xw, bc, h,
                        pair_u="weighted x" in pairs)
        h_final[:, :, p0:p0 + PS] = h
    return y[:, :s], h_final


def exact_scan(x, a_log, b, c):
    """fp64 chunked scan (the plain version on fp64 inputs)."""
    t = [torch.from_numpy(np.asarray(v, np.float64)) for v in (x, a_log, b, c)]
    y, h = tref.gated_chunked_scan_ref(*t)
    return y.numpy(), h.numpy()


def inputs(bt, s, hh, decay, seed, dtype="float32"):
    """x ~ N(0, 1), b and c ~ N(0, 1/4), rounded to ``dtype``; a_log at a
    slow decay ([-0.05, 0]: the state stays large across chunks), a very
    slow one ([-0.005, 0], the slow end of the published init's dt A, as
    small as -1e-3) or the published init's (-softplus(N(0, 1)) times -A
    = linspace(1, 16, H))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, s, hh, P))
    bm = 0.5 * rng.standard_normal((bt, s, N))
    cm = 0.5 * rng.standard_normal((bt, s, N))
    if decay in ("slow", "very slow"):
        rate = 0.05 if decay == "slow" else 0.005
        a_log = -rate * rng.random((bt, s, hh))
    else:
        a_log = -np.logaddexp(rng.standard_normal((bt, s, hh)), 0.0) \
            * np.linspace(1.0, 16.0, hh)
    x, bm, cm = (torch.from_numpy(v.astype(np.float32)) for v in (x, bm, cm))
    if dtype == "bfloat16":
        x, bm, cm = bf16(x), bf16(bm), bf16(cm)
    return x, torch.from_numpy(a_log.astype(np.float32)), bm, cm


def _within(got, want, tol):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float(err.max()), bool((err <= tol + tol * np.abs(want)).all())


def _jax_sequential(x, a_log, b, c):
    y, h = jax_ref.ssm_scan_ref(jnp.asarray(x.numpy()),
                                jnp.exp(jnp.asarray(a_log.numpy())),
                                jnp.asarray(b.numpy()), jnp.asarray(c.numpy()))
    return np.asarray(y), np.asarray(h)


# (batch rows, S, heads, decay): ragged S (300 = 4 chunks + 44 rows, 37 =
# one short chunk), two rows, three heads
CASES = {
    "slow-300": (2, 300, 3, "slow"),
    "slow-37": (1, 37, 3, "slow"),
    "published-300": (2, 300, 3, "published"),
}


@pytest.mark.parametrize("seed", [17, 18])
@pytest.mark.parametrize("case", list(CASES))
def test_fp32_model_within_tol_of_jax_and_fp64(case, seed):
    """y and h_final of the three-pass TF32 model within ``TOL["float32"]``
    of fp64, of JAX's sequential scan and (slow decay) of JAX's chunked
    scan.  At the published decay the reference's fp32 chunked scan is
    itself ~6e-4 off (its fp32 decay prefix sums), so it is no oracle
    there."""
    bt, s, hh, decay = CASES[case]
    x, a_log, b, c = inputs(bt, s, hh, decay, seed=seed)
    y, h = scan_model(x, a_log, b, c, "float32")
    assert np.isfinite(y.numpy()).all() and np.isfinite(h.numpy()).all()
    tol = TOL["float32"]
    oracles = {"fp64": exact_scan(x, a_log, b, c),
               "ssm_scan_ref": _jax_sequential(x, a_log, b, c)}
    if decay == "slow":
        jy, jh = JM.gated_chunked_scan(*(jnp.asarray(v.numpy())
                                         for v in (x, a_log, b, c)))
        oracles["gated_chunked_scan"] = (np.asarray(jy), np.asarray(jh))
    for name, (wy, wh) in oracles.items():
        for what, got, want in (("y", y, wy), ("h_final", h, wh)):
            err, ok = _within(got.numpy(), want, tol)
            assert ok, f"{what}: max |err| {err} from {name} over {tol}"
    if decay == "slow":          # the carry is visible: the state stays large
        assert np.abs(oracles["fp64"][1]).max() > 1.0


def test_one_tf32_pass_misses_the_fp32_tolerance():
    """TF32 alone (one pass) is ~1e-3 off; the three passes are what hold
    the kernel to fp32."""
    x, a_log, b, c = inputs(2, 300, 3, "slow", seed=17)
    wy, wh = exact_scan(x, a_log, b, c)
    one_y, one_h = scan_model(x, a_log, b, c, "float32", passes=1)
    three_y, _ = scan_model(x, a_log, b, c, "float32")
    assert not _within(one_y.numpy(), wy, TOL["float32"])[1]
    assert not _within(one_h.numpy(), wh, TOL["float32"])[1]
    assert np.abs(three_y.numpy() - wy).max() < \
        np.abs(one_y.numpy() - wy).max() / 50


def test_chained_tf32_passes_miss_the_fp32_tolerance():
    """Each k step's three TF32 products summed from zero and then added
    to the accumulator (the kernel's ``mma_3x``) against the three chained
    into it, each add truncating toward zero: at a very slow decay (|y| up
    to ~110, rows where y is small beside the sums that make it) the
    chained form misses ``TOL["float32"]`` of fp64 and is several times
    further from it, where the kernel's form meets it."""
    x, a_log, b, c = inputs(2, 300, 3, "very slow", seed=17)
    wy, wh = exact_scan(x, a_log, b, c)
    y, h = scan_model(x, a_log, b, c, "float32")
    chain_y, _ = scan_model(x, a_log, b, c, "float32", chain=True)
    tol = TOL["float32"]
    assert _within(y.numpy(), wy, tol)[1] and _within(h.numpy(), wh, tol)[1]
    assert not _within(chain_y.numpy(), wy, tol)[1]
    assert np.abs(chain_y.numpy() - wy).max() > \
        3 * np.abs(y.numpy() - wy).max()


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_model_within_tol_of_jax_and_fp64(case):
    """The bf16 route: y and h_final within ``TOL["bfloat16"]`` of fp64 and
    of JAX's sequential and chunked scans (fp32) on the same bf16 inputs;
    y closer to fp64 than JAX's own bf16 chunked scan, which rounds every
    product to bf16."""
    bt, s, hh, decay = CASES[case]
    x, a_log, b, c = inputs(bt, s, hh, decay, seed=29, dtype="bfloat16")
    y, h = scan_model(x, a_log, b, c, "bfloat16")
    assert torch.equal(bf16(y), y)                  # y is bf16
    tol = TOL["bfloat16"]
    jy, jh = JM.gated_chunked_scan(*(jnp.asarray(v.numpy())
                                     for v in (x, a_log, b, c)))
    oracles = {"fp64": exact_scan(x, a_log, b, c),
               "ssm_scan_ref": _jax_sequential(x, a_log, b, c),
               "gated_chunked_scan": (np.asarray(jy), np.asarray(jh))}
    for name, (wy, wh) in oracles.items():
        for what, got, want in (("y", y, wy), ("h_final", h, wh)):
            err, ok = _within(got.numpy(), want, tol)
            assert ok, f"{what}: max |err| {err} from {name} over {tol}"
    flow_y, _ = JM.gated_chunked_scan(
        jnp.asarray(x.numpy(), jnp.bfloat16), jnp.asarray(a_log.numpy()),
        jnp.asarray(b.numpy(), jnp.bfloat16),
        jnp.asarray(c.numpy(), jnp.bfloat16))
    exact_y = oracles["fp64"][0]
    assert np.abs(y.numpy() - exact_y).max() < \
        np.abs(np.asarray(flow_y.astype(jnp.float32)) - exact_y).max()


@pytest.mark.parametrize("single", PAIRS)
def test_each_bf16_pair_is_needed(single):
    """Each fp32 operand of the bf16 route entering as one bf16 value
    instead of a pair (the scores before ``S x``, the state before ``C
    h^T``, ``x exp(total - cum)`` before the state update) puts y outside
    ``TOL["bfloat16"]`` of fp64 at slow decay, where the state stays large:
    all three pairs are what hold the bf16 route to the tolerance."""
    x, a_log, b, c = inputs(2, 300, 3, "slow", seed=29, dtype="bfloat16")
    wy, _ = exact_scan(x, a_log, b, c)
    y, _ = scan_model(x, a_log, b, c, "bfloat16",
                      pairs=tuple(n for n in PAIRS if n != single))
    assert not _within(y.numpy(), wy, TOL["bfloat16"])[1]
