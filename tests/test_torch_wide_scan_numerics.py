"""The arithmetic of the port's wide-state scan kernel, modelled on the
CPU and held against the JAX package at its full width.

The kernel (``csrc/ssm_scan_wide.cu``: ``ssm_wide_scores_kernel`` and
``ssm_wide_walk_kernel``, the mLSTM's (P, N) = (1025, 1024)) runs only on
a card; these tests model, in torch on the CPU, the arithmetic it does and
check that it stays inside the tolerance ``chip_smoke.py`` holds it to on
the card (``TOL``, read from the script itself):

- the scores kernel, per 64-row chunk: the cumulative log decay summed in
  fp64, ``G = (C B^T) exp(cum_i - cum_j)`` (0 above the diagonal) in fp64
  and stored as fp32, the decays ``exp(cum_i)``, ``exp(total - cum_j)``
  and ``exp(total)`` in fp64; rows past S zero with a_log 0;
- the walk, one block a slice of 32 state rows: ``C h^T`` as TF32
  ``mma.sync`` products, each k step's passes summed from zero with the
  tensor cores' truncating adds, then added in fp32 over 32 columns and
  the 32-column sums in fp64; ``y = exp(cum_i) (C h^T) + G x`` in fp64
  (x held in fp64),
  rounded to the dtype once; the state update ``h = exp(total) h + (x
  exp(total - cum))^T B`` as TF32 products too (``x exp(total - cum)``
  in fp64, split from there), each k step's passes summed from zero, the
  8 k-step partials of a chunk summed in fp32, and ``h`` updated by one
  fp32 ``fma`` with ``exp(total)`` rounded to fp32;
- fp32 takes three TF32 passes a product (big x big, big x small, small
  x big, each part rounded to nearest with ties away, the small ones
  first); bf16 inputs are exact in TF32, so C and B enter as they are and
  only the fp32 operands are split: two passes (``C h^T``: C x small(h),
  C x big(h); the update: small(xw) x B, big(xw) x B);
- the normalizer row (row 1024, the ones-channel) walks in a block of its
  own on the CUDA cores: ``C h^T``, ``G x`` and the update in fp64, the
  state fp32.

The rows of the state are independent, so a few slices stand for the
whole: the first and the last 32-row slice and the normalizer row, at
(P, N) = (1025, 1024), S = 150 (two chunks and a ragged third), at the
mLSTM's decay, the fast decay and a slow one (the state carried across
chunks).  Held against ``repro.kernels.ref.ssm_scan_ref`` (the sequential
scan, fp32) and an fp64 scan.  Inputs are made with numpy from seeds and
cross as numpy arrays.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from test_torch_ssm_redesign_numerics import k_steps, rz32, tf32  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
TOL = chip_smoke.TOL

P, N = 1025, 1024                 # the kernel's only (P, N)
LC = 64                           # chunk rows
PS = 32                           # state rows a walk block owns
SLICES = (0, 31)                  # modelled 32-row slices; row 1024 beside
ROWS = [r for s in SLICES for r in range(PS * s, PS * s + PS)] + [P - 1]
S_LEN = 150                       # 64 + 64 + 22


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def passes(a: torch.Tensor, b: torch.Tensor, n: int) -> list:
    """The ``n`` TF32 products of a b in the kernel's order, small parts
    first: 3, both operands split into (big, small); 2, ``a`` exact in
    TF32 (a bf16 input) and ``b`` split; 1, each rounded to TF32 alone."""
    ab, bb = tf32(a), tf32(b)
    if n == 3:
        return [(tf32(a - ab), bb), (ab, tf32(b - bb)), (ab, bb)]
    if n == 2:
        return [(a, tf32(b - bb)), (a, bb)]
    return [(ab, bb)]


def mma_from_zero(eq: str, prods: list):
    """Each k step (8 columns) of ``einsum(eq)``: its passes' exact
    products added from zero with a truncation to fp32 each, as one
    ``mma.sync`` chain; the steps in a new last axis (fp32 values)."""
    steps = [k_steps(eq, a, b, 8) for a, b in prods]
    part = torch.zeros(steps[0].shape, dtype=torch.float32)
    for st in steps:
        part = rz32(part.double() + st)
    return part


def split_d(v: torch.Tensor):
    """An fp64 operand as TF32 (big, small): big = tf32(fp32(v)), small =
    tf32(fp32(v - big))."""
    big = tf32(v.float())
    return big, tf32((v - big.double()).float())


def scores(a_log, b, c):
    """The scores kernel for one (row, head): per chunk G (fp32, 0 above
    the diagonal) and the decays exp(cum), exp(total - cum), exp(total)
    (fp64).  a_log (S,), b/c (S, N) fp32, zero-padded to whole chunks."""
    cum = torch.cumsum(a_log.double().view(-1, LC), 1)
    total = cum[:, -1:]
    bc = torch.einsum("kin,kjn->kij", c.double().view(-1, LC, N),
                      b.double().view(-1, LC, N))
    below = torch.tril(torch.ones(LC, LC, dtype=torch.bool))
    g = torch.where(below, bc * torch.exp(cum[:, :, None] - cum[:, None, :]),
                    torch.zeros((), dtype=torch.float64)).float()
    return g, torch.exp(cum), torch.exp(total - cum), torch.exp(total)[:, 0]


def walk_slice(x, b, c, g, e_i, w_j, dc, dtype, n=None, update="kernel"):
    """One walk block: x (S', PS) the slice's columns, b/c (S', N), all
    zero-padded to whole chunks.  Returns (y (S', PS) in the dtype's
    values, h (PS, N) fp32).  ``n``: TF32 passes a product (the kernel's:
    3 in fp32, 2 in bf16).  ``update``: "kernel", the state update's k-step
    partials summed in fp32 and one fp32 fma with exp(total) in fp32;
    "fp64 sums", the partials summed and the fma taken in fp64; "fp64", the
    update's products in fp64 too (the earlier kernel's fp64 mma)."""
    f32 = dtype == "float32"
    n = n or (3 if f32 else 2)
    ps = x.shape[1]
    h = torch.zeros((ps, N))
    ys = []
    for k in range(x.shape[0] // LC):
        rows = slice(k * LC, (k + 1) * LC)
        xc, bc, cc = x[rows], b[rows], c[rows]
        # C h^T: k steps of 8, fp32 over 32 columns, fp64 over those
        part = mma_from_zero("in,pn->ip", passes(cc, h, n))
        acc32 = part.view(LC, ps, N // 32, 4)
        run = acc32[..., 0]
        for z in range(1, 4):
            run = run + acc32[..., z]
        ya = run.double().sum(-1)
        yc = e_i[k][:, None] * ya + g[k].double() @ xc.double()
        ys.append(yc.float() if f32 else bf16(yc.float()))
        # the update: xw in fp64, split; k-step partials summed in fp64
        xw = xc.double() * w_j[k][:, None]
        if update == "fp64":
            u = xw.T @ bc.double()
        else:
            big, small = split_d(xw)
            bb = tf32(bc)
            prods = {3: [(small, bb), (big, tf32(bc - bb)), (big, bb)],
                     2: [(small, bc), (big, bc)], 1: [(big, bb)]}[n]
            part = mma_from_zero("jp,jn->pn", prods)
            if update == "kernel":
                u = part[..., 0]
                for z in range(1, part.shape[-1]):
                    u = u + part[..., z]
                u = u.double()
            else:
                u = part.double().sum(-1)
        dk = dc[k].float().double() if update == "kernel" else dc[k]
        h = (dk * h.double() + u).float()
    return torch.cat(ys), h


def normalizer(x, b, c, g, e_i, w_j, dc, dtype):
    """The normalizer row's block: x (S',) its column; fp64 but for the
    state's rounding once a chunk."""
    h = torch.zeros(N)
    ys = []
    for k in range(x.shape[0] // LC):
        rows = slice(k * LC, (k + 1) * LC)
        xc, bc, cc = x[rows].double(), b[rows].double(), c[rows].double()
        yc = e_i[k] * (cc @ h.double()) + g[k].double() @ xc
        ys.append(yc.float() if dtype == "float32" else bf16(yc.float()))
        h = (dc[k] * h.double() + (xc * w_j[k]) @ bc).float()
    return torch.cat(ys), h


def wide_model(x, a_log, b, c, dtype, n=None, update="kernel"):
    """The kernel's arithmetic on one (row, head), for ``ROWS``: x (S, P),
    a_log (S,), b/c (S, N) fp32 tensors holding values of ``dtype``.
    Returns (y (S, len(ROWS)), h_final (len(ROWS), N))."""
    s = x.shape[0]
    pad = -s % LC
    x, b, c = (torch.cat([t, torch.zeros((pad,) + t.shape[1:])])
               for t in (x, b, c))
    a = torch.cat([a_log, torch.zeros(pad)])
    g, e_i, w_j, dc = scores(a, b, c)
    ys, hs = [], []
    for sl in SLICES:
        cols = slice(PS * sl, PS * sl + PS)
        y, h = walk_slice(x[:, cols], b, c, g, e_i, w_j, dc, dtype, n,
                          update)
        ys.append(y)
        hs.append(h)
    y, h = normalizer(x[:, P - 1], b, c, g, e_i, w_j, dc, dtype)
    return (torch.cat(ys + [y[:, None]], 1)[:s],
            torch.cat(hs + [h[None]], 0))


def inputs(decay, seed, dtype):
    """x ~ N(0, 1) with the ones-channel scaled by the input gate (the
    mLSTM's x), b and c ~ N(0, 1/4), rounded to ``dtype``; a_log at the
    mLSTM's decay (log_sigmoid(N(0, 1) + 3), ~0.95 a step), the fast one
    (-softplus(N(0, 1)), ~0.5) or a slow one ([-0.01, 0]: the state
    carried across chunks)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S_LEN, P))
    x[:, -1] = 1 / (1 + np.exp(-rng.standard_normal(S_LEN)))
    bm = 0.5 * rng.standard_normal((S_LEN, N))
    cm = 0.5 * rng.standard_normal((S_LEN, N))
    z = rng.standard_normal(S_LEN)
    a_log = {"mlstm": -np.logaddexp(0.0, -(z + 3.0)),
             "fast": -np.logaddexp(z, 0.0),
             "slow": -0.01 * rng.random(S_LEN)}[decay]
    x, bm, cm = (torch.from_numpy(v.astype(np.float32)) for v in (x, bm, cm))
    if dtype == "bfloat16":
        x, bm, cm = bf16(x), bf16(bm), bf16(cm)
    return x, torch.from_numpy(a_log.astype(np.float32)), bm, cm


def oracles(x, a_log, b, c):
    """(y, h_final) at ``ROWS`` of an fp64 sequential scan and of JAX's
    ``ssm_scan_ref`` (fp32)."""
    xd, ad, bd, cd = (t.double() for t in (x[:, ROWS], a_log, b, c))
    h = torch.zeros((len(ROWS), N), dtype=torch.float64)
    ys = []
    for t in range(x.shape[0]):
        h = torch.exp(ad[t]) * h + xd[t][:, None] * bd[t][None]
        ys.append(h @ cd[t])
    exact = (torch.stack(ys).numpy(), h.numpy())
    jy, jh = jax_ref.ssm_scan_ref(
        jnp.asarray(x[None, :, None, ROWS].numpy()),
        jnp.exp(jnp.asarray(a_log[None, :, None].numpy())),
        jnp.asarray(b[None].numpy()), jnp.asarray(c[None].numpy()))
    return {"fp64": exact,
            "ssm_scan_ref": (np.asarray(jy)[0, :, 0], np.asarray(jh)[0, 0])}


def _share(got, want, tol):
    """The largest share of its tolerance (atol = rtol = tol) an entry
    takes."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float((err / (tol + tol * np.abs(want))).max())


@pytest.mark.parametrize("decay", ["mlstm", "fast", "slow"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_within_tol_of_jax_and_fp64(dtype, decay, one_thread):  # noqa: F811
    """y and h_final of the modelled kernel within ``TOL[dtype]`` of an
    fp64 scan and of JAX's sequential scan at the slices' rows and the
    normalizer row; y in the dtype's values.  At the slow decay (|y| to
    ~310) JAX's fp32 scan is itself ~1.4 ``TOL`` from fp64, so it is no
    oracle there: in fp32 the model must be closer to fp64 than it is."""
    x, a_log, b, c = inputs(decay, seed=26, dtype=dtype)
    y, h = wide_model(x, a_log, b, c, dtype)
    assert y.shape == (S_LEN, len(ROWS)) and h.shape == (len(ROWS), N)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    if dtype == "bfloat16":
        assert torch.equal(bf16(y), y)
    tol = TOL[dtype]
    refs = oracles(x, a_log, b, c)
    for name, (wy, wh) in refs.items():
        if name == "ssm_scan_ref" and decay == "slow":
            continue
        for what, got, want in (("y", y, wy), ("h_final", h, wh)):
            share = _share(got.numpy(), want, tol)
            assert share <= 1, f"{what}: {share} of {tol} from {name}"
    if decay == "slow":          # the carry is visible: the state stays large
        assert np.abs(h.numpy()).max() > 5.0
    if decay == "slow" and dtype == "float32":
        exact = refs["fp64"][0]
        assert _share(y.numpy(), exact, tol) < \
            _share(refs["ssm_scan_ref"][0], exact, tol)


@pytest.mark.parametrize("decay", ["mlstm", "slow"])
def test_tf32_state_update_holds_tol(decay, one_thread):  # noqa: F811
    """The state update off fp64: its TF32 products, each k step's three
    summed from zero, the 8 k-step partials summed in fp32 and one fp32
    fma, hold y and h_final within ``TOL["float32"]`` of fp64, at the slow
    decay too, where every chunk's rounding of the state reaches the next.
    The fp64 products of the earlier kernel are closer, by less than half
    of ``TOL``; summing the partials and taking the fma in fp64 instead
    moves y by less than a tenth of it: the fp32 sums cost nothing the
    tolerance sees."""
    x, a_log, b, c = inputs(decay, seed=27, dtype="float32")
    wy, wh = oracles(x, a_log, b, c)["fp64"]
    tol = TOL["float32"]
    y, h = wide_model(x, a_log, b, c, "float32")
    ys, _ = wide_model(x, a_log, b, c, "float32", update="fp64 sums")
    y64, h64 = wide_model(x, a_log, b, c, "float32", update="fp64")
    assert _share(y.numpy(), wy, tol) <= 1 and _share(h.numpy(), wh, tol) <= 1
    assert _share(y.numpy(), wy, tol) - _share(y64.numpy(), wy, tol) < 0.5
    assert _share(h.numpy(), wh, tol) - _share(h64.numpy(), wh, tol) < 0.5
    assert abs(_share(y.numpy(), wy, tol) - _share(ys.numpy(), wy, tol)) < 0.1


def test_one_tf32_pass_misses_the_fp32_tolerance():
    """One TF32 pass for each product (C and h, xw and B each rounded to
    TF32 alone) puts y outside ``TOL["float32"]`` of fp64: the three
    passes are what hold the fp32 kernel to it."""
    x, a_log, b, c = inputs("mlstm", seed=26, dtype="float32")
    wy, _ = oracles(x, a_log, b, c)["fp64"]
    y1, _ = wide_model(x, a_log, b, c, "float32", n=1)
    y3, _ = wide_model(x, a_log, b, c, "float32")
    assert _share(y3.numpy(), wy, TOL["float32"]) <= 1
    assert _share(y1.numpy(), wy, TOL["float32"]) > 1
