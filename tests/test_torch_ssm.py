"""The port's SSM scan and Mamba2 pieces, held against the JAX package on
the CPU.

On CPU tensors ``repro_torch.kernels.ssm_scan.ssm_scan`` runs its plain
version ``kernels.ref.gated_chunked_scan_ref`` (the reference's chunked
scan line for line).  Inputs come from a numpy seed:

- fp32: y and the final state against ``repro.models.mamba2.
  gated_chunked_scan`` and against the sequential oracle
  ``repro.kernels.ref.ssm_scan_ref`` (given ``exp(a_log)``), at the
  reference's own bar for its scan kernel (atol 3e-5, rtol 1e-4,
  ``tests/test_kernels.py``), over chunk 16/32/128, S from 192 to 320
  (S = 200 and 300 at chunk 128), and slow decay (``a_log`` in [-0.05, 0]: a state entering a chunk is still
  large, so a wrong carry shows) and fast decay (``-softplus(N(0, 1))``).
  An S that the reference's chunk rule rejects (257; 200 at chunk 32) is
  held against the sequential oracle only (the port takes a short last
  chunk);
- bf16: against the JAX scan in bf16.  Both round every product to bf16,
  in other summation orders, so they agree to a few bf16 roundings of the
  output's scale: ``|d| <= 2e-2 |want| + 2^-7 max|want|``;
- ``_depthwise_conv``, ``ssd_chunked`` and ``mamba2_decode`` against JAX at
  fp32 within 1e-4 (the SSM scalars at a slow decay).

The CUDA kernel runs only on a card, where ``chip_smoke.py`` holds it
against the plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssm_scan as K  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401

TOL = dict(atol=3e-5, rtol=1e-4)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
B, H, P, N = 2, 3, 16, 16


def _inputs(s, decay, seed=0, b=B, h=H, p=P, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    if decay == "slow":
        a_log = -rng.uniform(0.0, 0.05, (b, s, h))
    elif decay == "mlstm":               # log_sigmoid(N(0, 1) + 3)
        a_log = -np.logaddexp(0.0, -(rng.standard_normal((b, s, h)) + 3))
    else:
        a_log = -np.logaddexp(rng.standard_normal((b, s, h)), 0.0)
    bm = 0.5 * rng.standard_normal((b, s, n))
    cm = 0.5 * rng.standard_normal((b, s, n))
    return x, a_log.astype(np.float32), bm.astype(np.float32), \
        cm.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_SEQ = {}


def _sequential(s, decay):
    """The JAX sequential oracle, once per input set."""
    if (s, decay) not in _SEQ:
        x, a_log, bm, cm = _inputs(s, decay)
        y, h = jax_ref.ssm_scan_ref(jnp.asarray(x), jnp.exp(jnp.asarray(a_log)),
                                    jnp.asarray(bm), jnp.asarray(cm))
        _SEQ[(s, decay)] = (np.asarray(y), np.asarray(h))
    return _SEQ[(s, decay)]


# (S, chunk) pairs the reference's chunk rule splits whole
WHOLE = [(200, 128), (300, 128), (192, 16), (192, 32), (320, 16), (320, 32),
         (320, 128)]


@pytest.mark.parametrize("decay", ["slow", "fast"])
@pytest.mark.parametrize("s,chunk", WHOLE)
def test_plain_scan_matches_jax_fp32(s, chunk, decay):
    x, a_log, bm, cm = _inputs(s, decay)
    y, h = K.ssm_scan(_t(x), _t(a_log), _t(bm), _t(cm), chunk=chunk)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    jy, jh = JM.gated_chunked_scan(jnp.asarray(x), jnp.asarray(a_log),
                                   jnp.asarray(bm), jnp.asarray(cm),
                                   chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    sy, sh = _sequential(s, decay)
    np.testing.assert_allclose(y.numpy(), sy, **TOL)
    np.testing.assert_allclose(h.numpy(), sh, **TOL)
    if decay == "slow":      # the carry is visible: the state stays large
        assert np.abs(sh).max() > 1.0


@pytest.mark.parametrize("s,chunk,split", [(257, 128, (128, 3)),
                                           (257, 16, (16, 17)),
                                           (200, 32, (33, 7)),
                                           (300, 16, (16, 19))])
def test_ragged_length_takes_a_short_last_chunk(s, chunk, split):
    """Where the reference's chunk rule (nc = S // chunk, Lc = S // nc)
    has no whole split, its reshape raises; the port's last chunk is
    short, and matches the sequential oracle."""
    assert tref.scan_chunking(s, chunk) == split
    x, a_log, bm, cm = _inputs(s, "slow")
    y, h = K.ssm_scan(_t(x), _t(a_log), _t(bm), _t(cm), chunk=chunk)
    sy, sh = _sequential(s, "slow")
    np.testing.assert_allclose(y.numpy(), sy, **TOL)
    np.testing.assert_allclose(h.numpy(), sh, **TOL)
    ty, th = tref.ssm_scan_ref(_t(x), torch.exp(_t(a_log)), _t(bm), _t(cm))
    np.testing.assert_allclose(ty.numpy(), sy, **TOL)
    np.testing.assert_allclose(th.numpy(), sh, **TOL)


@pytest.mark.parametrize("s,chunk,decay", [(192, 32, "slow"),
                                           (300, 128, "fast")])
def test_plain_scan_matches_jax_bf16(s, chunk, decay):
    x, a_log, bm, cm = _inputs(s, decay, seed=1)
    bf = jnp.bfloat16
    jy, jh = JM.gated_chunked_scan(jnp.asarray(x).astype(bf),
                                   jnp.asarray(a_log),
                                   jnp.asarray(bm).astype(bf),
                                   jnp.asarray(cm).astype(bf), chunk=chunk)
    y, h = K.ssm_scan(_t(x).bfloat16(), _t(a_log), _t(bm).bfloat16(),
                      _t(cm).bfloat16(), chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    for got, want in ((y.float().numpy(), np.asarray(jy.astype(jnp.float32))),
                      (h.numpy(), np.asarray(jh.astype(jnp.float32)))):
        bound = 2e-2 * np.abs(want) + 2.0 ** -7 * np.abs(want).max()
        assert (np.abs(got - want) <= bound).all(), \
            float(np.abs(got - want).max())


def test_entering_state_matches_jax():
    """``h0`` on the plain version (the reference scan takes one; the CUDA
    kernel refuses it, as no serving path passes one)."""
    x, a_log, bm, cm = _inputs(96, "slow", seed=2)
    h0 = np.random.default_rng(3).standard_normal((B, H, P, N)).astype(
        np.float32)
    y, h = K.ssm_scan(_t(x), _t(a_log), _t(bm), _t(cm), chunk=32, h0=_t(h0))
    jy, jh = JM.gated_chunked_scan(jnp.asarray(x), jnp.asarray(a_log),
                                   jnp.asarray(bm), jnp.asarray(cm), chunk=32,
                                   h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    K.reset_launches()
    x, a_log, bm, cm = (_t(a) for a in _inputs(70, "fast", seed=4))
    y, h = K.ssm_scan(x, a_log, bm, cm, chunk=32)
    ry, rh = tref.gated_chunked_scan_ref(x, a_log, bm, cm, chunk=32)
    assert torch.equal(y, ry) and torch.equal(h, rh.float())
    assert K.ssm_scan.launches == 0
    gy, gh = TM.gated_chunked_scan(x, a_log, bm, cm, chunk=32)
    assert torch.equal(gy, y) and torch.equal(gh, h)


def test_wrapper_refuses_grad_mode_off_the_cpu():
    """The kernel has no backward: off the CPU (the meta device stands in
    for the card, where ``chip_smoke.py`` checks the CUDA raise) an input
    that requires grad under grad mode raises before any launch, and the
    same call under ``torch.no_grad()`` gets past the guard.  On the CPU
    the plain version keeps its graph."""
    shapes = ((1, 8, 2, 64), (1, 8, 2), (1, 8, 64), (1, 8, 64))
    for i in range(4):
        args = [torch.empty(s, device="meta", requires_grad=(j == i))
                for j, s in enumerate(shapes)]
        with pytest.raises(RuntimeError, match="no backward"):
            K.ssm_scan(*args)
        with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
            K.ssm_scan(*args)
    x, a_log, bm, cm = (_t(a).requires_grad_(True)
                        for a in _inputs(40, "slow", seed=5))
    y, _ = K.ssm_scan(x, a_log, bm, cm, chunk=16)
    gx, ga = torch.autograd.grad(y.square().sum(), (x, a_log))
    assert gx.abs().sum() > 0 and ga.abs().sum() > 0


def test_wrapper_refuses_devices_and_shapes_without_a_kernel():
    x = torch.empty((1, 8, 2, 64), device="meta")
    a = torch.empty((1, 8, 2), device="meta")
    b = torch.empty((1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.ssm_scan(x, a, b, b)
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        K._check(torch.empty((1, 8, 2, 32)), torch.empty((1, 8, 2)),
                 torch.empty((1, 8, 64)), torch.empty((1, 8, 64)))
    with pytest.raises(ValueError, match="dtypes differ"):
        K._check(torch.empty((1, 8, 2, 64)), torch.empty((1, 8, 2)),
                 torch.empty((1, 8, 64), dtype=torch.bfloat16),
                 torch.empty((1, 8, 64)))
    with pytest.raises(ValueError, match="a_log"):
        K._check(torch.empty((1, 8, 2, 64)), torch.empty((1, 8, 3)),
                 torch.empty((1, 8, 64)), torch.empty((1, 8, 64)))


# ------------------------------------------------------------ the wide scan
#
# The mLSTM calls the scan at (P, N) = (hd + 1, hd), heads folded into the
# batch (H = 1): xlstm-1.3b's (1025, 1024) on the card, here hd = 64.

WIDE = dict(b=4, h=1, p=65, n=64)


@pytest.mark.parametrize("s,chunk,decay", [(256, 128, "mlstm"),
                                           (192, 64, "fast"),
                                           (100, 128, "mlstm")])
def test_wide_plain_scan_matches_jax_fp32(s, chunk, decay):
    x, a_log, bm, cm = _inputs(s, decay, seed=6, **WIDE)
    y, h = K.ssm_scan(_t(x), _t(a_log), _t(bm), _t(cm), chunk=chunk)
    assert y.shape == (4, s, 1, 65) and h.shape == (4, 1, 65, 64)
    jy, jh = JM.gated_chunked_scan(jnp.asarray(x), jnp.asarray(a_log),
                                   jnp.asarray(bm), jnp.asarray(cm),
                                   chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("s,chunk", [(200, 64), (257, 128)])
def test_wide_plain_scan_bf16_and_a_short_last_chunk(s, chunk):
    """bf16 against the JAX scan in bf16 (the bound of
    ``test_plain_scan_matches_jax_bf16``) where the reference's chunk rule
    splits S whole (200 at chunk 64: 4 x 50), and fp32 against the
    sequential oracle where it does not (257 at chunk 128: 128 + 128 +
    1)."""
    x, a_log, bm, cm = _inputs(s, "mlstm", seed=7, **WIDE)
    lc, nc = tref.scan_chunking(s, chunk)
    if s % lc:
        y, h = K.ssm_scan(_t(x), _t(a_log), _t(bm), _t(cm), chunk=chunk)
        sy, sh = jax_ref.ssm_scan_ref(
            jnp.asarray(x), jnp.exp(jnp.asarray(a_log)), jnp.asarray(bm),
            jnp.asarray(cm))
        np.testing.assert_allclose(y.numpy(), np.asarray(sy), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(sh), **TOL)
        return
    bf = jnp.bfloat16
    jy, jh = JM.gated_chunked_scan(jnp.asarray(x).astype(bf),
                                   jnp.asarray(a_log),
                                   jnp.asarray(bm).astype(bf),
                                   jnp.asarray(cm).astype(bf), chunk=chunk)
    y, h = K.ssm_scan(_t(x).bfloat16(), _t(a_log), _t(bm).bfloat16(),
                      _t(cm).bfloat16(), chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    for got, want in ((y.float().numpy(), np.asarray(jy.astype(jnp.float32))),
                      (h.numpy(), np.asarray(jh.astype(jnp.float32)))):
        bound = 2e-2 * np.abs(want) + 2.0 ** -7 * np.abs(want).max()
        assert (np.abs(got - want) <= bound).all(), \
            float(np.abs(got - want).max())


def test_wrapper_takes_both_widths_off_the_cpu_and_refuses_the_rest():
    """On the meta device (standing in for the card): the wrapper takes
    (64, 64) and (1025, 1024) past its checks (to the device, which has no
    kernel) and refuses any other (P, N), grad mode and an entering state
    before any launch."""
    meta = dict(device="meta")

    def args(p, n):
        return [torch.empty(sh, **meta) for sh in
                ((4, 8, 1, p), (4, 8, 1), (4, 8, n), (4, 8, n))]

    for p, n in ((64, 64), (1025, 1024)):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            K.ssm_scan(*args(p, n))
    for p, n in ((1024, 1024), (1025, 1025), (65, 64), (64, 1024)):
        with pytest.raises(ValueError, match=r"\(P, N\)"):
            K.ssm_scan(*args(p, n))
    args = args(1025, 1024)
    with pytest.raises(NotImplementedError, match="h0"):
        K.ssm_scan(*args, h0=torch.empty((4, 1, 1025, 1024), **meta))
    args[0] = args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        K.ssm_scan(*args)
    # the workspace: per 64-row chunk 64 x 64 fp32 scores in rows padded
    # to 68 (16-byte aligned rows), 129 fp64 decays
    assert K.wide_work_floats(16, 512, 1) == 16 * 8 * (64 * 68 + 258)
    assert K.wide_work_floats(16, 301, 1) == 16 * 5 * (64 * 68 + 258)


# ------------------------------------------------------------ Mamba2 pieces

def _cfg():
    jcfg = jax_get_config("zamba2-2.7b", smoke=True)
    import dataclasses
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


def _layer_params(jcfg, seed=5):
    """One Mamba2 layer's params (the JAX init's shapes), random from a
    numpy seed, the SSM scalars at a slow decay."""
    shapes = jax.eval_shape(lambda: JM.mamba2_init(jax.random.PRNGKey(0),
                                                   jcfg))
    rng = np.random.default_rng(seed)
    p = {}
    for k, sd in shapes.items():
        if k == "norm":
            p[k] = {"scale": (1 + 0.1 * rng.standard_normal(
                sd["scale"].shape)).astype(np.float32)}
            continue
        z = rng.standard_normal(sd.shape).astype(np.float32)
        p[k] = {"A_log": np.log(rng.uniform(0.02, 0.05, sd.shape)),
                "dt_bias": np.full(sd.shape, -4.0),
                "D": 1 + 0.1 * z, "conv_w": 0.1 * z, "conv_b": 0.1 * z}.get(
                    k, z / np.sqrt(sd.shape[0]) if z.ndim == 2 else z)
        p[k] = np.asarray(p[k], np.float32)
    return jax.tree.map(jnp.asarray, p), bridge.to_torch(p)


def test_depthwise_conv_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        jy, js = JM._depthwise_conv(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b),
                                    None if state is None else
                                    jnp.asarray(state))
        ty, ts = TM._depthwise_conv(_t(x), _t(w), _t(b),
                                    None if state is None else _t(state))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MODEL_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **MODEL_TOL)


def test_ssd_chunked_matches_jax():
    jcfg, cfg = _cfg()
    jp, tp = _layer_params(jcfg)
    x, _, bm, cm = _inputs(40, "slow", seed=7, h=cfg.ssm_heads,
                           p=TM.d_inner(cfg) // cfg.ssm_heads,
                           n=cfg.ssm_state)
    dt = np.logaddexp(np.random.default_rng(8).standard_normal(
        x.shape[:3]) - 4.0, 0.0).astype(np.float32)
    jy, jh = JM.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jp["A_log"],
                            jnp.asarray(bm), jnp.asarray(cm), jp["D"],
                            chunk=16)
    ty, th = TM.ssd_chunked(_t(x), _t(dt), tp["A_log"], _t(bm), _t(cm),
                            tp["D"], chunk=16)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MODEL_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)


def test_mamba2_decode_matches_jax():
    jcfg, cfg = _cfg()
    jp, tp = _layer_params(jcfg)
    rng = np.random.default_rng(9)
    b = 3
    di = TM.d_inner(cfg)
    h, n = cfg.ssm_heads, cfg.ssm_state
    ssm = rng.standard_normal((b, h, di // h, n)).astype(np.float32)
    conv = rng.standard_normal((b, cfg.conv_width - 1, di + 2 * n)).astype(
        np.float32)
    js, jc = jnp.asarray(ssm), jnp.asarray(conv)
    ts, tc = _t(ssm), _t(conv)
    for step in range(3):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        jy, js, jc = JM.mamba2_decode(jp, jnp.asarray(x), jcfg, js, jc)
        ty, ts, tc = TM.mamba2_decode(tp, _t(x), cfg, ts, tc)
        for got, want in ((ty, jy), (ts, js), (tc, jc)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **MODEL_TOL, err_msg=f"step {step}")
    z = TM.init_states(cfg, 2)
    jz = JM.init_states(jcfg, 2)
    assert [tuple(t.shape) for t in z] == [tuple(a.shape) for a in jz]
    assert z[0].dtype == torch.float32
