"""The port's optimizers and fused-update wrappers, held against the JAX
package on the CPU.

On CPU tensors each wrapper in ``repro_torch.kernels.fused_update`` runs
its plain PyTorch version (``repro_torch.kernels.ref``), which is also the
port's unfused update.  The same numpy-made leaves go through:

- the JAX Pallas kernels (``fused_*_pallas(..., interpret=True)``, over
  the reference's packed dtype buckets via ``repro.kernels.ops``) and the
  reference's pure-jnp oracles (``repro.kernels.ref.fused_*_ref``);
- the port's optimizers, fused and unfused, against the reference's
  optimizers over 3 steps with weight decay.

Tolerances: both sides compute in fp32 with the same operation order, but
not with the same roundings.  Under ``jit`` (the Pallas interpreter
included) XLA on the CPU contracts ``a*b + c`` into a fused multiply-add
(many of AdamW's moments differ from op-by-op arithmetic in the last
bit), and PyTorch's vectorised CPU ``sqrt`` is not correctly rounded (off
by one ulp on some inputs).  float32 results are therefore held to
rtol 2e-6 / atol 1e-7 (a few ulps of each value; atol, one ulp of 1.0,
covers values that cancel to near zero, whose error is that of their O(1)
operands), and
bfloat16 stores to one bfloat16 ulp (rtol 2**-7), since a one-ulp fp32
difference can straddle a bf16 rounding boundary.

The CUDA kernels themselves run only on a card, where ``chip_smoke.py``
holds each against its plain version; here the wrappers' bucketing and
device checks are covered without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_adagrad import fused_adagrad_pallas  # noqa: E402
from repro.kernels.fused_adamw import fused_adamw_pallas  # noqa: E402
from repro.kernels.fused_sgdm import fused_sgdm_pallas  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.optim import base as jbase  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import flatten_with_paths  # noqa: E402
from repro_torch.kernels import fused_update as FU  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim import base as tbase  # noqa: E402

F32 = dict(rtol=2e-6, atol=1e-7)
BF16 = dict(rtol=2.0 ** -7, atol=1e-12)

HYPER = {
    "adamw": dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1,
                  c1=1.0 - 0.9 ** 3, c2=1.0 - 0.999 ** 3),
    "sgdm": dict(lr=1e-2, momentum=0.9, weight_decay=0.1),
    "adagrad": dict(lr=1e-2, eps=1e-10, weight_decay=0.1),
}
N_MOMENTS = {"adamw": 2, "sgdm": 1, "adagrad": 1}
PALLAS = {"adamw": fused_adamw_pallas, "sgdm": fused_sgdm_pallas,
          "adagrad": fused_adagrad_pallas}
JREF = {"adamw": jref.fused_adamw_ref, "sgdm": jref.fused_sgdm_ref,
        "adagrad": jref.fused_adagrad_ref}
TREF = {"adamw": tref.fused_adamw_ref, "sgdm": tref.fused_sgdm_ref,
        "adagrad": tref.fused_adagrad_ref}
WRAP = {"adamw": FU.fused_adamw_update, "sgdm": FU.fused_sgdm_update,
        "adagrad": FU.fused_adagrad_update}
JOPS = {"adamw": jops.fused_adamw_update, "sgdm": jops.fused_sgdm_update,
        "adagrad": jops.fused_adagrad_update}


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _leaves(rng, moment_dtype):
    """(params, grads, moments...) as numpy, mixing dtypes so the buckets
    show: f32/f32, a bf16 param with a bf16 grad, an f32 master with a bf16
    grad (mixed_hi), and a lone scalar-sized leaf."""
    spec = [((7, 33), "f32", "f32"), ((129,), "bf16", "bf16"),
            ((4, 5, 6), "f32", "bf16"), ((1,), "f32", "f32"),
            ((300,), "f32", "f32")]
    cast = {"f32": lambda a: a, "bf16": _bf16}
    ps, gs, ms = [], [], []
    for shape, pdt, gdt in spec:
        ps.append(cast[pdt](rng.standard_normal(shape).astype(np.float32)))
        gs.append(cast[gdt](rng.standard_normal(shape).astype(np.float32)))
        m = [np.abs(rng.standard_normal(shape)).astype(np.float32) * 0.1
             for _ in range(2)]
        ms.append([cast[moment_dtype](x) for x in m])
    return ps, gs, ms


def _close(got, want):
    got = bridge._leaf_to_numpy(got, jnp.bfloat16)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    tol = BF16 if want.dtype == jnp.bfloat16 else F32
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), **tol)


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["adamw", "sgdm", "adagrad"])
def test_plain_fused_update_matches_jax(name, moment_dtype):
    """The wrapper's CPU path (and ``kernels.ref``) equals the Pallas
    kernel in interpret mode, leaf by leaf, and the reference's packed
    pytree update over the dtype buckets; inputs stay untouched."""
    rng = np.random.default_rng(0)
    ps, gs, ms = _leaves(rng, moment_dtype)
    nm = N_MOMENTS[name]
    kw = HYPER[name]
    tp = [bridge._leaf_to_torch(a, "cpu") for a in ps]
    tg = [bridge._leaf_to_torch(a, "cpu") for a in gs]
    tm = [[bridge._leaf_to_torch(m[j], "cpu") for m in ms]
          for j in range(nm)]
    before = [t.clone() for t in tp + tg + sum(tm, [])]
    got = WRAP[name](tp, tg, *tm, **kw)
    for a, b in zip(tp + tg + sum(tm, []), before):
        assert torch.equal(a, b)                    # functional on the CPU
    for i, (p, g, m) in enumerate(zip(ps, gs, ms)):
        jargs = (jnp.asarray(p), jnp.asarray(g),
                 *(jnp.asarray(m[j]) for j in range(nm)))
        pallas = PALLAS[name](*jargs, **kw, interpret=True)
        plain = TREF[name](tp[i], tg[i], *(tm[j][i] for j in range(nm)),
                           **kw)
        for k, want in enumerate(pallas):
            _close(got[k][i], want)
            _close(plain[k], want)
        if moment_dtype == "f32":
            # the oracle does its moment math in the moments' own dtype
            # (a bf16 moment times a Python float stays bf16 in JAX), so it
            # is the fp32 computation for fp32 moments only
            _close(got[0][i], JREF[name](*jargs, **kw)[0])
    # the reference's packed update: one stream per (param, grad) bucket
    tree = lambda xs: {f"l{i}": jnp.asarray(x) for i, x in enumerate(xs)}
    jout = JOPS[name](tree(ps), tree(gs),
                      *(tree([m[j] for m in ms]) for j in range(nm)), **kw)
    jout = jout if isinstance(jout, tuple) else (jout,)
    for k, jt in enumerate(jout):
        for i in range(len(ps)):
            _close(got[k][i], jt[f"l{i}"])


def test_wrapper_buckets_and_devices():
    """One launch per (param, grad, moment) dtype bucket and per 32 leaves;
    a device without a kernel raises instead of falling back."""
    def streams(dtypes):
        p = [torch.zeros(3, dtype=a) for a, _ in dtypes]
        g = [torch.zeros(3, dtype=b) for _, b in dtypes]
        return {"p": p, "g": g, "m": [torch.zeros(3) for _ in dtypes]}

    f32, bf = torch.float32, torch.bfloat16
    assert len(FU._buckets(streams([(f32, f32)] * 9))) == 1
    buckets = FU._buckets(streams([(f32, f32), (f32, bf), (bf, bf),
                                   (f32, f32)]))
    assert [(k, i) for k, i in buckets] == [((0, 0, 0), [0, 3]),
                                            ((0, 1, 0), [1]),
                                            ((1, 1, 0), [2])]
    assert [len(i) for _, i in FU._buckets(streams([(f32, f32)] * 40))] \
        == [32, 8]
    meta = [torch.empty(4, device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        FU.fused_sgdm_update(meta, meta, meta, lr=0.1, momentum=0.9,
                             weight_decay=0.0)


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["adamw", "sgdm", "adagrad"])
def test_optimizer_matches_jax(name, fused):
    """3 steps of the port's optimizer (fused wrapper or unfused ops) equal
    the reference's (unfused, and the Pallas-fused one), params and state,
    with weight decay; the step count stays a CPU int64 tensor."""
    rng = np.random.default_rng(1)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (2, 3, 4)}}
    params = {"a": _tree(rng, {"x": (5, 7)})["x"],
              "b": _tree(rng, shapes["b"])}
    kw = dict(weight_decay=0.05)
    topt = make_optimizer(name, use_fused=fused, **kw)
    jopts = [jax_make_optimizer(name, **kw),
             jax_make_optimizer(name, use_pallas_fused=True, **kw)]
    tp = bridge.to_torch(params)
    ts = topt.init(tp)
    jp = [jax_tree(params) for _ in jopts]
    js = [o.init(p) for o, p in zip(jopts, jp)]
    for step in range(3):
        grads = {"a": rng.standard_normal((5, 7)).astype(np.float32),
                 "b": _tree(rng, shapes["b"])}
        tp, ts = topt.update(bridge.to_torch(grads), ts, tp, 1e-2)
        for i, o in enumerate(jopts):
            jp[i], js[i] = o.update(jax_tree(grads), js[i], jp[i], 1e-2)
    assert ts["count"].device.type == "cpu" and int(ts["count"]) == 3
    for jpi, jsi in zip(jp, js):
        for path, t in flatten_with_paths(tp).items():
            _close(t, flatten_with_paths(jpi)[path])
        for key in ts:
            if key == "count":
                continue
            want = flatten_with_paths(jsi[key])
            for path, t in flatten_with_paths(ts[key]).items():
                _close(t, want[path])


def test_fused_equals_unfused_on_cpu():
    """On the CPU both routes are the plain version: bit for bit."""
    rng = np.random.default_rng(2)
    params = bridge.to_torch({"w": rng.standard_normal((9, 4)).astype(
        np.float32)})
    grads = bridge.to_torch({"w": rng.standard_normal((9, 4)).astype(
        np.float32)})
    for name in ("adamw", "sgdm", "adagrad"):
        a, b = (make_optimizer(name, use_fused=f, weight_decay=0.01)
                for f in (False, True))
        pa, sa = a.update(grads, a.init(params), params, 1e-3)
        pb, sb = b.update(grads, b.init(params), params, 1e-3)
        assert torch.equal(pa["w"], pb["w"])


def test_bias_correction_and_clip_match_jax():
    for count in (1, 2, 7, 1000):
        want = 1.0 - 0.999 ** jnp.asarray(count, jnp.int32).astype(
            jnp.float32)
        got = tbase.bias_correction(0.999, torch.tensor(count))
        np.testing.assert_allclose(got, float(want), **F32)
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((6, 5)).astype(np.float32) * 3,
         "b": rng.standard_normal((7,)).astype(np.float32)}
    want = jbase.clip_by_global_norm(jax_tree(g), 1.0)
    got = tbase.clip_by_global_norm(bridge.to_torch(g), 1.0)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_unported_optimizer_raises():
    # every optimizer of the paper is ported (Adafactor last); an unknown
    # name still raises
    assert make_optimizer("adafactor").name == "adafactor"
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lion")
