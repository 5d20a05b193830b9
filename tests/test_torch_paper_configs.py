"""The paper's experiment matrix in the port, held against the JAX package
on the CPU: the three configs the port lacked (roberta-large, gpt2-large,
gpt-neo-2.7b), ``get_config(optimized=True)`` and the balanced attention
schedule it selects, and the Adafactor optimizer.

Tolerances.
- Configs: equal field for field.
- Balanced attention: forward and gradients (w.r.t. q, k and v of a
  weighted sum of the output) to rtol 1e-5 / atol 1e-6, the fp32 tolerance
  of ``test_torch_training.py``: the same online-softmax arithmetic over
  the same blocks in the same order, summed by XLA and by PyTorch's CPU
  kernels.  The port's balanced and default schedules run one loop, so
  they are held to each other bit for bit.
- One SMOKE HiFT step of each new config: the runner tolerances of
  ``test_torch_runner.py`` (losses rtol 3e-5; params rtol 1e-5 / atol
  1e-6, with AdamW's allowance of 2 lr a visit for at most 1 % of a
  leaf's elements, those whose gradients are near zero).
- Adafactor's ``leaf_update``: moments rtol 1e-6 / atol 1e-9, params
  rtol 1e-6 / atol lr x 1e-6 (fp32 elementwise math and means of up to
  40 elements, which XLA may contract into fused multiply-adds and sum in
  another order: the normalised update, of order 1, is good to a few ulps
  and moves a param by lr times it).  The 4-step run: losses rtol 3e-5, params
  rtol 1e-5 / atol 1e-6; Adafactor scales each step by the RMS of the
  whole update, so no element's step hangs on its own gradient's sign.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.core import HiFTConfig as JHiFTConfig  # noqa: E402
from repro.core import LRSchedule as JLRSchedule  # noqa: E402
from repro.core import make_runner as jax_make_runner  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import flatten_with_paths  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import HiFTConfig, LRSchedule, make_runner  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from test_torch_training import (LR, _batches, _cfgs, _jbatch,  # noqa: E402,F401
                                 _jtree, _np_params, one_thread)

# the packages export the factory under the module's name
JA = importlib.import_module("repro.optim.adafactor")
TA = importlib.import_module("repro_torch.optim.adafactor")

NEW = ["roberta-large", "gpt2-large", "gpt-neo-2.7b"]
PAPER = ["llama2-7b", "roberta-base"] + NEW


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("name", NEW)
def test_new_configs_equal_the_references(name):
    for smoke in (False, True):
        got = treg.get_config(name, smoke=smoke)
        want = jreg.get_config(name, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), smoke
    assert treg.normalize(name) in treg.PORTED_IDS


@pytest.mark.parametrize("name", PAPER)
def test_optimized_equals_the_references(name):
    got = treg.get_config(name, optimized=True)
    want = jreg.get_config(name, optimized=True)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.attention_balanced
    # a no-op at smoke size, as in the reference
    assert treg.get_config(name, smoke=True, optimized=True) == \
        treg.get_config(name, smoke=True)
    assert not treg.get_config(name, smoke=True, optimized=True) \
        .attention_balanced


def test_paper_ids_are_the_references():
    assert treg.PAPER_IDS == jreg.PAPER_IDS
    assert set(treg.PAPER_IDS) <= set(treg.PORTED_IDS)


# ------------------------------------------------------------ balanced

def _jax_attention(q, k, v, w, balanced):
    def loss(q, k, v):
        o = JL.chunked_causal_attention(q, k, v, balanced=balanced)
        return jnp.sum(o * w), o

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("seq", [2048, 1536])
def test_balanced_attention_matches_jax(seq):
    """The reference's 512-wide blocks: 4 (even pairs) and 3 (the odd
    middle block) per sequence.

    At an odd block count the reference's stitching is wrong: ``argsort``
    of the pair indices puts the duplicated middle block before the blocks
    above it and the last one is cut, so each q block above the middle
    gets the output of the block below it.  The port computes the
    attention, so there it is held to the reference's default schedule,
    the same function; the test records the reference's shift."""
    rng = np.random.default_rng(seq)
    q, k, v, w = (rng.standard_normal((1, seq, 2, 16)).astype(np.float32)
                  for _ in range(4))
    n, bq = seq // 512, 512
    jout, jgrads = _jax_attention(q, k, v, w, balanced=True)
    if n % 2:
        blocks = lambda a: a.reshape(1, n, bq, *a.shape[2:])
        default = blocks(_jax_attention(q, k, v, w, balanced=False)[0])
        shifted = blocks(jout)
        mid = n // 2
        np.testing.assert_array_equal(shifted[:, :mid + 1],
                                      default[:, :mid + 1])
        np.testing.assert_array_equal(shifted[:, mid + 1:],
                                      default[:, mid:n - 1])
        jout, jgrads = _jax_attention(q, k, v, w, balanced=False)
    outs = {}
    for balanced in (True, False):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))
        out = TL.chunked_causal_attention(tq, tk, tv, balanced=balanced)
        grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                    (tq, tk, tv))
        outs[balanced] = (out.detach(), grads)
    out, grads = outs[True]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-6)
    assert torch.equal(out, outs[False][0])
    assert all(torch.equal(a, b) for a, b in zip(grads, outs[False][1]))


def test_balanced_attention_rejects_unequal_block_counts():
    x = torch.zeros((1, 64, 1, 8))
    with pytest.raises(ValueError, match="equal q/kv block counts"):
        TL.chunked_causal_attention(x, x, x, 16, 32, balanced=True)


# ------------------------------------------------------------ runners

def _assert_params_close(runner, jparams, steps, flip_lr):
    visits = -(-steps // runner.k)
    flip = 2 * flip_lr * visits
    want = flatten_with_paths(jparams)
    for path, t in flatten_with_paths(runner.params).items():
        got = t.float().numpy()
        ref = np.asarray(want[path], np.float32)
        err = np.abs(got - ref) - 1e-5 * np.maximum(np.abs(got), np.abs(ref))
        assert np.mean(err > 1e-6) <= (0.01 if flip else 0.0), \
            (path, int(np.sum(err > 1e-6)))
        assert err.max() <= 1e-6 + flip, (path, float(err.max()))


def _run_both(name, opt, steps):
    jcfg, cfg = _cfgs(name)
    npp = _np_params(name)
    jr = jax_make_runner(jcfg, "hift", params=_jtree(npp), optimizer=opt,
                         hift=JHiFTConfig(m=1),
                         schedule=JLRSchedule(base_lr=LR))
    tr = make_runner(cfg, "hift", params=bridge.to_torch(npp), optimizer=opt,
                     hift=HiFTConfig(m=1), schedule=LRSchedule(base_lr=LR),
                     device="cpu")
    jl, tl = [], []
    for b in _batches(cfg, steps):
        jl.append(float(jr.train_step(_jbatch(b))))
        tl.append(float(tr.train_step(b)))
    return jl, tl, jax.tree.map(np.asarray, jr.params), tr


@pytest.mark.parametrize("name", NEW)
def test_smoke_hift_step_matches_jax(name):
    """The embed step (backward through every layer, the tied head) and
    the layer-0 step."""
    jl, tl, jparams, tr = _run_both(name, "adamw", 2)
    np.testing.assert_allclose(tl, jl, rtol=3e-5)
    _assert_params_close(tr, jparams, 2, LR)


# ------------------------------------------------------------ adafactor

LEAF_CASES = {
    "matrix": dict(shape=(24, 40)),
    "stacked matrix": dict(shape=(3, 24, 40)),
    "vector": dict(shape=(40,)),
    "stacked bias (factored across layers)": dict(shape=(3, 40)),
    "matrix_rms + relative_step + wd": dict(
        shape=(3, 24, 40), matrix_rms=True, relative_step=True,
        weight_decay=0.1),
    "vector matrix_rms": dict(shape=(40,), matrix_rms=True),
    "stacked moments": dict(shape=(3, 24, 40), stacked=True,
                            matrix_rms=True),
}


@pytest.mark.parametrize("case", list(LEAF_CASES))
def test_adafactor_leaf_update_matches_jax(case):
    kw = dict(LEAF_CASES[case])
    shape, stacked = kw.pop("shape"), kw.pop("stacked", False)
    rng = np.random.default_rng(len(case))
    p = rng.standard_normal(shape).astype(np.float32)
    jmom = JA.moment_init(jnp.asarray(p), stacked=stacked)
    tmom = TA.moment_init(torch.from_numpy(p), stacked=stacked)
    assert {k: v.shape for k, v in jmom.items()} == \
        {k: tuple(v.shape) for k, v in tmom.items()}
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    for count in (1, 2, 3):
        g = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        jb2, tb2 = JA.beta2_at(count), TA.beta2_at(count)
        assert float(tb2) == float(jb2)
        jp, jmom = JA.leaf_update(jp, jnp.asarray(g), jmom, 1e-2, jb2, **kw)
        tp, tmom = TA.leaf_update(tp, torch.from_numpy(g), tmom, 1e-2, tb2,
                                  **kw)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-2 * 1e-6)
        for key in jmom:
            np.testing.assert_allclose(tmom[key].numpy(),
                                       np.asarray(jmom[key]), rtol=1e-6,
                                       atol=1e-9)


def test_adafactor_hift_run_matches_jax():
    """4 SMOKE HiFT steps (embed, two layers, head) with Adafactor; its
    bundles carry the reference's factored moments (``stacked=False`` on
    a group's stacked slice)."""
    jl, tl, jparams, tr = _run_both("llama2-7b", "adafactor", 4)
    np.testing.assert_allclose(tl, jl, rtol=3e-5)
    _assert_params_close(tr, jparams, 4, 0.0)
    layer = tr.opt_state["1"]["opt"]["moments"]["layers"]["attn"]
    assert set(layer["wq"]) == {"vr", "vc"}
    assert tuple(layer["wq"]["vr"].shape) == (1, 64)
    # a stacked norm scale (1, d) is factored across its one layer
    assert set(tr.opt_state["1"]["opt"]["moments"]["layers"]["ln1"]
               ["scale"]) == {"vr", "vc"}
    assert make_optimizer("adafactor").state_bytes_per_param == 0.01
    with pytest.raises(ValueError, match="not 'adafactor'"):
        from repro_torch.core import QuantConfig
        _, cfg = _cfgs("llama2-7b")
        make_runner(cfg, "hift", params=bridge.to_torch(
            _np_params("llama2-7b")), optimizer="adafactor",
            quant=QuantConfig(moments="bf16"), device="cpu")
