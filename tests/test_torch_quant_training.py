"""Quantized resident state in the port's runner, held against the
reference's on the CPU.

``make_runner(..., quant=QuantConfig(...))`` against
``repro.core.make_runner`` with the same ``QuantConfig`` on the same
bridged llama2-smoke params and batches (helpers of
``test_torch_training``): per-step losses over a HiFT sweep (k=4) and two
more steps — so two groups are revisited from their bundle's master — for
int8 and NF4 with bf16 moments at fp32, NF4 under Mixed^Hi, and 3 FPFT
steps with bf16 moments.  The port's frozen projections and head go
through ``kernels.dequant_matmul`` (its plain version on the CPU) where
the reference decodes the frozen tree whole.

Tolerances, as ``test_torch_runner``: losses to rtol 3e-5 at fp32 (the
same fp32 arithmetic summed in other orders; the codes are equal, and
AdamW normalises each element's step, so a near-zero gradient moves its
element by ~lr either way); Mixed^Hi computes in bf16, rounded at other
places by the two frameworks: rtol 2e-3.

Also here: a quantized JAX ``TrainState`` continued in the port, the
rejection matrix of ``tests/test_quant.py``, the logical parameter
count, and the analytic figures ``chip_smoke.py`` prints beside the
quantized peaks.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LRSchedule as JLRSchedule  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import make_runner as jax_make_runner  # noqa: E402
from repro.optim.mixed_precision import get_policy as jax_policy  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import (LRSchedule, QuantConfig,  # noqa: E402
                              make_runner)
from repro_torch.dist import quant as Q  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim.mixed_precision import get_policy  # noqa: E402
from test_torch_training import (LR, _batches, _cfgs, _jbatch,  # noqa: E402,F401
                                 _jtree, _np_params, one_thread)

CASES = {
    "int8": dict(frozen="int8", policy="fp32"),
    "nf4": dict(frozen="nf4", policy="fp32"),
    "nf4_mixed_hi": dict(frozen="nf4", policy="mixed_hi"),
    "fpft": dict(frozen=None, policy="fp32", strategy="fpft", steps=3),
}


def _case(key):
    c = dict(strategy="hift", steps=6)
    c.update(CASES[key])
    return c


@functools.lru_cache(maxsize=None)
def _jax_run(key):
    """Per-step losses and the state after step 3 (numpy) of the reference
    runner."""
    c = _case(key)
    jcfg, cfg = _cfgs("llama2-7b")
    runner = jax_make_runner(jcfg, c["strategy"],
                             params=_jtree(_np_params("llama2-7b")),
                             optimizer="adamw",
                             schedule=JLRSchedule(base_lr=LR),
                             policy=jax_policy(c["policy"]),
                             quant=JQuantConfig(c["frozen"], "bf16"))
    losses, at3 = [], None
    for s, batch in enumerate(_batches(cfg, c["steps"])):
        if s == 3:
            at3 = jax.tree.map(np.asarray, runner.state.to_tree())
        losses.append(float(runner.train_step(_jbatch(batch))))
    return losses, at3


def _runner(key):
    c = _case(key)
    _, cfg = _cfgs("llama2-7b")
    return make_runner(cfg, c["strategy"],
                       params=bridge.to_torch(_np_params("llama2-7b")),
                       optimizer="adamw", schedule=LRSchedule(base_lr=LR),
                       policy=get_policy(c["policy"]),
                       quant=QuantConfig(c["frozen"], "bf16"), device="cpu")


@pytest.mark.parametrize("name", ["llama2-7b", "roberta-base"])
@pytest.mark.parametrize("fmt", ["int8", "nf4"])
def test_quantized_forward_and_backward_match_jax(fmt, name):
    """Layer 0 trains from a plain (decoded) copy; every other leaf stays a
    codec record: the embedding gathers and decodes rows, each frozen layer
    hands views to the dequant matmul and decoded norm and bias rows to
    the elementwise ops, the head is a view (llama) or the tied embedding
    decoded whole (roberta).  Loss and layer 0's gradients equal JAX's on
    its decoded tree at cut 0 (rtol 1e-5 / atol 1e-6, as
    ``test_torch_training``)."""
    from repro.dist.quant import dequantize_tree as jdequantize_tree
    from repro.dist.quant import quantize_tree as jquantize_tree
    from repro.models import transformer as JT
    from repro_torch.common.pytree import flatten_with_paths, tree_map
    from repro_torch.models import transformer as TT
    from repro_torch.models.base import LayerStack
    jcfg, cfg = _cfgs(name)
    npp = _np_params(name)
    batch = _batches(cfg, 1)[0]
    jdec = jax.jit(lambda p: jdequantize_tree(jquantize_tree(p, fmt)))(
        _jtree(npp))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, _jbatch(batch), cut=0,
                             compute_dtype=jnp.float32)))(jdec)
    params = Q.quantize_tree(bridge.to_torch(npp), fmt)
    stack = params["layers"]
    first = tree_map(lambda r: Q.dequantize_leaf(r)[0:1].requires_grad_(True)
                     if Q.is_quantized(r) else r[0:1].requires_grad_(True),
                     stack, is_leaf=Q.is_quantized)
    rest = tree_map(lambda r: {k: v[1:] for k, v in r.items()}
                    if Q.is_quantized(r) else r[1:], stack,
                    is_leaf=Q.is_quantized)
    loss = TT.loss_fn(cfg, {**params, "layers": LayerStack([first, rest])},
                      batch, cut=0, compute_dtype=torch.float32)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-6)
    named = flatten_with_paths(first)
    grads = torch.autograd.grad(loss, list(named.values()))
    jflat = flatten_with_paths(jgrads["layers"])
    for (path, _), g in zip(named.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[path][0:1]),
                                   rtol=1e-5, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("key", list(CASES))
def test_quantized_runner_matches_jax(key):
    c = _case(key)
    jlosses, _ = _jax_run(key)
    runner = _runner(key)
    _, cfg = _cfgs("llama2-7b")
    losses = [float(runner.train_step(b)) for b in _batches(cfg, c["steps"])]
    rtol = 2e-3 if c["policy"] == "mixed_hi" else 3e-5
    np.testing.assert_allclose(losses, jlosses, rtol=rtol)
    params = runner.params
    if c["frozen"]:
        # the resident tree stays encoded; the bundles hold fp32 masters
        # and bf16 moments
        assert Q.is_quantized(params["layers"]["attn"]["wq"])
        assert Q.quant_format(params["head"]["w"]) == c["frozen"]
        bundle = runner.opt_state["0"]
        assert {t.dtype for t in bundle["master"]["embed"].values()} == {
            torch.float32}
        assert bundle["opt"]["m"]["embed"]["tok"].dtype == torch.bfloat16
    else:
        assert runner.opt_state["m"]["embed"]["tok"].dtype == torch.bfloat16


def test_resident_codes_equal_the_references():
    """``init`` encodes the resident tree to the reference's codes."""
    jcfg, cfg = _cfgs("llama2-7b")
    jrunner = jax_make_runner(jcfg, "hift",
                              params=_jtree(_np_params("llama2-7b")),
                              quant=JQuantConfig("nf4", "bf16"))
    runner = _runner("nf4")
    want = bridge.to_torch(jax.tree.map(np.asarray, jrunner.params))
    from repro_torch.common.pytree import flatten_with_paths
    got = flatten_with_paths(runner.params)
    for path, t in flatten_with_paths(want).items():
        assert got[path].dtype == t.dtype, path
        assert torch.equal(got[path], t), path


def test_quantized_jax_state_continues_in_the_port():
    """3 quantized HiFT steps in JAX, the state (records in params, fp32
    masters and bf16 moments in bundles) bridged, 3 more in the port: the
    losses of 6 steps in JAX."""
    jlosses, at3 = _jax_run("nf4")
    runner = _runner("nf4")
    runner.state = bridge.state_to_torch(at3)
    assert Q.is_quantized(runner.params["layers"]["mlp"]["w_up"])
    assert runner.opt_state["1"]["master"]["layers"]["mlp"]["w_up"].dtype \
        == torch.float32
    _, cfg = _cfgs("llama2-7b")
    losses = [float(runner.train_step(b)) for b in _batches(cfg, 6)[3:]]
    np.testing.assert_allclose(losses, jlosses[3:], rtol=3e-5)


def test_quant_rejections_match_the_reference():
    """What ``tests/test_quant.py`` rejects, the port rejects."""
    with pytest.raises(ValueError, match="frozen"):
        QuantConfig(frozen="int4")
    with pytest.raises(ValueError, match="moments"):
        QuantConfig(moments="fp8")
    with pytest.raises(ValueError):
        QuantConfig()
    assert QuantConfig(moments="bf16").moment_dtype == torch.bfloat16
    _, cfg = _cfgs("llama2-7b")
    params = bridge.to_torch(_np_params("llama2-7b"))
    with pytest.raises(ValueError, match="does not support"):
        make_runner(cfg, "fpft", params=params, device="cpu",
                    quant=QuantConfig(frozen="int8"))
    with pytest.raises(ValueError, match="does not support"):
        make_runner(cfg, "mezo", params=params, device="cpu",
                    quant=QuantConfig(frozen="int8"))
    with pytest.raises(ValueError, match="moment-carrying"):
        make_runner(cfg, "hift", params=params, optimizer="sgd",
                    device="cpu", quant=QuantConfig(moments="bf16"))
    with pytest.raises(ValueError, match="by name"):
        make_runner(cfg, "hift", params=params,
                    optimizer=make_optimizer("adamw"), device="cpu",
                    quant=QuantConfig(moments="bf16"))


def test_peak_trainable_params_counts_logical_elements():
    """A codec record counts as the leaf it encodes, as in the
    reference."""
    plain = make_runner(_cfgs("llama2-7b")[1], "hift",
                        params=bridge.to_torch(_np_params("llama2-7b")),
                        device="cpu")
    runner = _runner("int8")
    assert runner.peak_trainable_params() == plain.peak_trainable_params()


def test_chip_smoke_quantized_analytic_figures_are_the_memory_models():
    """``chip_smoke.py`` prints the port's analytic P+G+S beside the
    quantized peaks; at each (policy, codec) its quantized phase runs
    (AdamW, bf16 moments, m=1), the figure equals the reference's
    ``repro.core.memory_model.analyze``."""
    from repro_torch.configs.registry import get_config
    from test_torch_training import _chip_smoke, _reference_analyze
    chip_smoke = _chip_smoke()
    cfg = get_config("llama2-7b")
    points = [("fp32", "nf4", 5.430839538574219),
              ("fp32", "int8", 8.568656921386719),
              ("mixed_hi", "nf4", 5.4308319091796875)]
    for precision, frozen, quoted in points:
        got = chip_smoke.analytic(cfg, "hift", precision, frozen=frozen,
                                  moments="bf16")
        want = _reference_analyze("llama2-7b", mode="hift",
                                  precision=precision, optimizer="adamw",
                                  frozen_quant=frozen, moment_dtype="bf16")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.pgs_gb == quoted       # the figure PERF.md quotes
