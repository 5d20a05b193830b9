"""The port's runner held against the reference's, on the CPU.

``make_runner`` against ``repro.core.make_runner`` on the same bridged
llama2-smoke params and the same batches (helpers and tolerances of
``test_torch_training``): per-step losses and final params for 2 HiFT
sweeps (m=1, bottom2up) with each of adamw, sgdm and adagrad — the port
through its fused-update wrappers, whose CPU path is the plain version —
one sweep each top2down, random and m=2, Mixed^Hi, and 3 FPFT steps;
then the pipelined and streamed strategies: ``hift_pipelined`` (2 sweeps,
AdamW), ``lisa`` (6 steps re-sampled every step, SGD-momentum) and
``fpft_streamed`` (3 steps, AdamW through 16 KiB chunks).

Tolerances.  Losses to rtol 3e-5: the same fp32 arithmetic summed in
other orders (XLA, and PyTorch's CPU kernels), where AdamW and AdaGrad
normalise each element's step by its own gradient history, so an element
whose gradient is near zero moves by about lr either way on a last-bit
difference and the loss drifts by ~1e-5 over 8 steps.  Params: every
element to rtol 1e-5 / atol 1e-6, except that for AdamW and AdaGrad up to
1 % of a leaf's elements — those whose gradients are near zero, where a
relative error of the gradient becomes one of the step — are held only to
2 lr per visit of their group (the most a sign flip can move them).  Mixed^Hi computes in bf16, where the frameworks
round matmuls and elementwise chains at other places: losses to 2e-3
relative, params to one bf16 ulp of their magnitude (rtol 2**-7) with the
same allowance for flips.

Also here, since they reuse the reference runs: the purity contract and
the reference's metrics keys, and a JAX state carried into the port.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import HiFTConfig as JHiFTConfig  # noqa: E402
from repro.core import LiSAConfig as JLiSAConfig  # noqa: E402
from repro.core import LRSchedule as JLRSchedule  # noqa: E402
from repro.core import make_runner as jax_make_runner  # noqa: E402
from repro.optim.mixed_precision import get_policy as jax_policy  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import flatten_with_paths  # noqa: E402
from repro_torch.core import (HiFTConfig, LiSAConfig, LRSchedule,  # noqa: E402
                              make_runner)
from repro_torch.optim.mixed_precision import get_policy  # noqa: E402
from test_torch_training import (LR, _batches, _cfgs, _jbatch,  # noqa: E402,F401
                                 _jtree, _np_params, _runner, one_thread)

CASES = {
    "adamw": dict(opt="adamw", steps=8, fused=True),
    "sgdm": dict(opt="sgdm", steps=8, fused=True),
    "adagrad": dict(opt="adagrad", steps=8, fused=True),
    "top2down": dict(opt="adamw", order="top2down"),
    "random": dict(opt="sgdm", order="random", seed=3),
    "m2": dict(opt="adamw", m=2),
    "mixed_hi": dict(opt="adamw", policy="mixed_hi"),
    "fpft": dict(opt="adamw", strategy="fpft", steps=3, fused=True),
    "hift_pipelined": dict(opt="adamw", strategy="hift_pipelined", steps=8,
                           fused=True),
    "lisa": dict(opt="sgdm", strategy="lisa", seed=3, steps=6),
    "fpft_streamed": dict(opt="adamw", strategy="fpft_streamed", steps=3),
}


def _case(key):
    c = dict(strategy="hift", order="bottom2up", m=1, seed=0, steps=4,
             policy="fp32", fused=None)
    c.update(CASES[key])
    return c


def _strategy_kw(c, hift_cls, lisa_cls) -> dict:
    """make_runner keywords of a case's strategy (``*_cls``: either
    package's config classes)."""
    if c["strategy"] in ("hift", "hift_pipelined"):
        return {"hift": hift_cls(m=c["m"], strategy=c["order"],
                                 seed=c["seed"])}
    if c["strategy"] == "lisa":
        return {"lisa": lisa_cls(m=c["m"], switch_every=1, seed=c["seed"])}
    if c["strategy"] == "fpft_streamed":
        return {"stream_window": 1 << 14}
    return {}


@functools.lru_cache(maxsize=None)
def _jax_run(key):
    """Per-step losses, final params and the state after step 3 (numpy)
    of the reference runner, and the runner."""
    c = _case(key)
    jcfg, cfg = _cfgs("llama2-7b")
    kw = _strategy_kw(c, JHiFTConfig, JLiSAConfig)
    runner = jax_make_runner(jcfg, c["strategy"],
                             params=_jtree(_np_params("llama2-7b")),
                             optimizer=c["opt"],
                             schedule=JLRSchedule(base_lr=LR),
                             policy=jax_policy(c["policy"]), **kw)
    losses, at3 = [], None
    for s, batch in enumerate(_batches(cfg, c["steps"])):
        if s == 3:
            at3 = jax.tree.map(np.asarray, runner.state.to_tree())
        losses.append(float(runner.train_step(_jbatch(batch))))
    return losses, jax.tree.map(np.asarray, runner.params), at3, runner


def _torch_runner(key):
    c = _case(key)
    if c["strategy"] in ("hift", "fpft"):
        return _runner(c["opt"], c["strategy"], c["m"], c["order"],
                       c["seed"], c["policy"], c["fused"])
    _, cfg = _cfgs("llama2-7b")
    return make_runner(cfg, c["strategy"],
                       params=bridge.to_torch(_np_params("llama2-7b")),
                       optimizer=c["opt"], schedule=LRSchedule(base_lr=LR),
                       policy=get_policy(c["policy"]),
                       fused_update=c["fused"], device="cpu",
                       **_strategy_kw(c, HiFTConfig, LiSAConfig))


@pytest.mark.parametrize("key", list(CASES))
def test_runner_matches_jax(key):
    c = _case(key)
    jlosses, jparams, _, _ = _jax_run(key)
    runner = _torch_runner(key)
    _, cfg = _cfgs("llama2-7b")
    losses = [float(runner.train_step(b)) for b in _batches(cfg, c["steps"])]
    mixed = c["policy"] == "mixed_hi"
    np.testing.assert_allclose(losses, jlosses, rtol=2e-3 if mixed else 3e-5)
    rtol = 2.0 ** -7 if mixed else 1e-5
    # steps whose group visits an element (fpft: all of them)
    visits = -(-c["steps"] // runner.k)
    flip = 2 * LR * visits if c["opt"] in ("adamw", "adagrad") else 0.0
    want = flatten_with_paths(jparams)
    for path, t in flatten_with_paths(runner.params).items():
        assert t.dtype == (torch.bfloat16 if mixed else torch.float32), path
        got = t.float().numpy()
        ref = np.asarray(want[path], np.float32)
        err = np.abs(got - ref) - rtol * np.maximum(np.abs(got), np.abs(ref))
        assert np.mean(err > 1e-6) <= (0.01 if flip else 0.0), \
            (path, int(np.sum(err > 1e-6)))
        assert err.max() <= 1e-6 + flip, (path, float(err.max()))


def test_jax_state_continues_in_the_port():
    """3 HiFT steps in JAX, the state bridged, 3 more in the port: the
    losses of 6 steps in JAX."""
    jlosses, _, at3, _ = _jax_run("adamw")
    runner = _torch_runner("adamw")
    runner.state = bridge.state_to_torch(at3)
    assert runner.step_count == 3
    assert runner.state.opt_state["1"]["opt"]["count"].dtype == torch.int64
    _, cfg = _cfgs("llama2-7b")
    losses = [float(runner.train_step(b)) for b in _batches(cfg, 6)[3:]]
    np.testing.assert_allclose(losses, jlosses[3:6], rtol=3e-5)


# -------------------------------------------------------------- contract

def _snapshot(state):
    return {p: t.clone() for p, t in flatten_with_paths(
        {"params": state.params, "opt_state": state.opt_state}).items()}


@pytest.mark.parametrize("strategy", ["hift", "fpft", "hift_pipelined",
                                      "lisa", "fpft_streamed"])
def test_step_is_pure_on_cpu_and_metrics_match_jax(strategy):
    """Re-stepping an old state gives the same loss and params and leaves
    it untouched; the resident tree holds no graph and no ``.grad``; the
    metrics carry the reference's keys."""
    key = "adamw" if strategy == "hift" else strategy
    runner = _torch_runner(key)
    _, cfg = _cfgs("llama2-7b")
    batches = _batches(cfg, 3)
    runner.train_step(batches[0])
    s1 = runner.state
    before = _snapshot(s1)
    a, ma = runner.strategy.step(s1, batches[1])
    b, mb = runner.strategy.step(s1, batches[1])
    assert float(ma["loss"]) == float(mb["loss"])
    for path, t in _snapshot(s1).items():
        assert torch.equal(t, before[path]), path
    for x, y in zip(flatten_with_paths(a.params).values(),
                    flatten_with_paths(b.params).values()):
        assert torch.equal(x, y)
    for t in flatten_with_paths(a.params).values():
        assert not t.requires_grad and t.grad is None
    jax_runner = _jax_run(key)[3]
    assert set(ma) == set(jax_runner.last_metrics)
    if "group" in ma:
        assert [g.label() for g in runner.groups] == \
            [g.label() for g in jax_runner.groups]
        assert ma["group"] == runner.group_for_step(1).label() == \
            jax_runner.group_for_step(1).label()




# -------------------------------------------------------------- launcher

def test_launcher_fpft_flag_is_the_strategy_alias(monkeypatch, capsys):
    """``--fpft`` is the reference's deprecated alias for ``--strategy
    fpft``: it builds the ``fpft`` runner (whatever ``--strategy`` says)
    and trains exactly as the spelled-out strategy does."""
    from repro_torch.launch import train as train_cli
    built = []
    real = train_cli.make_runner

    def spy(cfg, strategy, **kw):
        built.append(strategy)
        return real(cfg, strategy, **kw)

    monkeypatch.setattr(train_cli, "make_runner", spy)
    base = ["--arch", "llama2-7b", "--smoke", "--steps", "2", "--device",
            "cpu"]
    alias = train_cli.main(base + ["--fpft", "--strategy", "hift"])
    spelled = train_cli.main(base + ["--strategy", "fpft"])
    assert built == ["fpft", "fpft"]
    assert alias["losses"] == spelled["losses"]
    assert "hift k=" not in capsys.readouterr().out
