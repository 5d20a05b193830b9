"""Registry-wide strategy conformance for the port (the counterpart of
``tests/test_strategy_conformance.py``).

One test, parametrised over every name in
``repro_torch.core.registry.strategy_ids()``, over the contract's checks
and over the trained model families (dense: the reference's 4-layer
``tiny_dense_cfg``; hybrid: zamba2's SMOKE config, two super-blocks),
with no per-strategy special-casing: a new ``@register_strategy`` entry
gets all of it by registering.

- ``purity``: on the CPU a step leaves its input ``TrainState`` untouched
  (every leaf bit-identical before and after) and re-stepping it gives the
  same loss and state;
- ``lockstep``: ``save_state``/``restore_state`` round-trips bit-exactly
  mid-run, and a runner built from other params continues the restored
  state in bitwise lockstep with the uninterrupted one;
- ``metrics``: ``loss`` finite, ``lr`` finite, ``strategy`` the registry
  name;
- ``memory``: ``peak_trainable_params`` equals
  ``core.memory_model.analyze`` under the strategy's own ``memory_mode``,
  ``memory_m`` and stream window.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.common.pytree import flatten_with_paths, tree_size  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import TrainState, registry  # noqa: E402
from repro_torch.core.memory_model import analyze  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from test_torch_pipeline import (TINY, _assert_same, _batch,  # noqa: E402,F401
                                 _runner, _snap, one_thread)

ALL_STRATEGIES = registry.strategy_ids()
CHECKS = ["purity", "lockstep", "metrics", "memory"]
FAMILIES = {"dense": TINY,
            "hybrid": get_config("zamba2-2.7b", smoke=True)}


def test_registry_holds_the_ported_strategies():
    from repro.core.registry import strategy_ids as reference_ids
    assert {"adalomo", "fpft", "fpft_streamed", "hift", "hift_pipelined",
            "lisa", "lomo", "mezo"} <= set(ALL_STRATEGIES)
    assert set(ALL_STRATEGIES) == set(reference_ids())
    for name in ALL_STRATEGIES:
        assert registry.get_strategy_cls(name).name == name


def _purity(name, cfg, tmp_path):
    r = _runner(name, cfg=cfg)
    r.train_step(_batch(0, cfg))
    state = r.state
    before = _snap(state)
    new_state, metrics = r.strategy.step(state, _batch(1, cfg))
    assert isinstance(new_state, TrainState)
    assert int(new_state.step) == int(state.step) + 1
    _assert_same(before, _snap(state), err=f"{name}: input mutated @ ")
    again, m2 = r.strategy.step(state, _batch(1, cfg))
    assert float(m2["loss"]) == float(metrics["loss"])
    _assert_same(_snap(new_state), _snap(again), err=f"{name}: replay @ ")
    for t in flatten_with_paths(new_state.params).values():
        assert not t.requires_grad and t.grad is None


def _lockstep(name, cfg, tmp_path):
    r = _runner(name, cfg=cfg)
    for step in range(3):
        r.train_step(_batch(step, cfg))
    ckpt.save_state(tmp_path, 3, r.state)
    restored = ckpt.restore_state(tmp_path, 3)
    _assert_same(_snap(r.state), _snap(restored), err=f"{name}: restore @ ")
    r2 = _runner(name, seed=7, cfg=cfg)
    r2.load_state_dict(restored.to_tree())
    assert r2.step_count == 3
    for step in range(3, 5):
        assert float(r.train_step(_batch(step, cfg))) == \
            float(r2.train_step(_batch(step, cfg))), step
    _assert_same(_snap(r.state), _snap(r2.state), err=f"{name}: lockstep @ ")


def _metrics(name, cfg, tmp_path):
    r = _runner(name, cfg=cfg)
    _, metrics = r.strategy.step(r.state, _batch(0, cfg))
    assert math.isfinite(float(metrics["loss"]))
    assert math.isfinite(float(metrics["lr"]))
    assert metrics["strategy"] == name


def _memory(name, cfg, tmp_path):
    r = _runner(name, cfg=cfg)
    s = r.strategy
    params = r.state.params
    rep = analyze(params, s.model.unit_spec(s.cfg), optimizer="adamw",
                  precision="fp32", mode=s.memory_mode, m=s.memory_m,
                  stream_depth=s.memory_stream_depth,
                  stream_chunk_bytes=s.memory_stream_chunk_bytes)
    assert rep.n_params == tree_size(params)
    assert rep.peak_trainable == s.peak_trainable_params(params), name
    # the model's optimizer state never exceeds the resident strategy's
    full = analyze(params, s.model.unit_spec(s.cfg), optimizer="adamw",
                   precision="fp32", mode="fpft")
    assert rep.state_mb <= full.state_mb


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_strategy_conformance(strategy, check, family, tmp_path):
    {"purity": _purity, "lockstep": _lockstep, "metrics": _metrics,
     "memory": _memory}[check](strategy, FAMILIES[family], tmp_path)
