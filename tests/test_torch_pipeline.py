"""The port's bundle pipeline (``repro_torch.core.pipeline``) and the
strategies on it (``hift_pipelined``, ``lisa``), on the CPU, mirroring
``tests/test_pipeline.py``, and held against the JAX package.

On the CPU every transfer is the identity (as in the reference), so a
pipelined run is the serial run's arithmetic: held bit for bit, loss and
every state leaf at every step of two sweeps plus one, with the
pipeline's counters checked (no prefetch miss after sweep 1, at most
``depth`` bundles resident).  Against the JAX runners (bridged
llama2-smoke params, the same batches): losses to ``test_torch_runner``'s
rtol 3e-5 (the same fp32 arithmetic summed in other orders), the
pipeline's counters equal to the reference's on the same schedule, and
LiSA's sampled groups equal to the reference's.  The launcher runs each
new strategy end to end, and checkpoints carry a run between ``hift`` and
``hift_pipelined``.

What the CPU cannot show — the side streams, events and the caching
allocator on the card — ``chip_smoke.py``'s ``train_pipelined`` phase
holds: pipelined states bit-equal to serial at every step on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LiSAConfig as JLiSAConfig  # noqa: E402
from repro.core import LRSchedule as JLRSchedule  # noqa: E402
from repro.core import make_runner as jax_make_runner  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import flatten_with_paths  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import (HiFTConfig, LiSAConfig, LRSchedule,  # noqa: E402
                              make_runner, strategy_ids)
from repro_torch.core.pipeline import BundlePipeline  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from test_torch_training import (LR, _batches, _cfgs, _jbatch,  # noqa: E402,F401
                                 _jtree, _np_params, one_thread)

# the reference's tiny_dense_cfg(ce_chunk=0): 4 layers, so k = 6 groups
TINY = ArchConfig(name="tiny", family="dense", n_layers=4, d_model=64,
                  n_heads=4, kv_heads=2, d_ff=128, vocab=256, block_q=16,
                  block_k=16, ce_chunk=0)


def _batch(step, cfg=TINY):
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=2, seed=0)).batch_at(step)


def _snap(state):
    return {p: t.clone() if isinstance(t, torch.Tensor) else np.array(t)
            for p, t in flatten_with_paths(state.to_tree()).items()}


def _assert_same(a, b, err=""):
    assert a.keys() == b.keys(), (err, a.keys() ^ b.keys())
    for path, x in a.items():
        if isinstance(x, torch.Tensor):
            assert x.dtype == b[path].dtype and torch.equal(x, b[path]), \
                f"{err}{path}"
        else:
            np.testing.assert_array_equal(x, b[path], err_msg=f"{err}{path}")


def _runner(strategy, seed=0, cfg=TINY, **kw):
    kw.setdefault("schedule", LRSchedule(base_lr=3e-3))
    return make_runner(cfg, strategy, seed=seed, device="cpu", **kw)


# ------------------------------------------------------- bitwise equality

@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_hift_bitwise_equal_over_two_sweeps(depth):
    """Pipelined HiFT == serial HiFT bit for bit at every step of two
    sweeps and one step, the prefetcher served every revisit (no miss),
    and the window held at most ``depth`` bundles.  Depth 3 looks two
    groups ahead."""
    serial = _runner("hift")
    piped = (_runner("hift_pipelined") if depth == 2
             else _runner("hift", pipeline_depth=depth))
    assert piped.strategy._pipeline.depth == depth
    for step in range(2 * serial.k + 1):
        batch = _batch(step)
        assert float(serial.train_step(batch)) == \
            float(piped.train_step(batch)), step
        _assert_same(_snap(serial.state), _snap(piped.state),
                     err=f"step {step}: ")
    stats = piped.strategy.pipeline_stats
    assert stats.prefetch_hits >= serial.k
    assert stats.prefetch_misses == 0
    assert stats.max_resident <= depth
    assert serial.strategy.pipeline_stats is None


@pytest.mark.parametrize("switch_every", [1, 2])
def test_pipelined_lisa_bitwise_equal(switch_every):
    """LiSA's sample is a pure function of (seed, step), so it pipelines
    too; a re-sample landing on the same group skips the prefetch and
    misses (an upload ordered after that group's drain)."""
    lisa = LiSAConfig(m=1, switch_every=switch_every, seed=3)
    serial = _runner("lisa", lisa=lisa)
    piped = _runner("lisa", lisa=lisa, pipeline_depth=2)
    for step in range(12):
        batch = _batch(step)
        assert float(serial.train_step(batch)) == \
            float(piped.train_step(batch)), step
        _assert_same(_snap(serial.state), _snap(piped.state),
                     err=f"lisa step {step}: ")
    assert "order" not in piped.state.extra
    assert piped.strategy.pipeline_stats.max_resident <= 2


def test_pipelined_fused_equals_serial_unfused_bitwise():
    """Both knobs together (pipeline + fused SGD-m) against the serial
    unfused loop.  On the CPU the fused wrapper takes its plain version,
    the unfused update's arithmetic, so the runs agree bit for bit (the
    reference's case fails: its Pallas kernel rounds otherwise)."""
    serial = _runner("hift", optimizer="sgdm", fused_update=False)
    piped = _runner("hift", optimizer="sgdm", fused_update=True,
                    pipeline_depth=2)
    for step in range(2 * serial.k):
        batch = _batch(step)
        assert float(serial.train_step(batch)) == \
            float(piped.train_step(batch)), step
    _assert_same(_snap(serial.state), _snap(piped.state), err="fused: ")


# ------------------------------------------------- checkpoint / coherence

def test_pipelined_mid_sweep_checkpoint_resume(tmp_path):
    """Save a pipelined run mid-sweep (cache warm), restore it into a
    fresh pipelined runner (cold cache, other params) and into a serial
    one: all continue in bitwise lockstep with the uninterrupted serial
    run.  The pipeline is a transfer cache, not state."""
    serial = _runner("hift")
    piped = _runner("hift_pipelined")
    mid = serial.k + 2
    for step in range(mid):
        serial.train_step(_batch(step))
        piped.train_step(_batch(step))
    ckpt.save_state(tmp_path, mid, piped.state)
    fresh = _runner("hift_pipelined", seed=7)
    fresh.load_state_dict(ckpt.restore_state(tmp_path, mid).to_tree())
    plain = _runner("hift", seed=9)
    plain.load_state_dict(ckpt.restore(tmp_path, mid))
    assert fresh.step_count == plain.step_count == mid
    for step in range(mid, mid + serial.k):
        losses = {float(r.train_step(_batch(step)))
                  for r in (serial, piped, fresh, plain)}
        assert len(losses) == 1, (step, losses)
    base = _snap(serial.state)
    for name, r in (("warm", piped), ("resumed", fresh), ("serial", plain)):
        _assert_same(base, _snap(r.state), err=f"{name}: ")
    # the restored runner's first visit of each group was a miss
    assert fresh.strategy.pipeline_stats.prefetch_misses >= 1


def test_prefetch_cache_ignores_forked_state():
    """Re-stepping an old state must not consume a prefetch uploaded for
    another host tree: entries are keyed by source identity, so a fork
    falls back to a plain upload and stays bit-identical."""
    piped = _runner("hift_pipelined")
    serial = _runner("hift")
    batch = _batch(0)
    for _ in range(serial.k + 1):
        serial.train_step(batch)
        piped.train_step(batch)
    fork_p, fork_s = piped.state, serial.state
    piped.train_step(batch)
    misses = piped.strategy.pipeline_stats.prefetch_misses
    s1, m1 = piped.strategy.step(fork_p, batch)
    s2, m2 = serial.strategy.step(fork_s, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_same(_snap(s1), _snap(s2), err="fork: ")
    assert piped.strategy.pipeline_stats.prefetch_misses == misses + 1


# --------------------------------------------------------- budget / wiring

def test_bundle_pipeline_budget_blocks_at_depth():
    """Unit level: with depth 2 a third device bundle is admitted only
    after an older offload drains; depth < 2 is rejected outright."""
    with pytest.raises(ValueError, match="depth"):
        BundlePipeline(1, device="cpu")
    pipe = BundlePipeline(2, device="cpu")
    mk = lambda i: {"opt": torch.full((4,), float(i))}  # noqa: E731
    for i in range(5):
        key = str(i % 2)
        got = pipe.fetch(key, mk(i))
        pipe.prefetch(str((i + 1) % 2), mk(i + 10))
        pipe.offload(key, got)
        assert pipe.device_resident(active=0) <= pipe.depth
    assert pipe.stats.max_resident <= 2
    assert pipe.stats.offloads == 5
    assert pipe.stats.budget_waits >= 4
    pipe.flush()
    assert pipe.device_resident(active=0) == 0


def test_registry_entry_and_knob_threading():
    """The new entries register; make_runner's pipeline_depth and
    fused_update reach the strategy, with the reference's errors."""
    assert {"fpft", "fpft_streamed", "hift", "hift_pipelined",
            "lisa"} <= set(strategy_ids())
    r = _runner("hift_pipelined")
    assert r.strategy.hift.pipeline_depth == 2
    assert r.strategy.memory_mode == "hift_pipelined"
    assert r.strategy.memory_stream_depth == 2
    r2 = _runner("hift", pipeline_depth=3,
                 hift=HiFTConfig(m=2, strategy="top2down"))
    assert r2.strategy.hift.m == 2 and r2.strategy.hift.pipeline_depth == 3
    assert r2.strategy.memory_mode == "hift_pipelined"
    assert r2.strategy.memory_m == 2
    r3 = _runner("hift")
    assert r3.strategy._pipeline is None and r3.strategy.memory_mode == "hift"
    r4 = _runner("lisa", pipeline_depth=2)
    assert r4.strategy.lisa.pipeline_depth == 2
    assert r4.strategy.memory_mode == "hift_pipelined"
    assert _runner("lisa").strategy._pipeline is None
    with pytest.raises(ValueError, match="IS the pipelined schedule"):
        _runner("hift_pipelined", pipeline_depth=1)
    with pytest.raises(ValueError, match="pipeline_depth applies"):
        _runner("fpft", pipeline_depth=2)
    with pytest.raises(ValueError, match="pipeline_depth applies"):
        _runner("mezo", pipeline_depth=2)
    with pytest.raises(ValueError, match="does not apply to 'hift'"):
        _runner("hift", stream_window=1 << 12)
    with pytest.raises(ValueError, match="no fused update kernel"):
        _runner("hift", optimizer="adafactor", fused_update=True)
    # the fused-backward and zeroth-order strategies are ported, and the
    # bundle pipeline's depth does not apply to them
    for name in ("mezo", "lomo", "adalomo"):
        with pytest.raises(ValueError, match="pipeline_depth applies"):
            _runner(name, pipeline_depth=2)


# ----------------------------------------------------------- against JAX

def _jax_runner(strategy, **kw):
    jcfg, _ = _cfgs("llama2-7b")
    return jax_make_runner(jcfg, strategy,
                           params=_jtree(_np_params("llama2-7b")),
                           optimizer="adamw",
                           schedule=JLRSchedule(base_lr=LR), **kw)


def _port_runner(strategy, **kw):
    _, cfg = _cfgs("llama2-7b")
    return make_runner(cfg, strategy,
                       params=bridge.to_torch(_np_params("llama2-7b")),
                       optimizer="adamw", schedule=LRSchedule(base_lr=LR),
                       device="cpu", **kw)


def test_pipelined_losses_and_counters_match_jax():
    """Two sweeps and one step of the reference's pipelined LiSA runner
    (depth 3, re-sampled every step) and the port's, on the same params
    and batches: losses within rtol 3e-5, and the pipeline's counters
    equal (the same fetch, prefetch and offload calls in the same
    order).  ``test_torch_runner.py`` holds ``hift_pipelined`` and ``lisa``
    at depth 2 to the JAX runners."""
    jr = _jax_runner("lisa", lisa=JLiSAConfig(switch_every=1, seed=5),
                     pipeline_depth=3)
    tr = _port_runner("lisa", lisa=LiSAConfig(switch_every=1, seed=5),
                      pipeline_depth=3)
    _, cfg = _cfgs("llama2-7b")
    batches = _batches(cfg, 2 * tr.k + 1)
    jl = [float(jr.train_step(_jbatch(b))) for b in batches]
    tl = [float(tr.train_step(b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=3e-5)
    assert tr.strategy.pipeline_stats.__dict__ == \
        jr.strategy._pipeline.stats.__dict__


def test_lisa_samples_the_references_groups():
    """LiSA's group at each step equals the reference's, over seeds and
    switch periods (numpy's RandomState, seeded the same way)."""
    for seed, switch in ((0, 5), (3, 1), (11, 2)):
        jr = _jax_runner("lisa", lisa=JLiSAConfig(switch_every=switch,
                                                  seed=seed))
        tr = _port_runner("lisa", lisa=LiSAConfig(switch_every=switch,
                                                  seed=seed))
        want = [jr.strategy.group_index_at(s) for s in range(40)]
        assert [tr.strategy.group_index_at(s) for s in range(40)] == want
        assert [tr.group_for_step(s).label() for s in range(40)] == \
            [jr.group_for_step(s).label() for s in range(40)]
        assert tr.lr_for_step(7) == pytest.approx(jr.lr_for_step(7),
                                                  rel=1e-7)


# ------------------------------------------------------------- launcher

@pytest.mark.parametrize("argv,head", [
    (["--strategy", "hift_pipelined"], "hift_pipelined k=4"),
    (["--strategy", "lisa", "--switch-every", "2"], "lisa k=4"),
    (["--strategy", "fpft_streamed", "--stream-window", "65536",
      "--pipeline-depth", "3"], "family=dense"),
])
def test_launcher_runs_the_new_strategies(capsys, argv, head):
    out = train_cli.main(["--arch", "llama2-7b", "--smoke", "--steps", "8",
                          "--device", "cpu"] + argv)
    text = capsys.readouterr().out
    assert head in text and "step     0 loss" in text
    assert "done: final loss" in text
    assert len(out["losses"]) == 8 and all(np.isfinite(out["losses"]))


def test_launcher_resumes_across_hift_and_hift_pipelined(tmp_path, capsys):
    """4 steps of hift, resumed by hift_pipelined to 8, and the other way
    round: the same losses (the checkpoint is the same state tree; the
    loop's batches restart at 0 on a resume, in both runs alike)."""
    base = ["--arch", "llama2-7b", "--smoke", "--device", "cpu"]
    losses = []
    for first, second in (("hift", "hift_pipelined"),
                          ("hift_pipelined", "hift")):
        d = str(tmp_path / first)
        train_cli.main(base + ["--steps", "4", "--strategy", first,
                               "--ckpt-dir", d])
        out = train_cli.main(base + ["--steps", "8", "--strategy", second,
                                     "--ckpt-dir", d, "--resume", "auto"])
        assert "[resume] restored step 4" in capsys.readouterr().out
        assert ckpt.latest_step(d) == 8
        losses.append(out["losses"])
    assert len(losses[0]) == 4 and losses[0] == losses[1]
