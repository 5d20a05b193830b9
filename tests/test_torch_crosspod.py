"""The port's cross-pod reduce (``CrossPodConfig``, ``dist.compress``) on
the CPU, held against the JAX package.

- the int8 codec against ``repro.dist.compress``: codes and scales equal,
  residuals within 1e-7, fp32 and bf16 inputs; the residual is fp32 and
  the reconstruction comes back in the input's dtype; error feedback is
  lossless in aggregate over 20 rounds; ``init_residuals(pods=)`` shapes
  and ``wire_bytes``;
- the exact reduce (``compress=False``) against plain ``fpft``;
- HiFT (SGD, AdamW) and FPFT (AdamW) with ``CrossPodConfig(pods=2)``
  against the JAX runner on the bridged llama2-smoke params and the same
  batches, k + 1 steps: losses within 1e-4, params within 5e-5.  The
  residuals: the int8 codec rounds each pod's gradient, and a gradient a
  few ulps off the reference's can land on the other side of a rounding
  boundary; that entry's residual then moves by one quantum (the leaf's
  scale, about twice its largest residual).  So every entry is held
  within one quantum, and at most 0.1 % of a leaf's entries may differ by
  more than 1e-3 of a quantum (0.012 % did, a flip or two a leaf);
- the residuals ride the HiFT bundles and the FPFT ``extra`` and survive a
  checkpoint round trip;
- the refusals, with the reference's messages; the pipelined, LiSA and
  streamed strategies under ``cross_pod=``; the launcher's
  ``--crosspod-pods 2``.

On one intra-op thread (``test_torch_training.one_thread``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import CrossPodConfig as JCrossPodConfig
from repro.core import HiFTConfig as JHiFTConfig
from repro.core import LRSchedule as JLRSchedule
from repro.core import make_runner as jax_make_runner
from repro.dist import compress as JC
from repro_torch import bridge
from repro_torch.common.pytree import flatten_with_paths
from repro_torch.core import (CrossPodConfig, HiFTConfig, LRSchedule,
                              make_runner)
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.dist import compress as C
from repro_torch.launch import train as train_cli
from repro_torch.train import checkpoint as ckpt

from test_torch_training import (LR, _cfgs, _jbatch, _jtree,  # noqa: F401
                                 _np_params, one_thread)

CP = CrossPodConfig(pods=2, compress=True)


def _batches(cfg, n, batch=4):
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=batch, seed=0))
    return [data.batch_at(s) for s in range(n)]


def _runner(strategy, opt="adamw", cross_pod=CP, **kw):
    _, cfg = _cfgs("llama2-7b")
    if strategy == "hift":
        kw.setdefault("hift", HiFTConfig(m=1))
    return make_runner(cfg, strategy,
                       params=bridge.to_torch(_np_params("llama2-7b")),
                       optimizer=opt, schedule=LRSchedule(base_lr=LR),
                       cross_pod=cross_pod, device="cpu", **kw)


def _jrunner(strategy, opt="adamw"):
    jcfg, _ = _cfgs("llama2-7b")
    kw = {"hift": JHiFTConfig(m=1)} if strategy == "hift" else {}
    return jax_make_runner(jcfg, strategy,
                           params=_jtree(_np_params("llama2-7b")),
                           optimizer=opt, schedule=JLRSchedule(base_lr=LR),
                           cross_pod=JCrossPodConfig(pods=2, compress=True),
                           **kw)


# ------------------------------------------------------------------ codec

def _signal(n, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return torch.from_numpy(x * 0.3).to(dtype)


def _jnp(t):
    return jnp.asarray(bridge.to_numpy({"x": t}, bf16_dtype=jnp.bfloat16)
                       ["x"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_matches_the_reference(dtype):
    g = _signal(4096, 0, dtype)
    r = _signal(4096, 1, torch.float32) * 0.01
    q, s, nr = C.compress_with_feedback(g, r)
    jq, js, jr = JC.compress_with_feedback(_jnp(g), _jnp(r))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_allclose(nr.numpy(), np.asarray(jr), rtol=0, atol=1e-7)
    ghat, _ = C.compress_decompress(g, r)
    jghat, _ = JC.compress_decompress(_jnp(g), _jnp(r))
    np.testing.assert_array_equal(ghat.float().numpy(),
                                  np.asarray(jghat, np.float32))
    tree, res = C.compress_tree_with_feedback({"a": g, "b": {"c": g[:7]}},
                                              {"a": r, "b": {"c": r[:7]}})
    jtree, jres = JC.compress_tree_with_feedback(
        {"a": _jnp(g), "b": {"c": _jnp(g[:7])}},
        {"a": _jnp(r), "b": {"c": _jnp(r[:7])}})
    for got, want in ((tree["a"], jtree["a"]), (tree["b"]["c"],
                                                jtree["b"]["c"])):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    np.testing.assert_allclose(res["b"]["c"].numpy(),
                               np.asarray(jres["b"]["c"]), atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_is_fp32_and_reconstruction_keeps_the_dtype(dtype):
    g = torch.linspace(-0.3, 0.7, 128).to(dtype)
    ghat, r = C.compress_decompress(g, torch.zeros(128))
    assert ghat.dtype == dtype and r.dtype == torch.float32
    q, s = C.quantize_int8(g)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    assert C.dequantize_int8(q, s, torch.bfloat16).dtype == torch.bfloat16


def test_error_feedback_is_lossless_in_aggregate():
    r = torch.zeros(256)
    true_sum = np.zeros(256)
    deq_sum = np.zeros(256)
    for s in range(20):
        g = _signal(256, 10 + s, torch.float32) * 0.3
        q, scale, r = C.compress_with_feedback(g, r)
        true_sum += g.double().numpy()
        deq_sum += C.dequantize_int8(q, scale).double().numpy()
    np.testing.assert_allclose(deq_sum + r.double().numpy(), true_sum,
                               atol=1e-5)


def test_init_residuals_and_wire_bytes():
    tree = {"a": torch.ones(3, 5, dtype=torch.bfloat16), "b": torch.ones(7)}
    flat = C.init_residuals(tree)
    assert flat["a"].shape == (3, 5) and flat["a"].dtype == torch.float32
    stacked = C.init_residuals(tree, pods=2)
    assert stacked["a"].shape == (2, 3, 5) and stacked["b"].shape == (2, 7)
    assert all(float(t.abs().sum()) == 0 for t in stacked.values())
    big = {"w": torch.zeros(1000, 1000)}
    assert C.wire_bytes(big, False) == 4 * 10 ** 6
    assert C.wire_bytes(big, True) == 10 ** 6 + 4
    assert C.wire_bytes(big, False) / C.wire_bytes(big, True) > 3.99
    jt = {"a": jnp.ones((3, 5)), "b": jnp.ones(7)}
    assert C.wire_bytes(tree, True) == JC.wire_bytes(jt, True)


# ----------------------------------------------------------------- reduce

def test_exact_reduce_equals_plain_fpft():
    _, cfg = _cfgs("llama2-7b")
    plain = _runner("fpft", opt="sgd", cross_pod=None)
    exact = _runner("fpft", opt="sgd",
                    cross_pod=CrossPodConfig(pods=2, compress=False))
    assert "ef_residual" not in exact.state.extra
    for b in _batches(cfg, 3):
        np.testing.assert_allclose(float(exact.train_step(b)),
                                   float(plain.train_step(b)), rtol=1e-6)
    for p, t in flatten_with_paths(plain.params).items():
        np.testing.assert_allclose(flatten_with_paths(exact.params)[p],
                                   t, atol=1e-6, err_msg=p)


def _residuals(state, strategy):
    if strategy == "fpft":
        return state.extra["ef_residual"]
    return {k: b["ef"] for k, b in state.opt_state.items()}


@pytest.mark.parametrize("strategy,opt", [("hift", "sgd"), ("hift", "adamw"),
                                          ("fpft", "adamw")])
def test_crosspod_matches_the_jax_runner(strategy, opt):
    _, cfg = _cfgs("llama2-7b")
    port, ref = _runner(strategy, opt=opt), _jrunner(strategy, opt=opt)
    n = port.k + 1
    for b in _batches(cfg, n):
        np.testing.assert_allclose(float(port.train_step(b)),
                                   float(ref.train_step(_jbatch(b))),
                                   rtol=0, atol=1e-4)
    got = flatten_with_paths(_residuals(port.state, strategy))
    want = flatten_with_paths(jax.tree.map(
        np.asarray, _residuals(ref.state, strategy)))
    assert got.keys() == want.keys() and got
    for p, t in got.items():
        assert t.dtype == torch.float32
        quantum = 2 * max(float(np.abs(want[p]).max()), 1e-30)
        err = np.abs(t.numpy() - want[p])
        assert err.max() <= 1.01 * quantum, p
        assert (err > 1e-3 * quantum).mean() <= 1e-3, p
    want = flatten_with_paths(jax.tree.map(np.asarray, ref.params))
    for p, t in flatten_with_paths(port.params).items():
        np.testing.assert_allclose(t.numpy(), want[p], rtol=0, atol=5e-5,
                                   err_msg=p)


def test_residuals_ride_the_state_and_survive_a_checkpoint(tmp_path):
    _, cfg = _cfgs("llama2-7b")
    batches = _batches(cfg, 4)
    for strategy in ("hift", "fpft"):
        r = _runner(strategy)
        for b in batches[:2]:
            r.train_step(b)
        res = _residuals(r.state, strategy)
        assert flatten_with_paths(res)
        for t in flatten_with_paths(res).values():
            assert t.shape[0] == 2 and t.dtype == torch.float32
        assert any(float(t.abs().max()) > 0
                   for t in flatten_with_paths(res).values())
        d = tmp_path / strategy
        ckpt.save_state(d, 2, r.state)
        other = _runner(strategy)
        other.load_state_dict(ckpt.restore_state(d, 2).to_tree())
        got = flatten_with_paths(_residuals(other.state, strategy))
        for p, t in flatten_with_paths(res).items():
            assert torch.equal(got[p], t), p
        for b in batches[2:]:
            assert float(r.train_step(b)) == float(other.train_step(b))


def test_refusals_carry_the_reference_messages():
    jcfg, cfg = _cfgs("llama2-7b")
    r = _runner("fpft")
    bad = {k: v[:3] for k, v in _batches(cfg, 1)[0].items()}
    with pytest.raises(ValueError, match="divisible by pods=2; got leading "
                                         "dim 3"):
        r.train_step(bad)
    for name in ("lomo", "adalomo"):
        with pytest.raises(ValueError) as want:
            jax_make_runner(jcfg, name, params=_jtree(_np_params(
                "llama2-7b")), cross_pod=JCrossPodConfig(pods=2))
        with pytest.raises(ValueError) as got:
            make_runner(cfg, name, device="cpu", cross_pod=CP)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="strategy 'mezo' does not support "
                                         "cross_pod"):
        make_runner(cfg, "mezo", device="cpu", cross_pod=CP)


@pytest.mark.parametrize("strategy", ["hift_pipelined", "lisa",
                                      "fpft_streamed"])
def test_the_other_gradient_strategies_take_cross_pod(strategy):
    """Each runs; the pipelined HiFT and the streamed FPFT equal their
    serial twins bit for bit, as without ``cross_pod``."""
    _, cfg = _cfgs("llama2-7b")
    twin = {"hift_pipelined": "hift", "fpft_streamed": "fpft"}.get(strategy)
    kw = {"pipeline_depth": 2} if strategy == "hift_pipelined" else {}
    r = _runner(strategy, opt="sgd" if twin == "fpft" else "adamw", **kw)
    t = _runner(twin, opt="sgd" if twin == "fpft" else "adamw") \
        if twin else None
    for b in _batches(cfg, 3):
        loss = float(r.train_step(b))
        assert np.isfinite(loss)
        if t is not None:
            assert loss == float(t.train_step(b))


def test_launcher_crosspod_pods(capsys):
    out = train_cli.main(["--arch", "llama2-7b", "--smoke", "--steps", "3",
                          "--device", "cpu", "--seq", "32",
                          "--crosspod-pods", "2"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    out = train_cli.main(["--arch", "llama2-7b", "--smoke", "--steps", "2",
                          "--device", "cpu", "--seq", "32", "--strategy",
                          "fpft", "--crosspod-pods", "2", "--crosspod-exact"])
    assert len(out["losses"]) == 2
    assert "done: final loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "llama2-7b", "--smoke", "--device", "cpu",
                        "--coordinator", "file:///nonexistent"])


def test_crosspod_config_is_a_dataclass():
    assert dataclasses.asdict(CP) == {"pods": 2, "compress": True}
