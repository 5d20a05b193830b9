"""Checkpoint and resume in the port (``repro_torch.train.checkpoint``,
``train.loop``, ``launch.train``), on the CPU, mirroring
``tests/test_fault.py`` (no elastic case), and across the two packages.

On the CPU a HiFT step is the same arithmetic however the state got into
the runner, so a resumed run is held to the straight one bit for bit.  A
run that crosses packages is held to the runner tolerances of
``test_torch_runner.py`` (losses rtol 3e-5).
"""
import functools
import io
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import HiFTConfig as JHiFTConfig  # noqa: E402
from repro.core import LRSchedule as JLRSchedule  # noqa: E402
from repro.core import make_runner as jax_make_runner  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import (flatten_with_paths,  # noqa: E402
                                       is_record)
from repro_torch.core import (HiFTConfig, LiSAConfig,  # noqa: E402
                              LRSchedule, QuantConfig, make_runner)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim.mixed_precision import get_policy  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import LoopConfig, train  # noqa: E402
from test_torch_training import (LR, _batches, _cfgs, _jbatch,  # noqa: E402,F401
                                 _jtree, _np_params, one_thread)

_REPO = Path(__file__).resolve().parents[1]

STATES = {   # make_runner keywords of each state kind
    "fp32": dict(),
    "mixed_hi": dict(policy="mixed_hi"),
    "nf4_bf16": dict(quant=QuantConfig("nf4", "bf16")),
    "int8": dict(quant=QuantConfig("int8")),
    "adafactor": dict(optimizer="adafactor"),
    "fpft": dict(strategy="fpft"),
    "hift_pipelined": dict(strategy="hift_pipelined"),
    "lisa": dict(strategy="lisa"),
    "fpft_streamed": dict(strategy="fpft_streamed", stream_window=1 << 14),
}


def _runner(kind="fp32", params_seed=None, m=2):
    """A CPU runner of llama2-smoke: the bridged reference params, or the
    port's own init from ``params_seed``."""
    kw = dict(STATES[kind])
    _, cfg = _cfgs("llama2-7b")
    strategy = kw.pop("strategy", "hift")
    if strategy in ("hift", "hift_pipelined"):
        kw["hift"] = HiFTConfig(m=m)
    elif strategy == "lisa":
        kw["lisa"] = LiSAConfig(m=m, switch_every=1, seed=1)
    if "policy" in kw:
        kw["policy"] = get_policy(kw["policy"])
    params = None if params_seed is not None else bridge.to_torch(
        _np_params("llama2-7b"))
    return make_runner(cfg, strategy, params=params, seed=params_seed or 0,
                       schedule=LRSchedule(base_lr=LR), device="cpu",
                       **{"optimizer": "adamw", **kw})


def _flat(runner):
    return flatten_with_paths(runner.state_dict())


def _assert_states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for path, x in fa.items():
        y = fb[path]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype, path
            assert torch.equal(x, y), path
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=path)


# ------------------------------------------------------------ test_fault.py

@pytest.mark.parametrize("kind", list(STATES))
def test_checkpoint_roundtrip(tmp_path, kind):
    """Save after 3 steps, restore into a runner of other params: every
    leaf equal in value and dtype, codec records still records, the
    counts int64, and the next step equal."""
    r = _runner(kind)
    _, cfg = _cfgs("llama2-7b")
    batches = _batches(cfg, 4)
    for b in batches[:3]:
        r.train_step(b)
    ckpt.save(tmp_path, 3, r.state_dict())
    r2 = _runner(kind, params_seed=1)
    r2.load_state_dict(ckpt.restore(tmp_path, 3))
    assert r2.step_count == r.step_count == 3
    _assert_states_equal(r, r2)
    if kind in ("nf4_bf16", "int8"):
        tok = r2.params["embed"]["tok"]
        assert is_record(tok)
        assert tok["q"].dtype == (torch.uint8 if kind == "nf4_bf16"
                                  else torch.int8)
    if kind == "nf4_bf16":
        assert r2.opt_state["0"]["opt"]["m"]["embed"]["tok"].dtype == \
            torch.bfloat16
    counts = [t for p, t in _flat(r2).items() if p.endswith("count")]
    assert counts and all(t.dtype == torch.int64 for t in counts)
    if kind in ("fpft", "fpft_streamed", "lisa"):
        assert "order" not in r2.state.extra
    else:
        assert r2.state.extra["order"].dtype == np.int64
    assert float(r.train_step(batches[3])) == float(r2.train_step(batches[3]))
    _assert_states_equal(r, r2)


def test_restart_resumes_hift_schedule_exactly(tmp_path):
    """Kill mid-sweep; the resumed run continues with the same next group
    and ends with the params of the straight run."""
    _, cfg = _cfgs("llama2-7b")
    batches = _batches(cfg, 7)
    ref = _runner()
    for b in batches:
        ref.train_step(b)
    r1 = _runner()
    for b in batches[:4]:
        r1.train_step(b)
    ckpt.save(tmp_path, 4, r1.state_dict())
    del r1
    r2 = _runner(params_seed=99)      # other params: must be overwritten
    r2.load_state_dict(ckpt.restore(tmp_path, 4))
    assert r2.group_for_step().label() == ref.groups[
        ref.order[4 % ref.k]].label()
    for b in batches[4:]:
        r2.train_step(b)
    _assert_states_equal(ref, r2)


def test_incomplete_checkpoint_ignored(tmp_path):
    r = _runner()
    ckpt.save(tmp_path, 1, r.state_dict())
    broken = tmp_path / "step_2"          # a crash mid-write: no MANIFEST
    broken.mkdir()
    (broken / "state.msgpack.zst").write_bytes(b"garbage")
    assert ckpt.latest_step(tmp_path) == 1
    assert ckpt.restore_latest(tmp_path)[0] == 1
    assert ckpt.restore_latest(tmp_path / "none") == (None, None)


def test_keep_k_garbage_collection(tmp_path):
    r = _runner()
    for s in range(1, 6):
        ckpt.save(tmp_path, s, r.state_dict(), keep=2)
    assert ckpt.all_steps(tmp_path) == [4, 5]
    assert not list(tmp_path.glob(".tmp_*"))


def _iter(cfg, start=0):
    batches = _batches(cfg, 8)
    return iter(batches[start:])


def test_resume_auto_via_train_loop(tmp_path, capsys):
    _, cfg = _cfgs("llama2-7b")
    straight = _runner()
    train(straight, _iter(cfg), LoopConfig(total_steps=6, log_every=0))
    r = _runner()
    train(r, _iter(cfg), LoopConfig(total_steps=4, ckpt_every=2, log_every=0,
                                    ckpt_dir=str(tmp_path), async_ckpt=False))
    assert ckpt.all_steps(tmp_path) == [2, 4]
    # crash + fresh process: resume="auto" picks up at step 4
    r2 = _runner(params_seed=5)
    out = train(r2, _iter(cfg, 4), LoopConfig(
        total_steps=6, ckpt_every=2, log_every=0, ckpt_dir=str(tmp_path),
        resume="auto"))
    assert "[resume] restored step 4" in capsys.readouterr().out
    assert r2.step_count == 6 and len(out["losses"]) == 2
    assert ckpt.all_steps(tmp_path) == [2, 4, 6]
    _assert_states_equal(straight, r2)


def test_launcher_resumes_with_ckpt_dir(tmp_path, capsys):
    args = ["--arch", "llama2-7b", "--smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    first = train_cli.main(args + ["--steps", "4"])
    assert ckpt.all_steps(tmp_path) == [2, 4]
    out = train_cli.main(args + ["--steps", "6", "--resume", "auto"])
    text = capsys.readouterr().out
    assert "[resume] restored step 4" in text and "done: final loss" in text
    assert len(first["losses"]) == 4 and len(out["losses"]) == 2
    assert ckpt.all_steps(tmp_path) == [2, 4, 6]   # every 3 steps now
    assert all(np.isfinite(out["losses"]))


def test_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """The writer thread encodes what the state was when ``save`` was
    called, though the leaves are written in place before it runs (as the
    card's steps update params and moments in place)."""
    r = _runner()
    _, cfg = _cfgs("llama2-7b")
    for b in _batches(cfg, 2):
        r.train_step(b)
    want = {p: (t.clone() if isinstance(t, torch.Tensor) else t)
            for p, t in _flat(r).items()}
    release = threading.Event()
    encode = ckpt._encode

    def held(snap):
        assert release.wait(timeout=60)
        return encode(snap)

    monkeypatch.setattr(ckpt, "_encode", held)
    writer = ckpt.save(tmp_path, 2, r.state_dict(), async_write=True)
    for t in _flat(r).values():
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t.add_(1.0)                       # the next in-place update
    release.set()
    writer.join(timeout=60)
    assert not writer.is_alive()
    got = flatten_with_paths(ckpt.restore(tmp_path, 2))
    assert got.keys() == want.keys()
    for p, t in want.items():
        np.testing.assert_array_equal(np.asarray(got[p]), np.asarray(t),
                                      err_msg=p)


def test_restore_state_and_the_elastic_resize(tmp_path):
    r = _runner()
    ckpt.save_state(tmp_path, 0, r.state)
    state = ckpt.restore_state(tmp_path, 0)
    assert state.step == 0 and state.extra["order"].dtype == np.int64
    # the elastic resize through a strategy (no mesh here: the state lands
    # where that strategy keeps it); the multi-rank resize is held in
    # tests/test_torch_distributed.py
    other = _runner()
    placed = ckpt.restore_state(tmp_path, 0, strategy=other.strategy)
    assert placed.step == 0
    for p, t in flatten_with_paths(r.state.params).items():
        assert torch.equal(flatten_with_paths(placed.params)[p], t), p


# ------------------------------------------------------------ across packages

def _jax_runner():
    jcfg, _ = _cfgs("llama2-7b")
    return jax_make_runner(jcfg, "hift", params=_jtree(_np_params(
        "llama2-7b")), optimizer="adamw", hift=JHiFTConfig(m=2),
        schedule=JLRSchedule(base_lr=LR))


@functools.lru_cache(maxsize=None)
def _jax_run():
    """6 JAX steps: the losses, and the state after step 3 (numpy)."""
    _, cfg = _cfgs("llama2-7b")
    jr = _jax_runner()
    losses, at3 = [], None
    for s, b in enumerate(_batches(cfg, 6)):
        if s == 3:
            at3 = jax.tree.map(np.asarray, jr.state_dict())
        losses.append(float(jr.train_step(_jbatch(b))))
    return losses, at3


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_jax_checkpoint_continues_in_the_port(tmp_path, monkeypatch, codec):
    """3 steps in JAX, saved by ``repro.train.checkpoint`` (zstd where
    ``zstandard`` is installed, as here, or its zlib fallback), restored
    into a port runner of other params: 3 more steps give the losses of 6
    in JAX."""
    if codec == "zlib":
        monkeypatch.setattr(jckpt, "zstandard", None)
    jlosses, at3 = _jax_run()
    jckpt.save(tmp_path, 3, at3)
    blob = (tmp_path / "step_3" / "state.msgpack.zst").read_bytes()
    assert (blob[:4] == b"ZLIB") == (codec == "zlib")
    r = _runner(params_seed=7)
    r.load_state_dict(ckpt.restore(tmp_path, 3))
    assert r.step_count == 3
    assert r.opt_state["1"]["opt"]["count"].dtype == torch.int64
    _, cfg = _cfgs("llama2-7b")
    losses = [float(r.train_step(b)) for b in _batches(cfg, 6)[3:]]
    np.testing.assert_allclose(losses, jlosses[3:], rtol=3e-5)


@pytest.mark.parametrize("kind", ["hift_pipelined", "fpft_streamed"])
def test_jax_pipelined_checkpoint_continues_in_the_port(tmp_path, kind):
    """3 steps of the reference's ``hift_pipelined`` (m=2) or
    ``fpft_streamed`` (16 KiB chunks), saved by
    ``repro.train.checkpoint``, continue 3 steps in the port's plain
    ``hift`` or ``fpft``, and that port state continues in the port's
    pipelined or streamed runner: the losses of 6 JAX steps (the pipeline
    and the stream are transfer schedules, not state)."""
    jcfg, cfg = _cfgs("llama2-7b")
    jkw = ({"hift": JHiFTConfig(m=2)} if kind == "hift_pipelined"
           else {"stream_window": 1 << 14})
    jr = jax_make_runner(jcfg, kind, params=_jtree(_np_params("llama2-7b")),
                         optimizer="adamw", schedule=JLRSchedule(base_lr=LR),
                         **jkw)
    batches = _batches(cfg, 6)
    jl = [float(jr.train_step(_jbatch(b))) for b in batches[:3]]
    jckpt.save(tmp_path / "jax", 3, jax.tree.map(np.asarray,
                                                 jr.state_dict()))
    jl += [float(jr.train_step(_jbatch(b))) for b in batches[3:]]
    plain = _runner("fp32" if kind == "hift_pipelined" else "fpft",
                    params_seed=7)
    plain.load_state_dict(ckpt.restore(tmp_path / "jax", 3))
    tl = [float(plain.train_step(b)) for b in batches[3:5]]
    ckpt.save(tmp_path / "port", 5, plain.state_dict())
    again = _runner(kind, params_seed=9)
    again.load_state_dict(ckpt.restore(tmp_path / "port", 5))
    tl.append(float(again.train_step(batches[5])))
    np.testing.assert_allclose(tl, jl[3:], rtol=3e-5)


@pytest.mark.parametrize("strategy", ["lomo", "adalomo", "mezo"])
def test_fused_and_zeroth_order_checkpoints_cross_packages(tmp_path,
                                                           strategy):
    """3 steps of the reference's ``lomo``, ``adalomo`` or ``mezo``, saved
    by ``repro.train.checkpoint``, continue 2 steps in a port runner of
    other params; that state, saved by the port, is read by
    ``repro.train.checkpoint.restore`` and the reference's runner (its
    own state replaced) takes the last step: the losses of 6 JAX steps.  The port's ``mezo`` draws
    the reference's z through its seam, so the step agrees only if the
    restored ``extra["rng"]`` is the reference's key."""
    from test_torch_mezo import jax_step_noise
    jcfg, cfg = _cfgs("llama2-7b")
    npp = _np_params("llama2-7b")
    jr = jax_make_runner(jcfg, strategy, params=_jtree(npp), seed=3,
                         schedule=JLRSchedule(base_lr=LR))
    batches = _batches(cfg, 6)
    jl = [float(jr.train_step(_jbatch(b))) for b in batches[:3]]
    jckpt.save(tmp_path / "jax", 3, jax.tree.map(np.asarray,
                                                 jr.state_dict()))
    jl += [float(jr.train_step(_jbatch(b))) for b in batches[3:]]
    kw = {"noise": jax_step_noise(npp)} if strategy == "mezo" else {}
    r = make_runner(cfg, strategy, seed=7, schedule=LRSchedule(base_lr=LR),
                    device="cpu", **kw)
    r.load_state_dict(ckpt.restore(tmp_path / "jax", 3))
    assert r.step_count == 3
    if strategy == "mezo":
        assert r.state.extra["rng"].dtype == np.uint32
        np.testing.assert_array_equal(r.state.extra["rng"], [0, 3])
    if strategy == "adalomo":
        assert r.opt_state["count"].dtype == torch.int64
    tl = [float(r.train_step(b)) for b in batches[3:5]]
    ckpt.save(tmp_path / "port", 5, r.state_dict())
    jr.load_state_dict(jckpt.restore(tmp_path / "port", 5))
    assert jr.step_count == 5
    tl.append(float(jr.train_step(_jbatch(batches[5]))))
    np.testing.assert_allclose(tl, jl[3:], rtol=3e-5)


def test_port_checkpoint_is_read_by_the_reference(tmp_path):
    """A port checkpoint (bf16 params under Mixed^Hi among its leaves) read
    by ``repro.train.checkpoint.restore``: every leaf equal, and the JAX
    runner continues from it in step with the port."""
    r = _runner("mixed_hi")
    _, cfg = _cfgs("llama2-7b")
    batches = _batches(cfg, 5)
    for b in batches[:3]:
        r.train_step(b)
    ckpt.save(tmp_path, 3, r.state_dict())
    tree = jckpt.restore(tmp_path, 3)
    want = _flat(r)
    got = flatten_with_paths(tree)
    assert got.keys() == want.keys()
    for p, t in want.items():
        a = np.asarray(got[p])
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            assert str(a.dtype) == "bfloat16", p
            np.testing.assert_array_equal(a.view(np.uint16), t.view(
                torch.int16).numpy().view(np.uint16), err_msg=p)
        else:
            np.testing.assert_array_equal(a, np.asarray(t), err_msg=p)
    jcfg, _ = _cfgs("llama2-7b")
    from repro.optim.mixed_precision import get_policy as jax_policy
    jr = jax_make_runner(jcfg, "hift", params=_jtree(_np_params(
        "llama2-7b")), optimizer="adamw", hift=JHiFTConfig(m=2),
        schedule=JLRSchedule(base_lr=LR), policy=jax_policy("mixed_hi"))
    jr.load_state_dict(tree)
    assert jr.step_count == 3
    jl = [float(jr.train_step(_jbatch(b))) for b in batches[3:]]
    tl = [float(r.train_step(b)) for b in batches[3:]]
    # Mixed^Hi computes in bf16: the runner test's 2e-3
    np.testing.assert_allclose(tl, jl, rtol=2e-3)


def test_payload_bytes_are_msgpacks():
    """The port's encoder writes the bytes ``msgpack.packb`` writes for the
    same payload, and reads what it writes."""
    msgpack = pytest.importorskip("msgpack")
    payload = {"paths": ["a/b", "c" * 40, "d" * 300],
               "leaves": [{"dtype": "float32", "shape": [2, 70000],
                           "data": b"\x01" * 70000},
                          {"dtype": "int64", "shape": [], "data": b""},
                          {"dtype": "bfloat16", "shape": [3],
                           "data": b"\x00" * 300}],
               "n": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32]}
    raw = bytes(ckpt.packb(payload))
    assert raw == msgpack.packb(payload, use_bin_type=True)
    assert ckpt.unpackb(raw) == payload
    assert msgpack.unpackb(raw, raw=False) == payload
    with pytest.raises(ValueError, match="unsupported msgpack tag"):
        ckpt.unpackb(msgpack.packb(1.5))


def test_saves_and_restores_without_msgpack_or_zstandard(tmp_path):
    """In an interpreter where importing ``msgpack`` or ``zstandard``
    fails: the port saves and restores, and a zstd blob raises a clear
    error."""
    code = f"""
import io, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("msgpack", "zstandard"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import torch
from repro_torch.train import checkpoint as ckpt
tree = {{"p": {{"w": torch.randn(3, 4), "b": torch.randn(4).bfloat16()}},
        "count": torch.tensor(2), "t": torch.zeros((2, 0, 3))}}
ckpt.save({str(tmp_path)!r}, 1, tree)
back = ckpt.restore({str(tmp_path)!r}, 1)
assert torch.equal(back["p"]["w"], tree["p"]["w"])
assert torch.equal(back["p"]["b"], tree["p"]["b"])
assert back["count"].dtype == torch.int64 and int(back["count"]) == 2
assert back["t"].shape == (2, 0, 3)
try:
    ckpt._Inflater(io.BytesIO(bytes.fromhex("28b52ffd") + b"x"))
except RuntimeError as e:
    assert "zstandard is not installed" in str(e)
else:
    raise AssertionError("no error for a zstd blob")
assert "msgpack" not in sys.modules and "zstandard" not in sys.modules
print("OK")
"""
    env = {"PYTHONPATH": str(_REPO / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("OK")


def test_blob_is_one_zlib_stream_the_reference_reads(tmp_path, monkeypatch):
    """The blob, written a chunk at a time (several here), is ``b"ZLIB"``
    and one zlib stream: ``zlib.decompress`` and the reference read it, and
    the port reads it back a piece at a time."""
    import zlib
    monkeypatch.setattr(ckpt, "_CHUNK", 1 << 16)
    rng = np.random.default_rng(0)
    big = rng.standard_normal((ckpt._CHUNK * 2 + 12345) // 4).astype(
        np.float32).view(np.uint8)
    path = tmp_path / "blob"
    ckpt._write_blob(path, [b"head", big, b"", b"tail"])
    blob = path.read_bytes()
    raw = b"head" + big.tobytes() + b"tail"
    assert blob[:4] == b"ZLIB"
    assert zlib.decompress(blob[4:]) == raw == jckpt._decompress(blob)
    with open(path, "rb") as f:
        src = ckpt._Inflater(f)
        assert bytes(src.read(4)) == b"head"
        assert bytes(src.read(len(raw) - 8)) == raw[4:-4]
        assert bytes(src.read(4)) == b"tail"
        with pytest.raises(ValueError, match="ends early"):
            src.read(1)


def test_zstd_blob_reads_where_zstandard_is_installed():
    zstandard = pytest.importorskip("zstandard")
    raw = bytes(range(256)) * 100
    blob = zstandard.ZstdCompressor(level=3).compress(raw)
    assert bytes(ckpt._Inflater(io.BytesIO(blob)).read(len(raw))) == raw

