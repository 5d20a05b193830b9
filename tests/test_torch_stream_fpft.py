"""The port's chunk stream (``repro_torch.core.pipeline.ChunkLayout`` /
``ChunkStream``) and ``fpft_streamed``, on the CPU, mirroring
``tests/test_stream_fpft.py`` and ``tests/test_chunk_properties.py``, and
held against the JAX package.

- ``fpft_streamed`` against resident ``fpft``: bit for bit, loss, params
  and optimizer state at every step (the per-chunk update is the resident
  update's elementwise arithmetic); checkpoints interchangeable both ways;
  the knobs and the stream-safety gates with the reference's messages.
- ``ChunkLayout`` against the reference's: the same ``(leaf path, start,
  n)`` pieces for the same bridged tree (the port flattens in jax's
  sorted-key order).
- The properties of ``tests/test_chunk_properties.py`` (partition, round
  trip, bounded residency) over seeded random trees as parametrised
  cases: mixed dtypes, scalars, random chunk sizes and depths.

The card's in-place path (host views, side streams) is held by
``chip_smoke.py``'s ``train_streamed`` phase: ``fpft_streamed`` bit-equal
to ``fpft`` at gpt-neo-2.7b's full size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import ChunkLayout as JChunkLayout  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import flatten_with_paths  # noqa: E402
from repro_torch.core import StreamConfig  # noqa: E402
from repro_torch.core.pipeline import (BundlePipeline,  # noqa: E402
                                       ChunkLayout, ChunkStream)
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from test_torch_pipeline import (_assert_same, _batch, _runner,  # noqa: E402,F401
                                 _snap, one_thread)
from test_torch_training import _np_params  # noqa: E402


# ------------------------------------------------------- bitwise equality

def test_streamed_equals_resident_fpft_bitwise():
    """fpft_streamed (AdamW moments streamed through a small many-chunk
    window) == resident fpft, bit for bit — loss, params and optimizer
    state — at every step."""
    res = _runner("fpft")
    strm = _runner("fpft_streamed", stream_window=1 << 13, pipeline_depth=3)
    for step in range(4):
        batch = _batch(step)
        assert float(res.train_step(batch)) == \
            float(strm.train_step(batch)), step
        _assert_same(_snap(res.state), _snap(strm.state),
                     err=f"step {step}: ")


def test_streamed_window_residency_and_stats():
    """A step's sweep stays within its depth-chunk budget, every chunk is
    served by the lookahead (no miss) and drained once."""
    strm = _runner("fpft_streamed", stream_window=1 << 12, pipeline_depth=2)
    strm.train_step(_batch(0))
    layout = ChunkLayout.build(strm.state.params,
                               strm.strategy.stream.chunk_bytes)
    assert layout.num_chunks > 4
    stats = strm.strategy.stream_stats
    assert stats.max_resident <= 2
    assert stats.prefetch_misses == 0
    assert stats.prefetch_hits == stats.offloads == layout.num_chunks


# ------------------------------------------------ checkpoint interchange

def test_mid_stream_checkpoint_interchangeable(tmp_path):
    """A streamed checkpoint restores into a resident runner and the other
    way (the same state tree: streaming is a placement, not a format);
    all four runners continue in bitwise lockstep."""
    res = _runner("fpft")
    strm = _runner("fpft_streamed", stream_window=1 << 13)
    mid = 3
    for step in range(mid):
        res.train_step(_batch(step))
        strm.train_step(_batch(step))
    ckpt.save_state(tmp_path / "streamed", mid, strm.state)
    ckpt.save_state(tmp_path / "resident", mid, res.state)
    into_res = _runner("fpft", seed=7)
    into_res.load_state_dict(
        ckpt.restore_state(tmp_path / "streamed", mid).to_tree())
    into_strm = _runner("fpft_streamed", seed=9, stream_window=1 << 12,
                        pipeline_depth=4)
    into_strm.load_state_dict(
        ckpt.restore_state(tmp_path / "resident", mid).to_tree())
    assert into_res.step_count == into_strm.step_count == mid
    for step in range(mid, mid + 3):
        losses = {float(r.train_step(_batch(step)))
                  for r in (res, strm, into_res, into_strm)}
        assert len(losses) == 1, (step, losses)
    base = _snap(res.state)
    _assert_same(base, _snap(strm.state), err="streamed: ")
    _assert_same(base, _snap(into_res.state), err="streamed->resident: ")
    _assert_same(base, _snap(into_strm.state), err="resident->streamed: ")


# ------------------------------------------------- knobs / safety gates

def test_stream_knob_threading():
    r = _runner("fpft_streamed", stream_window=1 << 12, pipeline_depth=4)
    assert r.strategy.stream.chunk_bytes == 1 << 12
    assert r.strategy.stream.depth == 4
    assert r.strategy.memory_mode == "fpft_streamed"
    assert r.strategy.memory_stream_depth == 4
    assert r.strategy.memory_stream_chunk_bytes == 1 << 12
    assert _runner("fpft_streamed").strategy.stream == StreamConfig()
    with pytest.raises(ValueError, match="stream_window"):
        _runner("fpft", stream_window=1 << 12)


def test_stream_safety_gates():
    """fpft_streamed refuses updates that are not elementwise: adafactor,
    a global-norm clip, the fused kernels — with the reference's
    message."""
    def msg(name):
        return ("fpft_streamed needs a stream-safe optimizer (elementwise "
                "update with no cross-leaf coupling; Optimizer.stream_safe) "
                f"— got {name!r} with stream_safe=False.  Turn off "
                "grad_clip / the fused-kernel path, or use the resident "
                "'fpft' strategy")
    for kw, name in ((dict(optimizer="adafactor"), "adafactor"),
                     (dict(optimizer=make_optimizer("adamw", grad_clip=1.0)),
                      "adamw"),
                     (dict(optimizer="adamw", fused_update=True), "adamw")):
        with pytest.raises(ValueError) as ei:
            _runner("fpft_streamed", **kw)
        assert str(ei.value) == msg(name)


def test_stream_config_rejects_degenerate_windows():
    with pytest.raises(ValueError, match="chunk_bytes must be > 0"):
        StreamConfig(chunk_bytes=0)
    with pytest.raises(ValueError, match="depth must be >= 2"):
        StreamConfig(depth=1)


def test_chunk_layout_rejects_zero_byte_chunks():
    for size in (0, -8):
        with pytest.raises(ValueError, match="chunk_bytes must be > 0"):
            ChunkLayout.build({"w": torch.ones(4)}, size)


def test_bundle_pipeline_rejects_depth_below_two():
    for depth in (1, 0):
        with pytest.raises(ValueError, match="depth"):
            BundlePipeline(depth, device="cpu")


# ------------------------------------------------------ layout vs the JAX

def _jax_pieces(tree, chunk_bytes):
    """The reference layout's chunks as (leaf path, start, n) triples."""
    layout = JChunkLayout.build(tree, chunk_bytes)
    paths = ["/".join(str(k.key) for k in kp)
             for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    return [tuple((paths[li], s, n) for li, s, n in c) for c in layout.chunks]


def _pieces(layout):
    return [tuple((layout.paths[li], s, n) for li, s, n in c)
            for c in layout.chunks]


@pytest.mark.parametrize("chunk_bytes", [1 << 10, 3000, 1 << 16])
def test_chunk_layout_equals_the_references(chunk_bytes):
    """The bridged llama2-smoke params (insertion order differs from jax's
    sorted order) and a mixed-dtype tree: the port's chunks cover the
    reference's elements, chunk for chunk."""
    npp = _np_params("llama2-7b")
    trees = [(jax.tree.map(jnp.asarray, npp), bridge.to_torch(npp))]
    mixed = {"z": np.arange(300, dtype=np.float32),
             "b": {"y": np.ones((7, 5), np.float32), "a": np.float32(2.0)},
             "h": np.arange(40, dtype=np.float32).reshape(8, 5)}
    jmixed = {"z": jnp.asarray(mixed["z"], jnp.bfloat16),
              "b": {"y": jnp.asarray(mixed["b"]["y"]),
                    "a": jnp.asarray(mixed["b"]["a"])},
              "h": jnp.asarray(mixed["h"], jnp.bfloat16)}
    tmixed = {"z": torch.tensor(mixed["z"]).bfloat16(),
              "b": {"y": torch.tensor(mixed["b"]["y"]),
                    "a": torch.tensor(mixed["b"]["a"])},
              "h": torch.tensor(mixed["h"]).bfloat16()}
    trees.append((jmixed, tmixed))
    for jtree, ttree in trees:
        layout = ChunkLayout.build(ttree, chunk_bytes)
        assert _pieces(layout) == _jax_pieces(jtree, chunk_bytes)
        back = layout.combine([layout.extract(ttree, i)
                               for i in range(layout.num_chunks)])
        assert list(flatten_with_paths(back)) == \
            list(flatten_with_paths(ttree))      # the tree's own order


# ---------------------------------------- properties (seeded random trees)

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8]


def _spec(seed):
    """A random tree spec: 1-6 leaves of rank 0-3 (dims 1-5), mixed
    dtypes, a chunk size in [4, 257] and a depth in [2, 5]."""
    rng = np.random.default_rng(seed)
    leaves = [(tuple(int(d) for d in rng.integers(1, 6, rng.integers(0, 4))),
               _DTYPES[rng.integers(len(_DTYPES))])
              for _ in range(rng.integers(1, 7))]
    return leaves, int(rng.integers(4, 258)), int(rng.integers(2, 6))


def _build(spec, offset=0.0):
    """A tree whose elements are distinct within each leaf (a chunk in the
    wrong slot cannot reassemble bit-equal by accident); ``offset`` makes a
    congruent tree with other values."""
    tree, pos = {}, 0
    for i, (shape, dt) in enumerate(spec):
        n = int(np.prod(shape)) if shape else 1
        if dt == torch.int8:
            vals = (np.arange(pos, pos + n) + int(offset)) % 127
        else:
            vals = np.arange(n) + (1.0 if offset else 0.5)
        tree[f"leaf{i}_{str(dt)[6:]}"] = torch.tensor(
            vals.reshape(shape)).to(dt)
        pos += n
    return tree


def _assert_trees_bitequal(a, b, err=""):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert list(fa) == list(fb), err
    for p in fa:
        assert fa[p].dtype == fb[p].dtype and fa[p].shape == fb[p].shape, err
        assert torch.equal(fa[p], fb[p]), f"{err} {p}"


@pytest.mark.parametrize("seed", range(8))
def test_chunks_partition_bytes_exactly_once(seed):
    spec, chunk_bytes, _ = _spec(seed)
    tree = _build(spec)
    layout = ChunkLayout.build(tree, chunk_bytes)
    flat = [flatten_with_paths(tree)[p] for p in layout.paths]
    covered = [np.zeros(int(t.numel()), np.int32) for t in flat]
    for pieces in layout.chunks:
        dtypes = {flat[li].dtype for li, _, _ in pieces}
        assert len(dtypes) == 1, "a chunk mixes dtype buckets"
        itemsize = flat[pieces[0][0]].element_size()
        if chunk_bytes >= itemsize:
            assert sum(n for _, _, n in pieces) * itemsize <= chunk_bytes
        for li, start, n in pieces:
            assert n >= 1
            covered[li][start:start + n] += 1
    assert all((c == 1).all() for c in covered)


@pytest.mark.parametrize("seed", range(8))
def test_extract_combine_roundtrip_bit_equal(seed):
    spec, chunk_bytes, _ = _spec(100 + seed)
    tree, other = _build(spec), _build(spec, offset=3.0)
    layout = ChunkLayout.build(tree, chunk_bytes)
    for t, err in ((tree, "base"), (other, "congruent")):
        back = layout.combine([layout.extract(t, i)
                               for i in range(layout.num_chunks)])
        _assert_trees_bitequal(t, back, err=err)


@pytest.mark.parametrize("seed", range(8))
def test_stream_residency_bounded_and_lossless(seed):
    spec, chunk_bytes, depth = _spec(200 + seed)
    tree, other = _build(spec), _build(spec, offset=3.0)
    layout = ChunkLayout.build(tree, min(chunk_bytes, 129))
    stream = ChunkStream(layout, depth=depth, device="cpu")
    stream.begin(tree, other)
    for i in range(layout.num_chunks):
        a, b = stream.fetch(i)
        stream.offload(i, (a, b))       # the identity update
    out_a, out_b = stream.end()
    _assert_trees_bitequal(tree, out_a, err="tree A")
    _assert_trees_bitequal(other, out_b, err="tree B")
    assert stream.stats.max_resident <= depth
    assert stream.stats.prefetch_misses == 0
    assert stream.stats.offloads == layout.num_chunks
