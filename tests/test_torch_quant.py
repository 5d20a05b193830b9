"""The port's codecs and dequant matmul, held against the JAX package on the
CPU.

- ``repro_torch.dist.quant`` encodes to the reference's codes and scales
  bit for bit (int8 and NF4; 2-d and stacked 3-d leaves; ragged rows, odd
  widths; fp32 and bf16), and decodes to the same bits;
- a layer view of a stacked record decodes to
  ``repro.dist.quant.dequantize_leaf(stacked)[i]`` bit for bit (the scale
  tile rows a bare slice would lose); so do a row of a 2-d stack and a
  gather of embedding rows;
- ``kernels.ref.dequant_matmul_ref`` against the reference: for 2-d leaves
  the Pallas kernel ``repro.kernels.ops.dequant_matmul`` in interpret
  mode, for layer views the reference's plain product on the decoded
  layer.  Tolerance: fp32 rtol 1e-5 / atol 1e-6 (one decode, then fp32
  sums in other orders by XLA and PyTorch); bf16 outputs one bf16 rounding
  apart (rtol 2**-7, atol 1e-2);
- the wrapper's backward is the gradient of the plain decode-then-matmul;
  its CPU dispatch and its shape checks;
- records through ``split_params``, ``tree_cast`` and the bridge.

The numbers are made from numpy seeds and cross as numpy arrays.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.dist import quant as JQ  # noqa: E402
from repro.kernels.ops import dequant_matmul as jax_dequant_matmul  # noqa: E402
from repro.kernels.ref import dequant_matmul_ref as jax_dequant_ref  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import flatten_with_paths, tree_cast  # noqa: E402
from repro_torch.core import Group, merge_params, split_params  # noqa: E402
from repro_torch.dist import quant as Q  # noqa: E402
from repro_torch.kernels import dequant_matmul as DM  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.base import LayerStack, layer_at  # noqa: E402

FMTS = ["int8", "nf4"]
DTYPES = ["float32", "bfloat16"]
# 2-d and stacked leaves: lane-aligned, ragged rows and lanes, odd widths
SHAPES = [(4, 128), (5, 131), (7, 1), (3, 20, 300), (2, 9, 257), (2, 17, 1)]


def _weights(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0] *= 50                          # one large lane per row
    x[..., :3, :] *= 1e-3                    # and some small tiles
    return x


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array of ``dtype``."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


# ------------------------------------------------------------------ codecs

@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FMTS)
def test_codec_matches_reference_bit_for_bit(fmt, dtype, shape):
    jx, tx = _pair(_weights(shape), dtype)
    want, got = JQ.quantize_leaf(jx, fmt), Q.quantize_leaf(tx, fmt)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert tuple(got["t"].shape) == tuple(want["t"].shape)
    assert got["t"].dtype == tx.dtype
    assert Q.quant_shape(got) == JQ.quant_shape(want) == shape
    assert Q.quant_format(got) == fmt
    np.testing.assert_array_equal(_np(Q.dequantize_leaf(got)),
                                  _np(JQ.dequantize_leaf(want)))
    assert Q.dequantize_leaf(got).dtype == tx.dtype


@pytest.mark.parametrize("fmt", FMTS)
def test_layer_views_decode_as_the_reference(fmt):
    """Layer i of a stacked record decodes to the reference's whole-leaf
    decode at i — a bare ``q[i]``/``s[i]`` record would decode with tile
    rows 1, against a scale grid of tile rows 8, and cannot."""
    jx, tx = _pair(_weights((3, 20, 300), seed=1), "float32")
    full = _np(JQ.dequantize_leaf(JQ.quantize_leaf(jx, fmt)))
    rec = Q.quantize_leaf(tx, fmt)
    for i in range(3):
        view = Q.layer_of(rec, i)
        assert isinstance(view, Q.QuantView) and view.tile_rows == 8
        assert view.shape == (20, 300) and view.fmt == fmt
        np.testing.assert_array_equal(view.decode().numpy(), full[i])
    bare = {"q": rec["q"][1], "s": rec["s"][1], "t": rec["t"][1:2]}
    with pytest.raises(RuntimeError):
        Q.dequantize_leaf(bare)


@pytest.mark.parametrize("fmt", FMTS)
def test_rows_and_gathers_decode_as_the_reference(fmt):
    jx, tx = _pair(_weights((6, 300), seed=2), "bfloat16")
    full = _np(JQ.dequantize_leaf(JQ.quantize_leaf(jx, fmt)))
    rec = Q.quantize_leaf(tx, fmt)
    for i in range(6):
        row = Q.layer_of(rec, i)
        assert row.dtype == torch.bfloat16 and row.shape == (300,)
        np.testing.assert_array_equal(_np(row), full[i])
    idx = torch.tensor([[5, 0, 0], [2, 3, 5]])
    np.testing.assert_array_equal(_np(Q.gather_rows(rec, idx)),
                                  full[idx.numpy()])
    np.testing.assert_array_equal(_np(Q.view_of(rec).decode()), full)


def test_byte_and_size_accounting_match_the_reference():
    x = _weights((3, 20, 300))
    for fmt in FMTS:
        tree = {"a": Q.quantize_leaf(torch.from_numpy(x), fmt),
                "b": torch.zeros(7)}
        jtree = {"a": JQ.quantize_leaf(jnp.asarray(x), fmt),
                 "b": jnp.zeros(7)}
        assert Q.tree_logical_size(tree) == JQ.tree_logical_size(jtree)
        assert Q.quant_bytes(tree) == JQ.quant_bytes(jtree)
        assert Q.quant_leaf_bytes(x.shape, 4, fmt) == \
            JQ.quant_leaf_bytes(x.shape, 4, fmt)
    with pytest.raises(ValueError, match="unknown quant format"):
        Q.quantize_leaf(torch.zeros(2, 3), "int4")


def test_quantize_tree_passes_other_leaves_and_records():
    tree = {"w": torch.ones(4, 130), "v": torch.ones(5),
            "i": torch.ones(3, 3, dtype=torch.int32)}
    enc = Q.quantize_tree(tree, "nf4")
    assert Q.is_quantized(enc["w"])
    assert enc["v"] is tree["v"] and enc["i"] is tree["i"]
    again = Q.quantize_tree(enc, "int8")          # records pass through
    assert again["w"]["q"] is enc["w"]["q"]
    dec = Q.dequantize_tree(enc)
    assert torch.equal(dec["w"], tree["w"]) and dec["v"] is tree["v"]


# ----------------------------------------------------------- dequant matmul

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(16, 256, 128), (8, 96, 200),
                                   (4, 64, 384), (3, 33, 7)])
@pytest.mark.parametrize("fmt", FMTS)
def test_plain_dequant_matmul_matches_the_pallas_kernel(fmt, m, k, n, dtype):
    """2-d leaves: the Pallas kernel in interpret mode."""
    jw, tw = _pair(_weights((k, n), seed=3), dtype)
    jx, tx = _pair(np.random.default_rng(4).standard_normal(
        (m, k)).astype(np.float32), dtype)
    want = jax.jit(jax_dequant_matmul)(jx, JQ.quantize_leaf(jw, fmt))
    got = ref.dequant_matmul_ref(tx, Q.view_of(Q.quantize_leaf(tw, fmt)))
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2.0 ** -7, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("fmt", FMTS)
def test_plain_dequant_matmul_of_layer_views(fmt):
    """Stacked leaves: the reference's plain product on the decoded layer
    (the Pallas kernel takes 2-d leaves only)."""
    w = _weights((3, 40, 200), seed=5)
    x = np.random.default_rng(6).standard_normal((12, 40)).astype(np.float32)
    jrec = JQ.quantize_leaf(jnp.asarray(w), fmt)
    rec = Q.quantize_leaf(torch.from_numpy(w), fmt)
    for i in range(3):
        want = jnp.dot(jnp.asarray(x), JQ.dequantize_leaf(jrec)[i])
        got = DM.dequant_matmul(torch.from_numpy(x), Q.layer_of(rec, i))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    # the reference's own plain version agrees on a 2-d leaf
    jrec2 = JQ.quantize_leaf(jnp.asarray(w[0]), fmt)
    want2 = jax_dequant_ref(jnp.asarray(x), jrec2)
    got2 = ref.dequant_matmul_ref(
        torch.from_numpy(x), Q.view_of(Q.quantize_leaf(
            torch.from_numpy(w[0]), fmt)))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FMTS)
def test_dequant_matmul_backward_is_the_plain_gradient(fmt, dtype):
    """dL/dx through the wrapper equals the gradient of the plain
    decode-then-matmul (``x @ dequant(W).astype(x.dtype)``); the codes get
    none."""
    dt = getattr(torch, dtype)
    rec = Q.quantize_leaf(torch.from_numpy(_weights((2, 24, 136), 7)).to(dt),
                          fmt)
    view = Q.layer_of(rec, 1)
    rng = np.random.default_rng(8)
    x0 = torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(
        np.float32)).to(dt)
    r = torch.from_numpy(rng.standard_normal((2, 5, 136)).astype(
        np.float32)).to(dt)
    from repro_torch.models.layers import linear
    x = x0.clone().requires_grad_(True)
    (linear(x, view).float() * r.float()).sum().backward()
    y = x0.clone().requires_grad_(True)
    (y @ view.decode().to(dt)).float().mul(r.float()).sum().backward()
    assert x.grad.dtype == dt
    np.testing.assert_allclose(_np(x.grad), _np(y.grad), rtol=1e-5,
                               atol=1e-6)
    assert not view.q.requires_grad and rec["q"].grad is None


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_shapes():
    rec = Q.quantize_leaf(torch.randn(2, 16, 130), "nf4")
    view = Q.layer_of(rec, 0)
    x = torch.randn(3, 16)
    before = DM.dequant_matmul.launches
    torch.testing.assert_close(DM.dequant_matmul(x, view),
                               ref.dequant_matmul_ref(x, view), rtol=0,
                               atol=0)
    assert DM.dequant_matmul.launches == before      # no kernel on the CPU
    with pytest.raises(ValueError, match="no kernel for devices"):
        DM.dequant_matmul(x.to("meta"), view)
    with pytest.raises(ValueError, match="does not contract"):
        DM._check(torch.randn(3, 15), view)
    with pytest.raises(ValueError, match="do not encode"):
        DM._check(x, Q.QuantView(view.q, view.s, 1, view.shape, view.dtype))
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        DM._check(x.half(), view)


# ------------------------------------------------------- records in trees

def test_records_slice_and_merge_like_the_leaves_they_encode():
    """``split_params`` slices a record's q, s and t on dim 0 as the
    reference does; ``merge_params`` presents the pieces as one
    ``LayerStack`` whose layers are views (matrices) and decoded rows."""
    w = torch.from_numpy(_weights((4, 16, 130), 9))
    n = torch.from_numpy(_weights((4, 130), 10))
    params = Q.quantize_tree({"layers": {"w": w, "n": n},
                              "embed": {"tok": torch.randn(11, 130)}}, "int8")
    group = Group(index=2, units=(), dense_keys=(),
                  stacked_ranges=(("layers", 1, 3),))
    active, frozen = split_params(params, group)
    assert tuple(active["layers"]["w"]["q"].shape) == (2, 16, 130)
    assert tuple(active["layers"]["w"]["s"].shape) == (2, 2, 2)
    assert tuple(active["layers"]["n"]["t"].shape) == (2, 0, 130)
    assert tuple(frozen["layers__post"]["w"]["q"].shape) == (1, 16, 130)
    merged = merge_params(active, frozen, group)
    assert isinstance(merged["layers"], LayerStack)
    full_w = Q.dequantize_leaf(params["layers"]["w"])
    full_n = Q.dequantize_leaf(params["layers"]["n"])
    for i in range(4):
        lay = layer_at(merged["layers"], i)
        assert torch.equal(lay["w"].decode(), full_w[i])
        assert torch.equal(lay["n"], full_n[i])
    assert Q.tree_logical_size(active) == 2 * 16 * 130 + 2 * 130


def test_tree_cast_leaves_records_alone():
    rec = Q.quantize_leaf(torch.randn(3, 130, dtype=torch.bfloat16), "nf4")
    out = tree_cast({"r": rec, "v": torch.ones(3)}, torch.float32)
    assert out["r"] is rec and out["r"]["t"].dtype == torch.bfloat16


@pytest.mark.parametrize("fmt", FMTS)
def test_records_cross_the_bridge(fmt):
    """int8/uint8 codes cross as numpy copies and a bf16 template keeps
    its dtype, both ways."""
    jrec = JQ.quantize_leaf(jnp.asarray(_weights((2, 9, 257))).astype(
        jnp.bfloat16), fmt)
    rec = bridge.to_torch(jax.tree.map(np.asarray, jrec))
    assert rec["q"].dtype == (torch.int8 if fmt == "int8" else torch.uint8)
    assert rec["t"].dtype == torch.bfloat16
    assert tuple(rec["t"].shape) == (2, 0, 257)
    np.testing.assert_array_equal(_np(Q.dequantize_leaf(rec)),
                                  _np(JQ.dequantize_leaf(jrec)))
    back = bridge.to_numpy(rec, bf16_dtype=jnp.bfloat16)
    for key in ("q", "s", "t"):
        assert back[key].dtype == np.asarray(jrec[key]).dtype
        np.testing.assert_array_equal(back[key], np.asarray(jrec[key]))
    assert set(flatten_with_paths(rec)) == {"q", "s", "t"}
