"""The port's attention kernels, held against the JAX package on the CPU.

On CPU tensors each wrapper in ``repro_torch.kernels.flash_attention``
runs its plain PyTorch version (``repro_torch.kernels.ref``); those are
held here against the JAX oracles at fp32 (atol = rtol = 1e-5: both sides
compute an fp32 softmax over the same fp32 scores, so only summation order
differs):

- prefill: ``chunked_causal_attention(k_valid=)`` (the serving prefill's
  own attention) at valid rows, and ``kernels.ref.flash_attention_ref``;
- contiguous decode: ``kernels.ref.flash_decode_ref`` over several
  ``starts``/``lengths`` windows;
- paged decode: ``paged_flash_decode_pallas(interpret=True)``.

The CUDA kernels themselves run only on a card, where ``chip_smoke.py``
holds each against its plain version at the serving shapes (this suite's
conftest imports JAX, which the card's machine does not need to have).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense_cfg  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import paged_flash_decode_pallas  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import flash_attention as K  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

# (H, KV, hd) of the three configs the port's tests use
CFGS = {
    "tiny": tiny_dense_cfg(),
    "llama2-smoke": jax_get_config("llama2-7b", smoke=True),
    "qwen2-smoke": jax_get_config("qwen2-0.5b", smoke=True),
}


def _heads(name):
    c = CFGS[name]
    return c.n_heads, c.kv_heads, c.head_dim


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_plain_matches_jax(name):
    """Causal AND key-valid masking, GQA by index: valid rows equal JAX's
    chunked prefill attention; with no pad, every row equals
    ``flash_attention_ref`` on repeated kv."""
    h, kvh, hd = _heads(name)
    b, s = 3, 32
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, b, s, h, hd), _rand(rng, b, s, kvh, hd), \
        _rand(rng, b, s, kvh, hd)
    pad = np.array([0, 5, 17], np.int32)
    n_rep = h // kvh
    kk = np.repeat(k, n_rep, axis=2)
    vv = np.repeat(v, n_rep, axis=2)
    k_valid = np.arange(s)[None, :] >= pad[:, None]
    want = np.asarray(JL.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv), 16, 16,
        k_valid=jnp.asarray(k_valid)))
    got = K.flash_attention(_t(q), _t(k), _t(v), starts=_t(pad)).numpy()
    for i in range(b):
        np.testing.assert_allclose(got[i, pad[i]:], want[i, pad[i]:], **TOL)
    want_np = np.asarray(jax_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv)))
    got_np = K.flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got_np, want_np, **TOL)


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("window", [
    ([0, 0, 0], [40, 1, 23]),          # no pad; a one-key row
    ([3, 0, 39], [40, 17, 40]),        # pad; a window of the last key only
    (None, [7, 40, 32]),               # starts=None means 0
])
def test_decode_plain_matches_jax(name, window):
    h, kvh, hd = _heads(name)
    starts, lengths = window
    b, s = 3, 40
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, b, h, hd), _rand(rng, b, s, kvh, hd), \
        _rand(rng, b, s, kvh, hd)
    n_rep = h // kvh
    lengths = np.asarray(lengths, np.int32)
    st = None if starts is None else np.asarray(starts, np.int32)
    want = np.asarray(jax_ref.flash_decode_ref(
        jnp.asarray(q), jnp.asarray(np.repeat(k, n_rep, axis=2)),
        jnp.asarray(np.repeat(v, n_rep, axis=2)), jnp.asarray(lengths),
        None if st is None else jnp.asarray(st)))
    got = K.flash_decode(_t(q), _t(k), _t(v), _t(lengths),
                         None if st is None else _t(st)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", list(CFGS))
def test_paged_plain_matches_pallas_interpret(name):
    """Shuffled pages, one idle row on the null page, windows that start
    mid-page: the plain paged version equals the Pallas kernel run in
    interpret mode."""
    h, kvh, hd = _heads(name)
    b, bs, max_blocks = 3, 8, 4
    n_blocks = 1 + b * max_blocks
    rng = np.random.default_rng(3)
    q = _rand(rng, b, h, hd)
    k_pool = _rand(rng, n_blocks, bs, kvh, hd)
    v_pool = _rand(rng, n_blocks, bs, kvh, hd)
    tables = (rng.permutation(n_blocks - 1) + 1)[:b * max_blocks]
    tables = tables.reshape(b, max_blocks).astype(np.int32)
    tables[2] = 0                                  # idle slot: null page
    lengths = np.array([29, 9, 1], np.int32)
    starts = np.array([3, 8, 0], np.int32)
    want = np.asarray(paged_flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(starts),
        interpret=True))
    got = K.paged_flash_decode(_t(q), _t(k_pool), _t(v_pool), _t(tables),
                               _t(lengths), _t(starts)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_wrappers_take_plain_version_and_count_nothing():
    """On CPU tensors the wrappers return the plain versions exactly and
    leave every ``launches`` counter at 0."""
    K.reset_launches()
    rng = np.random.default_rng(4)
    q, k, v = _t(_rand(rng, 2, 16, 4, 16)), _t(_rand(rng, 2, 16, 2, 16)), \
        _t(_rand(rng, 2, 16, 2, 16))
    starts = torch.tensor([0, 3], dtype=torch.int32)
    assert torch.equal(K.flash_attention(q, k, v, starts),
                       tref.flash_attention_ref(q, k, v, starts))
    lengths = torch.tensor([16, 9], dtype=torch.int32)
    assert torch.equal(K.flash_decode(q[:, 0], k, v, lengths, starts),
                       tref.flash_decode_ref(q[:, 0], k, v, lengths, starts))
    pools = k.reshape(4, 8, 2, 16)
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    assert torch.equal(
        K.paged_flash_decode(q[:, 0], pools, pools, tables, lengths, starts),
        tref.paged_flash_decode_ref(q[:, 0], pools, pools, tables, lengths,
                                    starts))
    assert [f.launches for f in K.KERNELS] == [0, 0, 0]


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.flash_attention(q, q, q)


def test_bf16_plain_versions_track_fp32():
    """At bf16 the plain versions round scores and probabilities as JAX
    does; they stay within bf16 rounding of the fp32 result."""
    rng = np.random.default_rng(5)
    q, k, v = _t(_rand(rng, 2, 32, 4, 64)), _t(_rand(rng, 2, 32, 2, 64)), \
        _t(_rand(rng, 2, 32, 2, 64))
    starts = torch.tensor([0, 9], dtype=torch.int32)
    lo = K.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), starts)
    hi = K.flash_attention(q, k, v, starts)
    assert lo.dtype == torch.bfloat16
    np.testing.assert_allclose(lo[1, 9:].float().numpy(), hi[1, 9:].numpy(),
                               atol=5e-2, rtol=5e-2)
