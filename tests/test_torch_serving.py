"""The port's serving slice, held against the JAX package on the CPU.

Same weights (JAX-initialised, with random norm scales and qkv biases so
those paths count, bridged to torch), same numpy-made tokens:

- ``prefill``, several ``decode_step``s and ``paged_decode_step``: logits
  within 1e-4 of JAX's at fp32 (the port's plain attention does a full
  fp32 softmax where JAX's prefill does an online one, so results differ
  in summation order only), and the caches equal at valid rows;
- both engines: the JAX engine's greedy tokens, token for token, on the
  repo's mixed-length acceptance trace;
- the bridge round-trips fp32 and bf16 bit for bit;
- hygiene: the port imports neither ``jax`` nor ``repro``; entry points
  refuse a missing card unless asked for the CPU; a request that can never
  be admitted raises instead of spinning.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_dense_cfg  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import ContinuousServeEngine as JaxContinuous  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServe  # noqa: E402
from repro.serve.kv_cache import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro.serve.scheduler import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import (flatten_with_paths,  # noqa: E402
                                       unflatten_from_paths)
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import get_family  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.serve.scheduler import ServeRequest  # noqa: E402

_REPO = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = torch.float32


def _jax_cfg(name):
    if name == "tiny":
        return tiny_dense_cfg()
    return jax_get_config(name, smoke=True)


def _torch_cfg(jcfg):
    """The same config as the port's own ArchConfig (field for field)."""
    import dataclasses
    return tbase.ArchConfig(**dataclasses.asdict(jcfg))


CFG_NAMES = ["tiny", "llama2-7b", "qwen2-0.5b"]
_PARAMS = {}


def _params(name):
    """(JAX params, torch params): the JAX ``init`` tree's shapes, filled
    from a numpy seed (dense weights N(0,1)/sqrt(fan_in), embedding 0.02,
    norm scales and qkv biases random too so those paths count), handed to
    JAX as arrays and to torch through the bridge.  Cached per config."""
    if name not in _PARAMS:
        jcfg = _jax_cfg(name)
        shapes = flatten_with_paths(jax.eval_shape(
            lambda: JT.init(jcfg, jax.random.PRNGKey(0))))
        rng = np.random.default_rng(7)
        flat = {}
        for path, sd in shapes.items():
            z = rng.standard_normal(sd.shape).astype(np.float32)
            leaf = path.split("/")[-1]
            if leaf in ("scale",):
                z = 1 + 0.1 * z
            elif leaf in ("bq", "bk", "bv"):
                z = 0.1 * z
            elif leaf == "tok":
                z = 0.02 * z
            else:
                z = z / np.sqrt(sd.shape[-2])
            flat[path] = z.astype(np.float32)
        np_tree = unflatten_from_paths(flat)
        _PARAMS[name] = (jax.tree.map(jnp.asarray, np_tree),
                         bridge.to_torch(np_tree))
    return _PARAMS[name]


def _prompts(plens, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in plens]


# ------------------------------------------------------------ model level

@pytest.mark.parametrize("name", CFG_NAMES)
def test_prefill_and_decode_logits_match_jax(name):
    jcfg = _jax_cfg(name)
    cfg = _torch_cfg(jcfg)
    jp, tp = _params(name)
    b, s, max_len = 3, 16, 24
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    pad = np.array([0, 4, 11], np.int32)
    jcache = JT.init_cache(jcfg, b, max_len, dtype=jnp.float32)
    jl, jcache = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks),
                                       "pad": jnp.asarray(pad)}, jcache,
                            compute_dtype=jnp.float32)
    tcache = TT.init_cache(cfg, b, max_len, dtype=F32)
    tl, tcache = TT.prefill(cfg, tp, {"tokens": torch.from_numpy(toks).long(),
                                      "pad": torch.from_numpy(pad)}, tcache,
                            compute_dtype=F32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(b):           # cache rows agree at valid positions only
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tcache[key][:, i, pad[i]:s].numpy(),
                np.asarray(jcache[key])[:, i, pad[i]:s], **TOL)
    for step in range(2):
        nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        jl, jcache = JT.decode_step(jcfg, jp, jcache, jnp.asarray(nxt),
                                    compute_dtype=jnp.float32)
        tl, tcache = TT.decode_step(cfg, tp, tcache,
                                    torch.from_numpy(nxt).long(),
                                    compute_dtype=F32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")
    assert tcache["pos"] == int(jcache["pos"]) == s + 2


@pytest.mark.parametrize("name", CFG_NAMES)
def test_paged_decode_logits_and_pools_match_jax(name):
    """Random pools, shuffled tables, an idle slot on the null page."""
    jcfg = _jax_cfg(name)
    cfg = _torch_cfg(jcfg)
    jp, tp = _params(name)
    b, bs, max_blocks = 3, 8, 4
    n_blocks = 1 + b * max_blocks
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, n_blocks, bs, cfg.kv_heads, cfg.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    tables = (rng.permutation(n_blocks - 1) + 1).reshape(b, max_blocks)
    tables = tables.astype(np.int32)
    tables[1] = 0                                  # idle slot
    lengths = np.array([21, 0, 7], np.int32)
    pad = np.array([5, 0, 2], np.int32)
    toks = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    jl, jk, jv = JT.paged_decode_step(
        jcfg, jp, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(pad), jnp.asarray(toks),
        compute_dtype=jnp.float32)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, tk, tv = TT.paged_decode_step(
        cfg, tp, tk, tv, torch.from_numpy(tables), torch.from_numpy(lengths),
        torch.from_numpy(pad), torch.from_numpy(toks).long(),
        compute_dtype=F32)
    live = [0, 2]                   # the idle slot's logits are garbage
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **TOL)
    # every page but the null page (which idle slots scribble on)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], **TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], **TOL)


def test_pad_valid_matches_jax():
    jcfg = tiny_dense_cfg()
    pad = np.array([0, 3, 9], np.int32)
    want = np.asarray(JT._pad_valid(jcfg, jnp.asarray(pad), 12))
    got = TT._pad_valid(_torch_cfg(jcfg), torch.from_numpy(pad), 12).numpy()
    assert np.array_equal(got, want)


# ------------------------------------------------------------ engines

PLENS = [5, 12, 9, 3, 14, 7, 11]
MAX_NEWS = [6, 3, 8, 1, 5, 7, 4]


def test_engines_match_jax_on_the_acceptance_trace():
    """The JAX continuous engine's tokens (which its own suite holds equal
    to serial fixed-batch decoding) are reproduced token for token by the
    port's serial ServeEngine and by its ContinuousServeEngine: 7 mixed
    requests through 3 slots, refills > 0, every page returned."""
    jcfg = tiny_dense_cfg()
    cfg = _torch_cfg(jcfg)
    jp, tp = _params("tiny")
    prompts = _prompts(PLENS, cfg.vocab, seed=10)
    jeng = JaxContinuous(jcfg, jp, slots=3, block_size=8, prefill_bucket=16)
    jreqs = [JaxRequest(prompt=list(map(int, p)), max_new_tokens=m)
             for p, m in zip(prompts, MAX_NEWS)]
    jeng.run(jreqs)
    want = [r.out_tokens for r in jreqs]

    serial = TE.ServeEngine(cfg, tp, max_len=64, batch=1, device="cpu")
    assert [serial.generate([p], m)[0]
            for p, m in zip(prompts, MAX_NEWS)] == want

    eng = TE.ContinuousServeEngine(cfg, tp, slots=3, block_size=8,
                                   prefill_bucket=16, device="cpu")
    reqs = [ServeRequest(prompt=list(map(int, p)), max_new_tokens=m)
            for p, m in zip(prompts, MAX_NEWS)]
    eng.run(reqs)
    assert [r.out_tokens for r in reqs] == want
    stats = eng.scheduler.stats
    assert stats.n_finished == len(PLENS)
    assert stats.n_refills > 0 and stats.peak_active == 3
    assert eng.cache.occupancy() == 0.0
    assert len(eng.decode_seconds) == eng.steps > 0


@pytest.mark.parametrize("name", ["llama2-7b", "qwen2-0.5b"])
def test_batched_generate_matches_jax(name):
    """Mixed-length left-padded batch, one extra idle row (the tiny config
    is covered by the acceptance trace above)."""
    jcfg = _jax_cfg(name)
    cfg = _torch_cfg(jcfg)
    jp, tp = _params(name)
    prompts = _prompts([4, 13, 9], cfg.vocab, seed=20)
    want = JaxServe(jcfg, jp, max_len=32, batch=4).generate(
        [jnp.asarray(p) for p in prompts], max_new_tokens=6)
    got = TE.ServeEngine(cfg, tp, max_len=32, batch=4,
                         device="cpu").generate(prompts, max_new_tokens=6)
    assert got == want


def test_from_train_state_handoff():
    class State:                      # anything with .params
        def __init__(self, params):
            self.params = params

    cfg = _torch_cfg(tiny_dense_cfg())
    _, tp = _params("tiny")
    prompts = _prompts([8, 5], cfg.vocab, seed=3)
    a = TE.ServeEngine(cfg, tp, max_len=32, batch=2,
                       device="cpu").generate(prompts, 4)
    b = TE.ServeEngine.from_train_state(cfg, State(tp), max_len=32, batch=2,
                                        device="cpu").generate(prompts, 4)
    c = TE.ServeEngine.from_train_state(cfg, {"params": tp}, max_len=32,
                                        batch=2, device="cpu").generate(
                                            prompts, 4)
    assert a == b == c
    ceng = TE.ContinuousServeEngine.from_train_state(
        cfg, State(tp), slots=2, block_size=8, device="cpu")
    reqs = [ServeRequest(prompt=list(map(int, p)), max_new_tokens=4)
            for p in prompts]
    ceng.run(reqs)
    assert [r.out_tokens for r in reqs] == a


def test_never_admittable_request_raises():
    """A 100-token prompt with the default bucket 32 / block 16 needs more
    pages than a slot's table holds: the JAX engine spins on it forever,
    the port raises before serving anything."""
    cfg = _torch_cfg(tiny_dense_cfg())
    _, tp = _params("tiny")
    eng = TE.ContinuousServeEngine(cfg, tp, device="cpu")
    req = ServeRequest(prompt=list(range(100)), max_new_tokens=4)
    with pytest.raises(ValueError, match="pages"):
        eng.run([req])
    assert eng.steps == 0 and not eng.scheduler.queue


def test_default_device_needs_a_card():
    """Entry points default to the card; without one they raise rather
    than quietly serving on the CPU."""
    cfg = _torch_cfg(tiny_dense_cfg())
    _, tp = _params("tiny")
    if torch.cuda.is_available():
        assert TE.ServeEngine(cfg, tp).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.ServeEngine(cfg, tp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.ContinuousServeEngine(cfg, tp)


# ------------------------------------------------------------ pieces

def test_paged_cache_roundtrip_matches_jax():
    jcfg = tiny_dense_cfg()
    cfg = _torch_cfg(jcfg)
    caches = [JaxPagedKVCache(jcfg, n_blocks=7, block_size=8, slots=2,
                              max_blocks_per_slot=4),
              PagedKVCache(cfg, n_blocks=7, block_size=8, slots=2,
                           max_blocks_per_slot=4)]
    rng = np.random.default_rng(4)
    k = rng.standard_normal((cfg.n_layers, 17, cfg.kv_heads, cfg.head_dim))
    k = k.astype(np.float32)
    for c, conv in zip(caches, (jnp.asarray, torch.from_numpy)):
        assert c.admit(0, budget_tokens=17)          # 3 pages
        assert not c.admit(1, budget_tokens=31)      # pool exhausted
        assert not c.admit(1, budget_tokens=100)     # wider than a table
        c.write_prefill(0, conv(k), conv(k * 0.5), pad=2)
        assert int(c.lengths[0]) == 17 and int(c.pads[0]) == 2
    (jk, jv), (tk, tv) = (c.gather_contiguous(0) for c in caches)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(caches[1].block_tables.numpy(),
                          np.asarray(caches[0].block_tables))
    caches[1].release(0)
    assert caches[1].occupancy() == 0.0


def test_tree_helpers_match_jax():
    from repro.common import pytree as jpt
    from repro_torch.common import pytree as tpt
    jp, tp = _params("qwen2-0.5b")
    assert tpt.tree_size(tp) == jpt.tree_size(jp)
    assert tpt.tree_bytes(tp) == jpt.tree_bytes(jp)
    jb = jpt.tree_cast(jp, jnp.bfloat16)
    tb = tpt.tree_cast(tp, torch.bfloat16)
    assert tpt.tree_bytes(tb) == jpt.tree_bytes(jb)
    got = flatten_with_paths(bridge.to_numpy(tb, bf16_dtype=jnp.bfloat16))
    want = flatten_with_paths(jax.tree.map(np.asarray, jb))
    assert list(got) == list(jpt.flatten_with_paths(jb))
    for path in want:
        assert np.array_equal(got[path].view(np.uint16),
                              want[path].view(np.uint16)), path


def test_greedy_sample_ties_take_the_first_index():
    logits = np.array([[0.5, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]],
                      np.float32)
    got = TE.greedy_sample(torch.from_numpy(logits)).numpy()
    assert got.tolist() == np.asarray(jnp.argmax(logits, axis=-1)).tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_roundtrip_is_bit_exact(dtype):
    jp, _ = _params("qwen2-0.5b")
    jtree = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), jp)
    back = bridge.to_numpy(bridge.to_torch(jtree), bf16_dtype=jnp.bfloat16)
    want = flatten_with_paths(jax.tree.map(np.asarray, jtree))
    got = flatten_with_paths(back)
    assert got.keys() == want.keys()
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        assert np.array_equal(got[path].view(np.uint8),
                              want[path].view(np.uint8)), path


def test_registry_resolves_ported_archs_only():
    assert get_config("llama2-7b").n_layers == 32
    assert get_config("qwen2-0.5b", smoke=True).name == "qwen2-smoke"
    assert get_config("xlstm-1.3b").family == "xlstm"
    with pytest.raises(ValueError, match="not ported yet"):
        get_config("no-such-arch")
    xlstm = _torch_cfg(jax_get_config("xlstm-1.3b", smoke=True))
    assert get_family(xlstm).__name__ == "repro_torch.models.xlstm"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        get_family(dataclasses.replace(xlstm, family="no-such-family"))


def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "llama2-7b", "--device", "cpu",
                       "--requests", "2", "--max-new", "3", "--continuous"])
    assert len(outs) == 2 and all(len(o) == 3 for o in outs)
    assert "decode steps" in capsys.readouterr().out


# ------------------------------------------------------------ hygiene

def test_port_imports_neither_jax_nor_repro():
    """Every module of the port, and chip_smoke.py, in a fresh
    interpreter: no ``jax``, no ``repro``/``repro.*`` and no
    ``msgpack``/``zstandard`` module loads."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "new = ['repro_torch.models.zamba2', 'repro_torch.models.mamba2', "
        "'repro_torch.kernels.ssm_scan', 'repro_torch.configs.zamba2_2_7b', "
        "'repro_torch.configs.roberta_large', "
        "'repro_torch.configs.gpt2_large', "
        "'repro_torch.configs.gpt_neo_2_7b', "
        "'repro_torch.optim.adafactor', 'repro_torch.core.memory_model', "
        "'repro_torch.train.checkpoint', 'repro_torch.optim.mezo', "
        "'repro_torch.models.moe', 'repro_torch.configs.deepseek_moe_16b', "
        "'repro_torch.configs.internvl2_26b', "
        "'repro_torch.models.encdec', "
        "'repro_torch.configs.seamless_m4t_large_v2', "
        "'repro_torch.models.xlstm', 'repro_torch.configs.xlstm_1_3b', "
        "'repro_torch.dist.compress', 'repro_torch.dist.shardings', "
        "'repro_torch.dist.ctx', 'repro_torch.dist.elastic', "
        "'repro_torch.launch.mesh']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('msgpack', 'zstandard'))\n"
        "assert not bad, bad\n"
        "assert all(m in sys.modules for m in new), new\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('LOADED', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": f"{_REPO / 'src'}:{_REPO}", "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split("LOADED")[1]) >= 15


def test_chip_smoke_fails_without_a_card():
    """No card: chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    r = subprocess.run([sys.executable, str(_REPO / "chip_smoke.py")],
                       cwd=_REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
