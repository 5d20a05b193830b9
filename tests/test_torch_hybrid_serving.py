"""The port's hybrid serving slice (zamba2), held against the JAX package
on the CPU.

Same weights (the JAX ``init`` tree's shapes filled from a numpy seed,
bridged to torch), same numpy-made tokens.  The SSM scalars are set to a
slow decay (``A_log = log(U(0.02, 0.05))``, ``dt_bias = -4``, so a step
decays the state by ~1e-3): with the published init (``A_log =
log(linspace(1, 16, H))``, ``dt_bias = 0``) the state entering a chunk is
~e^-88 and a wrong carry (entering state, final state, decode after
prefill) would pass every comparison.

- ``prefill`` and 4 ``decode_step``s: logits and all four cache leaves
  (ssm, conv, k, v) within 1e-4 of JAX's at fp32;
- within the port, the prefill of S + k tokens gives the last-token
  logits of a prefill of S followed by k decodes (across a chunk border),
  within 1e-4 at fp32;
- ``ServeEngine``: the JAX engine's greedy tokens, token for token, on
  mixed-length prompts (left pad unmasked, as in the reference);
- continuous batching and the unported families' training raise; the
  bridge carries the hybrid tree bit for bit; bf16 serving keeps the SSM
  scalars in fp32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import zamba2 as JZ  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import (flatten_with_paths,  # noqa: E402
                                       unflatten_from_paths)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import make_runner  # noqa: E402
from repro_torch.models import get_family  # noqa: E402
from repro_torch.models import zamba2 as TZ  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
F32 = torch.float32
JCFG = jax_get_config("zamba2-2.7b", smoke=True)
CFG = ArchConfig(**dataclasses.asdict(JCFG))
_PARAMS = {}


def _np_params():
    """Random params in the JAX init's shapes (dense weights
    N(0,1)/sqrt(fan_in), embedding 0.02, norm scales, D and conv biases
    random too), the SSM scalars at a slow decay."""
    if "np" not in _PARAMS:
        shapes = flatten_with_paths(jax.eval_shape(
            lambda: JZ.init(JCFG, jax.random.PRNGKey(0))))
        rng = np.random.default_rng(11)
        flat = {}
        for path, sd in shapes.items():
            z = rng.standard_normal(sd.shape)
            leaf = path.split("/")[-1]
            if leaf == "A_log":
                z = np.log(rng.uniform(0.02, 0.05, sd.shape))
            elif leaf == "dt_bias":
                z = np.full(sd.shape, -4.0)
            elif leaf in ("scale", "D"):
                z = 1 + 0.1 * z
            elif leaf in ("conv_w", "conv_b"):
                z = 0.1 * z
            elif leaf == "tok":
                z = 0.02 * z
            else:
                z = z / np.sqrt(sd.shape[-2])
            flat[path] = z.astype(np.float32)
        _PARAMS["np"] = unflatten_from_paths(flat)
    return _PARAMS["np"]


def _params():
    tree = _np_params()
    return jax.tree.map(jnp.asarray, tree), bridge.to_torch(tree)


def _cache_np(cache):
    return {k: np.asarray(cache[k]) for k in ("ssm", "conv", "k", "v")}


def test_prefill_and_decode_steps_match_jax():
    jp, tp = _params()
    b, s, max_len = 3, 20, 28
    rng = np.random.default_rng(1)
    toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    jcache = JZ.init_cache(JCFG, b, max_len, dtype=jnp.float32)
    jl, jcache = JZ.prefill(JCFG, jp, {"tokens": jnp.asarray(toks)}, jcache,
                            compute_dtype=jnp.float32)
    tcache = TZ.init_cache(CFG, b, max_len, dtype=F32)
    assert {k: tuple(v.shape) for k, v in tcache.items() if k != "pos"} == \
        {k: v.shape for k, v in _cache_np(jcache).items()}
    assert tcache["ssm"].dtype == F32
    tl, tcache = TZ.prefill(CFG, tp, {"tokens": torch.from_numpy(toks).long()},
                            tcache, compute_dtype=F32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for step in range(5):
        for key, want in _cache_np(jcache).items():
            np.testing.assert_allclose(tcache[key].numpy(), want, **TOL,
                                       err_msg=f"{key} after step {step}")
        assert tcache["pos"] == int(jcache["pos"]) == s + step
        if step == 4:
            break
        nxt = rng.integers(0, CFG.vocab, (b, 1)).astype(np.int32)
        jl, jcache = JZ.decode_step(JCFG, jp, jcache, jnp.asarray(nxt),
                                    compute_dtype=jnp.float32)
        tl, tcache = TZ.decode_step(CFG, tp, tcache,
                                    torch.from_numpy(nxt).long(),
                                    compute_dtype=F32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {step}")


@pytest.mark.parametrize("s,k", [(20, 4), (254, 4)])
def test_prefill_then_decode_equals_longer_prefill(s, k):
    """The reference's ``test_decode_matches_full_forward`` as a test of
    the carry: prefill(S) then k decodes ends at the logits of
    prefill(S + k).  At S = 254 the longer prefill scans two chunks of 129
    and the shorter one of 254, so the states cross a chunk border."""
    _, tp = _params()
    rng = np.random.default_rng(2)
    b = 2
    toks = torch.from_numpy(rng.integers(0, CFG.vocab, (b, s + k))).long()
    full, _ = TZ.prefill(CFG, tp, {"tokens": toks},
                         TZ.init_cache(CFG, b, s + k, dtype=F32), F32)
    ends = {}
    for carry in (True, False):
        lg, cache = TZ.prefill(CFG, tp, {"tokens": toks[:, :s]},
                               TZ.init_cache(CFG, b, s + k, dtype=F32), F32)
        if not carry:                  # decode from a forgotten SSM state
            cache["ssm"].zero_()
        for i in range(k):
            lg, cache = TZ.decode_step(CFG, tp, cache,
                                       toks[:, s + i:s + i + 1], F32)
        ends[carry] = lg
    np.testing.assert_allclose(ends[True].numpy(), full.numpy(), **TOL)
    # the comparison sees the carry: without it the logits move far more
    assert float((ends[False] - full).abs().max()) > 100 * TOL["atol"]


def test_prefill_needs_conv_width_minus_one_tokens():
    _, tp = _params()
    toks = torch.zeros((1, CFG.conv_width - 2), dtype=torch.long)
    with pytest.raises(ValueError, match="conv_width"):
        TZ.prefill(CFG, tp, {"tokens": toks},
                   TZ.init_cache(CFG, 1, 8, dtype=F32), F32)


def test_engine_matches_jax_on_mixed_length_prompts():
    jp, tp = _params()
    rng = np.random.default_rng(3)
    plens = [12, 5, 9]
    prompts = [rng.integers(0, CFG.vocab, n).astype(np.int32) for n in plens]
    want = JaxServe(JCFG, jp, max_len=24, batch=4,
                    compute_dtype=jnp.float32).generate(
        [jnp.asarray(p) for p in prompts], max_new_tokens=6)
    eng = TE.ServeEngine(CFG, tp, max_len=24, batch=4, compute_dtype=F32,
                         device="cpu")
    assert eng.generate(prompts, max_new_tokens=6) == want


def test_continuous_batching_and_training_raise():
    _, tp = _params()
    with pytest.raises(ValueError, match="dense"):
        TE.ContinuousServeEngine(CFG, tp, device="cpu")
    # hybrid training is ported (test_torch_hybrid_training); a family no
    # module has raises
    assert make_runner(CFG, "hift", params=tp, device="cpu").k == \
        CFG.n_layers + 3
    with pytest.raises(NotImplementedError, match="'rwkv'"):
        make_runner(dataclasses.replace(CFG, family="rwkv"), "hift",
                    params=tp, device="cpu")
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="dense"):
        serve.main(["--arch", "zamba2-2.7b", "--device", "cpu",
                    "--continuous"])


def test_launcher_serves_zamba2_on_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "zamba2-2.7b", "--device", "cpu",
                       "--requests", "2", "--max-new", "3"])
    assert len(outs) == 2 and all(len(o) == 3 for o in outs)
    assert "served 2 requests" in capsys.readouterr().out


def test_registry_and_init_match_the_reference():
    full = get_config("zamba2-2.7b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_config("zamba2-2.7b"))
    assert get_family(CFG) is TZ
    tp = TZ.init(CFG, torch.Generator().manual_seed(0))
    want = flatten_with_paths(jax.eval_shape(
        lambda: JZ.init(JCFG, jax.random.PRNGKey(0))))
    got = flatten_with_paths(tp)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    np.testing.assert_allclose(got["layers/mamba/A_log"][0].numpy(),
                               np.log(np.linspace(1, 16, CFG.ssm_heads)),
                               rtol=1e-6)
    bf = TZ.init(CFG, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert bf["layers"]["mamba"]["A_log"].dtype == F32
    assert bf["layers"]["mamba"]["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_the_hybrid_tree_bit_for_bit(dtype):
    jtree = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), _np_params())
    back = bridge.to_numpy(bridge.to_torch(jtree), bf16_dtype=jnp.bfloat16)
    want = flatten_with_paths(jax.tree.map(np.asarray, jtree))
    got = flatten_with_paths(back)
    assert got.keys() == want.keys()
    assert any("shared/attn" in k for k in got)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        assert np.array_equal(got[path].view(np.uint8),
                              want[path].view(np.uint8)), path


def test_bf16_engine_keeps_the_ssm_scalars_fp32():
    _, tp = _params()
    eng = TE.ServeEngine(CFG, tp, max_len=16, batch=2,
                         compute_dtype=torch.bfloat16, device="cpu")
    m = eng.params["layers"]["mamba"]
    assert m["A_log"].dtype == F32 and m["dt_bias"].dtype == F32
    assert torch.equal(m["A_log"], tp["layers"]["mamba"]["A_log"])
    assert m["in_proj"].dtype == torch.bfloat16
    assert eng.params["shared"]["attn"]["wq"].dtype == torch.bfloat16
    out = eng.generate([np.arange(6), np.arange(9)], max_new_tokens=3)
    assert all(len(o) == 3 and all(0 <= t < CFG.vocab_padded for t in o)
               for o in out)
