"""The port's xlstm serving slice (xlstm-1.3b), held against the JAX
package on the CPU.

Same weights (the JAX ``init`` tree's shapes filled from a numpy seed:
dense weights N(0, 1) / sqrt(fan_in), the sLSTM's recurrent weights
N(0, 1) / sqrt(dh), embedding 0.02, norm scales 1 + 0.1 z, the forget
gate's bias 3 + 0.5 z, the sLSTM's gate bias 0.1 z), bridged to torch;
tokens from a numpy seed; xlstm's SMOKE twin (4 layers, d 32, 4 heads,
``slstm_every`` 2: the mLSTM's scan at (P, N) = (17, 16)).  With the
forget gate near sigmoid(3) the state keeps ~95% a step, so a wrong carry
shows.

- the mLSTM prompt pass against JAX's ``mlstm_forward`` (its output) and
  a token-by-token walk of JAX's ``mlstm_decode`` (its final state);
  ``mlstm_decode`` from that state; ``_slstm_scan`` from a non-zero
  state;
- ``prefill`` (logits and the whole cache: ``mlstm_C``, the sLSTM's c, n,
  h, m, ``pos``) and four ``decode_step``s, at S = 20 (one chunk) and
  S = 256 (two chunks of 128);
- ``ServeEngine``'s greedy tokens on ragged prompts (the left pad runs
  unmasked, as in the reference) equal to the JAX engine's;
- all at fp32 within 1e-5 (atol = rtol), and at bf16 (the same bf16
  weights on both sides) within 2e-2 (``chip_smoke.py``'s bf16 ``TOL``)
  of each leaf's norm, ``|got - want| <= 2e-2 |want|`` over the leaf:
  the two frameworks round some bf16 operations one ulp apart (``silu``,
  ``rsqrt`` in the norms), and the sLSTM's exponential gating carries
  such an ulp from step to step, so single entries of its c and n stray
  further (up to 3.5e-2 of the leaf's largest entry here) while the leaf
  as a whole stays within 1.7e-2;
- the launcher at ``--smoke --device cpu``; the published config's
  parameter count on the meta device; ``make_runner`` builds an xlstm
  runner and continuous batching refuses the family.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import (flatten_with_paths,  # noqa: E402
                                       tree_cast, tree_size,
                                       unflatten_from_paths)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import make_runner  # noqa: E402
from repro_torch.kernels import ssm_scan as K  # noqa: E402
from repro_torch.models import get_family  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401

F32 = torch.float32
BF16 = torch.bfloat16
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = 2e-2
JCFG = jax_get_config("xlstm-1.3b", smoke=True)
CFG = ArchConfig(**dataclasses.asdict(JCFG))
DTYPES = {"float32": (F32, jnp.float32), "bfloat16": (BF16, jnp.bfloat16)}
_PARAMS = {}

pytestmark = pytest.mark.usefixtures("one_thread")

# the reference's functions under jit (config and dtype static): op by op
# they take most of this file's time
_mlstm_forward = jax.jit(JX.mlstm_forward, static_argnums=2)
_mlstm_decode = jax.jit(JX.mlstm_decode, static_argnums=2)
_prefill = jax.jit(JX.prefill, static_argnums=0,
                   static_argnames="compute_dtype")
_decode_step = jax.jit(JX.decode_step, static_argnums=0,
                       static_argnames="compute_dtype")


def _np_params():
    if "np" not in _PARAMS:
        shapes = flatten_with_paths(jax.eval_shape(
            lambda: JX.init(JCFG, jax.random.PRNGKey(0))))
        rng = np.random.default_rng(17)
        flat = {}
        for path, sd in shapes.items():
            z = rng.standard_normal(sd.shape)
            leaf = path.split("/")[-1]
            if leaf == "scale":
                z = 1 + 0.1 * z
            elif leaf == "b_f":
                z = 3 + 0.5 * z
            elif leaf == "b_zifo":
                z = 0.1 * z
            elif leaf == "tok":
                z = 0.02 * z
            elif leaf.startswith("r_"):
                z = z / np.sqrt(sd.shape[-1])
            else:
                z = z / np.sqrt(sd.shape[-2])
            flat[path] = z.astype(np.float32)
        _PARAMS["np"] = unflatten_from_paths(flat)
    return _PARAMS["np"]


def _params(dtype="float32"):
    """(JAX params, torch params), bf16 on both sides for bf16."""
    tree = _np_params()
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.to_torch(tree)
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
        tp = tree_cast(tp, BF16)
    return jp, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL, err_msg=what)
    else:
        err = float(np.linalg.norm(got - want))
        scale = max(float(np.linalg.norm(want)), 1e-30)
        assert err <= BF16_TOL * scale, (what, err, scale)


def _layer(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


def _hidden(seed, b, s, dtype):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, s, CFG.d_model)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return jnp.asarray(h).astype(jdt), torch.from_numpy(h).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [20, 256])
def test_mlstm_prompt_pass_and_decode_match_jax(s, dtype):
    """The prompt pass's output against ``mlstm_forward``, its final
    state against JAX's ``mlstm_decode`` walked token by token from zero,
    then one ``mlstm_decode`` from that state."""
    jp, tp = _params(dtype)
    jl, tl = _layer(jp["mlstm"], 1), TX._layer(tp["mlstm"], 1)
    jh, th = _hidden(3, 2, s, dtype)
    out, C = TX.mlstm_prefill(tl, th, CFG)
    assert C.dtype == F32 and C.shape == (2, 4, 17, 16)
    _close(out, _mlstm_forward(jl, jh, JCFG), dtype, "prompt pass")
    if dtype == "float32":              # the state, token by token
        st = {"C": jnp.zeros((2, 4, 17, 16), jnp.float32)}
        for t in range(s):
            _, st = _mlstm_decode(jl, jh[:, t:t + 1], JCFG, st)
        _close(C, st["C"], dtype, "final state")
        assert float(np.abs(_np(C)).max()) > 1.0       # the carry is large
    jx, tx = _hidden(4, 2, 1, dtype)
    jo, jst = _mlstm_decode(jl, jx, JCFG, {"C": jnp.asarray(C.numpy())})
    to, tC = TX.mlstm_decode(tl, tx, CFG, C.clone())
    _close(to, jo, dtype, "decode output")
    _close(tC, jst["C"], dtype, "decode state")


def test_slstm_scan_from_a_nonzero_state_matches_jax():
    jp, tp = _params()
    rng = np.random.default_rng(5)
    b, s, dh = 3, 9, CFG.d_model // CFG.n_heads
    xg = rng.standard_normal((b, s, 4 * CFG.d_model)).astype(np.float32)
    state = {k: rng.standard_normal((b, CFG.n_heads, dh)).astype(np.float32)
             for k in ("c", "h", "m")}
    state["n"] = rng.uniform(0.5, 2.0, (b, CFG.n_heads, dh)).astype(
        np.float32)
    jys, jst = JX._slstm_scan(_layer(jp["slstm"], 1), jnp.asarray(xg), JCFG,
                              jax.tree.map(jnp.asarray, state))
    tys, tst = TX._slstm_scan(TX._layer(tp["slstm"], 1), torch.from_numpy(xg),
                              CFG, {k: torch.from_numpy(v)
                                    for k, v in state.items()})
    _close(tys, jys, "float32", "ys")
    for k in ("c", "n", "h", "m"):
        _close(tst[k], jst[k], "float32", k)


def _cache_leaves(cache):
    return {"mlstm_C": cache["mlstm_C"],
            **{f"slstm/{k}": cache["slstm"][k] for k in ("c", "n", "h", "m")}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [20, 256])
def test_prefill_and_decode_steps_match_jax(s, dtype):
    tdt, jdt = DTYPES[dtype]
    jp, tp = _params(dtype)
    b = 3
    rng = np.random.default_rng(1)
    toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    jcache = JX.init_cache(JCFG, b)
    jl, jcache = _prefill(JCFG, jp, {"tokens": jnp.asarray(toks)}, jcache,
                          compute_dtype=jdt)
    tcache = TX.init_cache(CFG, b)
    assert {k: tuple(v.shape) for k, v in _cache_leaves(tcache).items()} == \
        {k: v.shape for k, v in _cache_leaves(jcache).items()}
    tl, tcache = TX.prefill(CFG, tp, {"tokens": torch.from_numpy(toks).long()},
                            tcache, compute_dtype=tdt)
    assert tl.dtype == F32 and tl.shape == (b, 1, CFG.vocab_padded)
    _close(tl, jl, dtype, "prefill logits")
    for step in range(5):
        for key, want in _cache_leaves(jcache).items():
            got = _cache_leaves(tcache)[key]
            assert got.dtype == F32
            _close(got, want, dtype, f"{key} after step {step}")
        assert tcache["pos"] == int(jcache["pos"]) == s + step
        if step == 4:
            break
        nxt = rng.integers(0, CFG.vocab, (b, 1)).astype(np.int32)
        jl, jcache = _decode_step(JCFG, jp, jcache, jnp.asarray(nxt),
                                  compute_dtype=jdt)
        tl, tcache = TX.decode_step(CFG, tp, tcache,
                                    torch.from_numpy(nxt).long(),
                                    compute_dtype=tdt)
        _close(tl, jl, dtype, f"decode step {step}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_greedy_tokens_match_jax(dtype):
    """Ragged prompts of 11, 7 and 16 tokens, left-padded with token 0
    that runs through both recurrences unmasked, as in the reference;
    the JAX engine gets the same (bf16 for bf16) weights."""
    tdt, jdt = DTYPES[dtype]
    jp, tp = _params(dtype)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, CFG.vocab, n) for n in (11, 7, 16)]
    jeng = JaxServe(JCFG, jp, max_len=8, batch=3, compute_dtype=jdt)
    want = jeng.generate([jnp.asarray(p, jnp.int32) for p in prompts],
                         max_new_tokens=6)
    K.reset_launches()
    teng = TE.ServeEngine(CFG, tp, max_len=8, batch=3, compute_dtype=tdt,
                          device="cpu")
    got = teng.generate(prompts, max_new_tokens=6)
    assert got == want
    # max_len does not bound the constant-size state; the CPU path counts
    # no kernel launch
    assert K.ssm_scan.launches == K.ssm_scan.launches_wide == 0


def test_bf16_engine_keeps_the_gate_leaves_fp32():
    _, tp = _params()
    eng = TE.ServeEngine(CFG, tp, batch=2, compute_dtype=BF16, device="cpu")
    for key in ("r_z", "r_i", "r_f", "r_o"):
        assert eng.params["slstm"][key].dtype == F32
    assert eng.params["mlstm"]["b_f"].dtype == F32
    assert eng.params["mlstm"]["wq"].dtype == BF16
    assert eng.params["slstm"]["w_zifo"].dtype == BF16


def test_launcher_serves_xlstm_on_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new", "3"])
    assert len(outs) == 2 and all(len(o) == 3 for o in outs)
    assert "served 2 requests" in capsys.readouterr().out


def test_registry_init_and_parameter_count():
    """The config field for field, the init tree's paths and shapes, and
    the published config's 3,529,631,912 parameters (on the meta
    device)."""
    full = get_config("xlstm-1.3b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_config("xlstm-1.3b"))
    assert get_config("xlstm-1.3b", smoke=True) == CFG
    assert get_family(CFG) is TX
    tp = TX.init(CFG, torch.Generator().manual_seed(0))
    want = flatten_with_paths(jax.eval_shape(
        lambda: JX.init(JCFG, jax.random.PRNGKey(0))))
    got = flatten_with_paths(tp)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    meta = TX.init(full, torch.Generator(), device="meta")
    assert tree_size(meta) == 3_529_631_912
    assert [(u.key, u.index) for u in TX.unit_spec(CFG)] == \
        [(u.key, u.index) for u in JX.unit_spec(JCFG)]
    assert [TX.unit_first_depth(CFG, u) for u in TX.unit_spec(CFG)] == \
        [JX.unit_first_depth(JCFG, u) for u in JX.unit_spec(JCFG)]


def test_training_and_continuous_batching_refuse_xlstm():
    """Named when the family did not train: ``make_runner`` now builds an
    xlstm runner (HiFT m=1: embed, the four layers and the head, six
    groups; training is held against JAX in
    ``test_torch_xlstm_training``), and continuous batching still
    refuses the family (its state has no paged cache)."""
    _, tp = _params()
    runner = make_runner(CFG, "hift", params=tp, device="cpu")
    assert runner.k == 6
    assert [runner.group_for_step(s).label() for s in range(6)] == [
        "g0(embed)", "g1(mlstm[0:1])", "g2(slstm[0:1])", "g3(mlstm[1:2])",
        "g4(slstm[1:2])", "g5(head)"]
    with pytest.raises(ValueError, match="dense"):
        TE.ContinuousServeEngine(CFG, tp, device="cpu")


def test_chip_phase_serve_side_rehearsed_on_cpu():
    """``chip_smoke.py``'s card-against-CPU side at the SMOKE size: greedy
    tokens of the launcher's shape, the prefill logits and the normalizer
    row of the last mLSTM state; two runs give the same numbers (each
    side draws its params from seed 0 on the CPU)."""
    import chip_smoke
    sides = [chip_smoke.xlstm_serve_side(torch, "cpu", CFG) for _ in range(2)]
    a, b = sides
    assert a["tokens"] == b["tokens"]
    assert [len(t) for t in a["tokens"]] == [chip_smoke.XLSTM_CPU_NEW] * 4
    assert a["logits"].shape == (4, 1, CFG.vocab_padded)
    assert a["state"].shape == (4, CFG.n_heads, 16)
    np.testing.assert_array_equal(a["logits"], b["logits"])
