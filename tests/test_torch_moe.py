"""The port's moe family (deepseek-moe-16b, arctic-480b), held against the
JAX package on the CPU.

Same weights (the JAX ``init`` tree's shapes filled from a numpy seed:
dense weights and expert stacks N(0, 1) / sqrt(fan_in), embedding 0.02,
norm scales 1 + 0.1 z), bridged to torch; tokens and labels from a numpy
seed; deepseek-moe-16b's SMOKE twin (2 layers, 8 experts top-2, one
shared expert) with ``ce_chunk = 16``, fp32 throughout.  Routing is
discontinuous, so every comparison first asserts that both packages chose
the same experts for every (token, slot); the seeds below are the first
tried.

- ``moe_ffn`` with and without capacity drops and ``moe_ffn_exact``
  against JAX: outputs within 1e-5 (the same products summed in other
  orders).
- ``loss_fn`` and every leaf's gradient against ``jax.grad`` at cut
  None / 0 / 1: losses within 1e-6, gradients within 1e-5 of each leaf's
  largest entry (the tolerance of the dense and hybrid slices).
- ``lomo_pieces`` chained is ``loss_fn`` bit for bit.
- Runner level against JAX's ``make_runner``, two steps each (the
  tolerances of ``test_torch_hybrid_training._run_both``): ``hift`` at
  m = 1 and m = 2 and the seven other strategies (MeZO on JAX's z); one
  NF4 HiFT step (losses within 1e-5).  AdaLomo's params are held where
  the starting gradient exceeds 1e-4, as the hybrid slice's: the
  reference's own moe AdaLomo pieces stand 6.4e-4 from its generic path.
- Serving: ``prefill`` and decode logits within 1e-4 of JAX's, and
  ``ServeEngine``'s greedy tokens equal to the JAX engine's.
- arctic-480b's SMOKE twin (the parallel dense residual FFN): loss and
  gradients at cut None and one HiFT step.
- The bridge's round trip of the moe tree, bit for bit; the launchers for
  every strategy; ``chip_smoke.py``'s moe phase rehearsed on the CPU.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import HiFTConfig as JHiFTConfig  # noqa: E402
from repro.core import LiSAConfig as JLiSAConfig  # noqa: E402
from repro.core import LRSchedule as JLRSchedule  # noqa: E402
from repro.core import make_runner as jax_make_runner  # noqa: E402
from repro.core.strategy import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import (flatten_with_paths,  # noqa: E402
                                       unflatten_from_paths)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import (HiFTConfig, LiSAConfig, LRSchedule,  # noqa: E402
                              QuantConfig, make_runner)
from repro_torch.models import get_family  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.base import layer_at  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from test_torch_mezo import jax_step_noise  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401

F32 = torch.float32
LR = 1e-3
JCFG = dataclasses.replace(jax_get_config("deepseek-moe-16b", smoke=True),
                           ce_chunk=16)
CFG = ArchConfig(**dataclasses.asdict(JCFG))
JARCTIC = dataclasses.replace(jax_get_config("arctic-480b", smoke=True),
                              ce_chunk=16)
ARCTIC = ArchConfig(**dataclasses.asdict(JARCTIC))


@functools.lru_cache(maxsize=None)
def _np_params_of(jcfg, seed=5):
    shapes = flatten_with_paths(jax.eval_shape(
        lambda: JM.init(jcfg, jax.random.PRNGKey(0))))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, sd in shapes.items():
        z = rng.standard_normal(sd.shape)
        leaf = path.split("/")[-1]
        if leaf == "scale":
            z = 1 + 0.1 * z
        elif leaf == "tok":
            z = 0.02 * z
        else:
            z = z / np.sqrt(sd.shape[-2])
        flat[path] = z.astype(np.float32)
    return unflatten_from_paths(flat)


def _np_params():
    return _np_params_of(JCFG)


def _batches(cfg, n, seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
            for _ in range(n)]


def _tb(batch):
    """Integer arrays as int64 tensors, float arrays (an encdec batch's
    ``src_embeds``) as they are."""
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu"
            else torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(tree):
    return {p: np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                          else x)
            for p, x in flatten_with_paths(tree).items()}


def _assert_rel_close(got, want, rel=1e-5, err=""):
    """Each leaf within ``rel`` of its largest entry."""
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=rel * max(float(np.abs(w).max()),
                                                  1e-30),
                                   err_msg=f"{err}{path}")


def _jax_routes(p, x, cfg):
    xt = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])


# ------------------------------------------------------------ MoE core

def _ffn_inputs(cfg):
    npp = _np_params()
    p = jax.tree.map(lambda x: x[0], npp["layers"]["moe"])
    x = np.random.default_rng(7).standard_normal((2, 32, cfg.d_model))
    return p, x.astype(np.float32)


@pytest.mark.parametrize("factor", [1.25, 8.0], ids=["drops", "no_drops"])
def test_moe_ffn_matches_jax(factor):
    """The capacity dispatch: at the default factor some expert gets more
    routes than its C rows (drops), at 8.0 none does."""
    jcfg = dataclasses.replace(JCFG, capacity_factor=factor)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    p, x = _ffn_inputs(cfg)
    jp, jx = jax.tree.map(jnp.asarray, p), jnp.asarray(x)
    tp, tx = bridge.to_torch(p), torch.from_numpy(x)
    with TM.recording_routes() as routes:
        got = TM.moe_ffn(tp, tx, cfg)
    ids = _jax_routes(jp, jx, cfg)
    np.testing.assert_array_equal(routes[0].numpy(), ids)
    counts = np.bincount(ids.reshape(-1), minlength=cfg.n_experts)
    assert (counts.max() > TM.capacity(64, cfg)) == (factor == 1.25)
    assert TM.capacity(64, cfg) == int(np.ceil(64 * cfg.top_k /
                                               cfg.n_experts * factor))
    want = np.asarray(JM.moe_ffn(jp, jx, jcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_moe_ffn_exact_matches_jax_and_the_dropless_dispatch():
    p, x = _ffn_inputs(CFG)
    jp, jx = jax.tree.map(jnp.asarray, p), jnp.asarray(x)
    tp, tx = bridge.to_torch(p), torch.from_numpy(x)
    got = TM.moe_ffn_exact(tp, tx, CFG)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JM.moe_ffn_exact(jp, jx, JCFG)),
                               rtol=0, atol=1e-5)
    nodrop = dataclasses.replace(CFG, capacity_factor=8.0)
    np.testing.assert_allclose(got.numpy(),
                               TM.moe_ffn(tp, tx, nodrop).numpy(),
                               rtol=0, atol=1e-5)


def test_moe_ffn_gradients_match_jax():
    """Gradients through the gathers, the capacity mask and the gate
    normalisation: every leaf and the input within 1e-5 of its largest
    entry."""
    p, x = _ffn_inputs(CFG)
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda a, b: jnp.sum(JM.moe_ffn(a, b, JCFG) * g),
                        argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                        jnp.asarray(x))
    tp = bridge.to_torch(p)
    tx = torch.from_numpy(x).requires_grad_(True)
    flat = flatten_with_paths(tp)
    for t in flat.values():
        t.requires_grad_(True)
    out = (TM.moe_ffn(tp, tx, CFG) * torch.from_numpy(g)).sum()
    gs = torch.autograd.grad(out, list(flat.values()) + [tx])
    got = {k: v.numpy() for k, v in zip(list(flat) + ["x"], gs)}
    want = _np(jax.tree.map(np.asarray, jgp))
    want["x"] = np.asarray(jgx)
    _assert_rel_close(got, want)


# ------------------------------------------------------------ model level

@functools.lru_cache(maxsize=None)
def _grads(arch, cut):
    jcfg, cfg = (JCFG, CFG) if arch == "deepseek" else (JARCTIC, ARCTIC)
    npp = _np_params_of(jcfg)
    batch = _batches(cfg, 1)[0]
    jl, jg = jax.value_and_grad(lambda p: JM.loss_fn(
        jcfg, p, _jb(batch), cut=cut, compute_dtype=jnp.float32))(
            jax.tree.map(jnp.asarray, npp))
    tp = bridge.to_torch(npp)
    flat = flatten_with_paths(tp)
    for t in flat.values():
        t.requires_grad_(True)
    with TM.recording_routes() as routes:
        tl = TM.loss_fn(cfg, tp, _tb(batch), cut=cut,
                        compute_dtype=torch.float32)
    gs = torch.autograd.grad(tl, list(flat.values()), allow_unused=True)
    tg = {p: (np.zeros(t.shape, np.float32) if g is None else g.numpy())
          for (p, t), g in zip(flat.items(), gs)}
    return (float(jl), _np(jax.tree.map(np.asarray, jg)), float(tl.detach()),
            tg, routes)


@pytest.mark.parametrize("arch,cut", [("deepseek", None), ("deepseek", 0),
                                      ("deepseek", 1), ("arctic", None)])
def test_loss_and_grads_match_jax(arch, cut):
    jl, jg, tl, tg, routes = _grads(arch, cut)
    assert routes, "no dispatch recorded"
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6)
    _assert_rel_close(tg, jg, err=f"{arch} cut={cut}: ")
    if cut is not None:
        assert not np.any(tg["embed/tok"])
    if cut == 1:
        assert not np.any(tg["layers/moe/w_gate"][:1])
    if arch == "arctic":
        assert np.abs(tg["layers/dense_mlp/w_up"]).max() > 0


def test_routes_of_the_forward_are_jaxs():
    """The layer-0 routes the port's loss dispatched are the reference's
    (the value comparisons above assume it)."""
    npp = _np_params()
    batch = _batches(CFG, 1)[0]
    jp = jax.tree.map(jnp.asarray, npp)
    h = jp["embed"]["tok"][batch["tokens"]]
    l0 = jax.tree.map(lambda x: x[0], jp["layers"])
    cos, sin = JM.L.rope_frequencies(CFG.head_dim, 32, CFG.rope_theta)
    h = h + JM.L.gqa_attention(l0["attn"], JM.L.rmsnorm(l0["ln1"], h), JCFG,
                               cos, sin)
    ids = _jax_routes(l0["moe"], JM.L.rmsnorm(l0["ln2"], h), CFG)
    np.testing.assert_array_equal(_grads("deepseek", None)[4][0].numpy(), ids)


def test_lomo_pieces_compose_to_loss_fn():
    tp = bridge.to_torch(_np_params())
    batch = _tb(_batches(CFG, 1)[0])
    pieces = TM.lomo_pieces(CFG, compute_dtype=F32)
    assert pieces.stage_keys == ("layers",) and pieces.liveness_m == 1
    ep, (layers,), sp, hp = pieces.split(tp)
    with torch.no_grad():
        want = TM.loss_fn(CFG, tp, batch, compute_dtype=F32)
        h, _ = pieces.stage_inits[0](ep, None, batch)
        for j in range(CFG.n_layers):
            h = pieces.stage_fns[0](layer_at(layers, j), sp, None, h)
        got = pieces.head_loss_fn(hp, ep, h, batch)
    assert float(got) == float(want)
    merged = pieces.merge(ep, (layers,), sp, hp)
    assert merged["layers"] is tp["layers"]


def test_unit_spec_and_init_match_the_reference():
    assert [u.label() for u in TM.unit_spec(CFG)] == \
        [u.label() for u in JM.unit_spec(JCFG)]
    for jcfg, cfg in ((JCFG, CFG), (JARCTIC, ARCTIC)):
        want = flatten_with_paths(jax.eval_shape(
            lambda c=jcfg: JM.init(c, jax.random.PRNGKey(0))))
        got = flatten_with_paths(TM.init(cfg,
                                         torch.Generator().manual_seed(0)))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
    assert get_family(CFG) is TM
    w = TM.init(CFG, torch.Generator().manual_seed(0))["layers"]["moe"]
    # normal / sqrt(fan_in): the stacks' spread is 1 / sqrt(rows)
    assert abs(float(w["w_down"].std()) * np.sqrt(CFG.moe_d_ff) - 1) < 0.05


# ------------------------------------------------------------ runner level

def _port(cfg, npp, strategy, **kw):
    return make_runner(cfg, strategy, params=bridge.to_torch(npp),
                       schedule=LRSchedule(base_lr=LR), device="cpu", **kw)


def _jax(jcfg, npp, strategy, **kw):
    return jax_make_runner(jcfg, strategy,
                           params=jax.tree.map(jnp.asarray, npp),
                           schedule=JLRSchedule(base_lr=LR), **kw)


def run_both(jcfg, cfg, npp, strategy, steps, pkw=None, jkw=None,
             update="linear", start_grads=None, batches=None,
             bound_only=None):
    """``steps`` steps of both runners on the same batches, held as
    ``test_torch_hybrid_training._run_both`` holds them: "linear" losses
    and params within 1e-5; "adam" losses within 1e-5 (2e-4 from the third
    step), params within 1e-5 but for at most 0.1 % of a leaf and none
    beyond 2 lr steps + 1e-5 (AdamW's sign-like first update); "adalomo"
    params where the starting gradient exceeds 1e-4.  The router's
    columns of the experts a step routes little or nothing to get
    gradients of ~1e-10 only through the softmax (seen: 46 of the 1024
    elements of a HiFT m = 2 run, each gradient below 4e-10; 12.5 % of
    layer 1's under 1e-7), so a router may hold one expert's columns
    (1/E of the leaf) of such elements.  ``batches(n, seed=)``: the
    family's batches (default: tokens and labels of ``cfg``).
    ``bound_only``: {path: index} of elements whose true gradient is zero
    (both packages' gradients rounding), held under "adam" to the 2-lr
    bound alone."""
    tr = _port(cfg, npp, strategy, **(pkw or {}))
    jr = _jax(jcfg, npp, strategy, **(jkw or {}))
    bs = batches(steps, seed=1) if batches else _batches(cfg, steps, seed=1)
    for i, b in enumerate(bs):
        atol = 2e-4 if update == "adam" and i >= 2 else 1e-5
        np.testing.assert_allclose(float(tr.train_step(_tb(b))),
                                   float(jr.train_step(_jb(b))), rtol=0,
                                   atol=atol, err_msg=f"{strategy} step {i}")
    got, want = _np(tr.params), _np(jax.tree.map(np.asarray, jr.params))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if update == "adalomo":
            keep = np.abs(start_grads[path]) > 1e-4
            g, w = g[keep], w[keep]
        d = np.abs(g - w)
        if update == "adam":
            if path in (bound_only or {}):
                assert d[bound_only[path]].max() <= 2 * LR * steps + 1e-5, \
                    (strategy, path)
                d[bound_only[path]] = 0.0
            share = 1 / cfg.n_experts if path.endswith("moe/router") \
                else 1e-3
            assert (d > 1e-5).sum() <= share * d.size, (strategy, path)
            assert d.max() <= 2 * LR * steps + 1e-5, (strategy, path)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"{strategy}: {path}")
    return tr, jr


STRATEGIES = {
    "hift_m1": ("hift", {"hift": HiFTConfig(m=1, strategy="top2down")},
                {"hift": JHiFTConfig(m=1, strategy="top2down")}, "adam"),
    "hift_m2": ("hift", {"hift": HiFTConfig(m=2)},
                {"hift": JHiFTConfig(m=2)}, "adam"),
    "hift_pipelined": ("hift_pipelined", {}, {}, "adam"),
    "lisa": ("lisa", {"lisa": LiSAConfig(m=1, switch_every=1, seed=2)},
             {"lisa": JLiSAConfig(m=1, switch_every=1, seed=2)}, "adam"),
    "fpft": ("fpft", {}, {}, "adam"),
    "fpft_streamed": ("fpft_streamed", {"stream_window": 1 << 16},
                      {"stream_window": 1 << 16}, "adam"),
    "lomo": ("lomo", {}, {}, "linear"),
    "adalomo": ("adalomo", {}, {}, "adalomo"),
    "mezo": ("mezo", {"seed": 3}, {"seed": 3}, "linear"),
}


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_matches_the_jax_runner(name):
    strategy, pkw, jkw, update = STRATEGIES[name]
    npp = _np_params()
    if strategy == "mezo":
        pkw = dict(pkw, noise=jax_step_noise(npp))
    tr, jr = run_both(JCFG, CFG, npp, strategy, 2, pkw, jkw, update,
                      start_grads=_grads("deepseek", None)[1])
    if strategy == "hift":
        labels = [tr.group_for_step(s).label() for s in range(2)]
        assert labels == [jr.group_for_step(s).label() for s in range(2)]


def test_nf4_hift_step_matches_jax():
    """One quantized HiFT step (NF4 resident tree, bf16 moments) on the
    head group: the frozen layers' attention, router and shared expert
    multiply through their views, their expert stacks come decoded a layer
    at a time."""
    hift = dict(m=1, strategy="top2down")
    npp = _np_params()
    tr = _port(CFG, npp, "hift", hift=HiFTConfig(**hift),
               quant=QuantConfig("nf4", "bf16"))
    jr = _jax(JCFG, npp, "hift", hift=JHiFTConfig(**hift),
              quant=JQuantConfig("nf4", "bf16"))
    assert tr.group_for_step(0).label() == jr.group_for_step(0).label()
    b = _batches(CFG, 1, seed=2)[0]
    np.testing.assert_allclose(float(tr.train_step(_tb(b))),
                               float(jr.train_step(_jb(b))), rtol=0,
                               atol=1e-5)
    rec = tr.params["layers"]["moe"]["w_gate"]
    assert set(rec) == {"q", "s", "t"} and rec["q"].dtype == torch.uint8


def test_arctic_hift_step_matches_jax():
    npp = _np_params_of(JARCTIC)
    run_both(JARCTIC, ARCTIC, npp, "hift", 2,
             {"hift": HiFTConfig(m=1, strategy="top2down")},
             {"hift": JHiFTConfig(m=1, strategy="top2down")}, "adam")


# ------------------------------------------------------------ serving

def test_prefill_and_decode_match_jax():
    npp = _np_params()
    jp, tp = jax.tree.map(jnp.asarray, npp), bridge.to_torch(npp)
    b, s, max_len = 3, 12, 16
    rng = np.random.default_rng(4)
    toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    jcache = JM.init_cache(JCFG, b, max_len, dtype=jnp.float32)
    jl, jcache = JM.prefill(JCFG, jp, {"tokens": jnp.asarray(toks)}, jcache,
                            compute_dtype=jnp.float32)
    tcache = TM.init_cache(CFG, b, max_len, dtype=F32)
    tl, tcache = TM.prefill(CFG, tp, {"tokens": torch.from_numpy(toks).long()},
                            tcache, compute_dtype=F32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for step in range(3):
        nxt = rng.integers(0, CFG.vocab, (b, 1)).astype(np.int32)
        jl, jcache = JM.decode_step(JCFG, jp, jcache, jnp.asarray(nxt),
                                    compute_dtype=jnp.float32)
        tl, tcache = TM.decode_step(CFG, tp, tcache,
                                    torch.from_numpy(nxt).long(),
                                    compute_dtype=F32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4, err_msg=f"decode {step}")
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), atol=1e-4,
                                       rtol=1e-4)
    assert tcache["pos"] == int(jcache["pos"]) == s + 3


@pytest.mark.parametrize("arch", ["deepseek", "arctic"])
def test_engine_matches_jax(arch):
    """Greedy tokens of mixed-length prompts (left pad unmasked, as the
    reference serves moe) equal the JAX engine's."""
    jcfg, cfg = (JCFG, CFG) if arch == "deepseek" else (JARCTIC, ARCTIC)
    npp = _np_params_of(jcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (10, 4, 7)]
    want = JaxServe(jcfg, jax.tree.map(jnp.asarray, npp), max_len=20,
                    batch=4, compute_dtype=jnp.float32).generate(
        [jnp.asarray(p) for p in prompts], max_new_tokens=5)
    eng = TE.ServeEngine(cfg, bridge.to_torch(npp), max_len=20, batch=4,
                         compute_dtype=F32, device="cpu")
    assert eng.generate(prompts, max_new_tokens=5) == want


def test_continuous_engine_refuses_moe_like_the_reference():
    from repro.serve.engine import ContinuousServeEngine as JaxCont
    with pytest.raises(ValueError, match="dense"):
        JaxCont(JCFG, None)
    with pytest.raises(ValueError, match="dense"):
        TE.ContinuousServeEngine(CFG, bridge.to_torch(_np_params()),
                                 device="cpu")


# ------------------------------------------------------------ the rest

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_the_moe_tree_bit_for_bit(dtype):
    jtree = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype),
                         _np_params_of(JARCTIC))
    back = bridge.to_numpy(bridge.to_torch(jtree), bf16_dtype=jnp.bfloat16)
    want = flatten_with_paths(jax.tree.map(np.asarray, jtree))
    got = flatten_with_paths(back)
    assert got.keys() == want.keys()
    assert "layers/moe/w_gate" in got and "layers/dense_mlp/w_up" in got
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        assert np.array_equal(got[path].view(np.uint8),
                              want[path].view(np.uint8)), path


def test_full_configs_resolve_and_init_on_meta():
    for arch in ("deepseek-moe-16b", "arctic-480b"):
        cfg = get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jax_get_config(arch))
        p = TM.init(cfg, torch.Generator(), device="meta")
        assert p["layers"]["moe"]["w_gate"].shape == (
            cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)


@pytest.mark.parametrize("strategy", ["hift", "hift_pipelined", "lisa",
                                      "fpft", "fpft_streamed", "lomo",
                                      "adalomo", "mezo"])
def test_launcher_trains_deepseek_moe_on_cpu(strategy, capsys):
    from repro_torch.launch import train as train_cli
    out = train_cli.main(["--arch", "deepseek-moe-16b", "--smoke", "--steps",
                          "2", "--batch", "2", "--seq", "32", "--device",
                          "cpu", "--strategy", strategy])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    text = capsys.readouterr().out
    assert "family=moe" in text and "done: final loss" in text


def test_launcher_serves_deepseek_moe_on_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "deepseek-moe-16b", "--device", "cpu",
                       "--requests", "2", "--max-new", "3"])
    assert len(outs) == 2 and all(len(o) == 3 for o in outs)
    assert "served 2 requests" in capsys.readouterr().out


def test_chip_smoke_moe_phase_runs_small_on_the_cpu(capsys):
    """``chip_smoke.py``'s card-against-CPU moe phase, rehearsed on the
    CPU alone at SMOKE width (both sides the CPU): every run emits its
    line, and no route or loss differs."""
    import json

    from test_torch_training import _chip_smoke
    chip_smoke = _chip_smoke()
    chip_smoke.phase_train_moe_card_vs_cpu(
        torch, cfgs=(CFG, ARCTIC), devices=("cpu", "cpu"))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [d["run"] for d in lines] == ["hift", "lomo", "adalomo", "mezo",
                                         "arctic_hift"]
    assert all(d["max_rel_loss_gap"] == 0.0 for d in lines)
    assert all(d["route_flips"] == 0 for d in lines)
