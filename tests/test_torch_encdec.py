"""The port's encdec family (seamless-m4t-large-v2), held against the JAX
package on the CPU.

Same weights (the JAX ``init`` tree's shapes filled from a numpy seed:
dense weights N(0, 1) / sqrt(fan_in), embedding 0.02, norm scales 1 + 0.1
z, biases 0.1 z), bridged to torch; frame embeddings, tokens and labels
from a numpy seed; seamless's SMOKE twin (2 + 2 layers, d 64, 4 heads of
16, vocab 512, blocks of 16) with ``ce_chunk = 16``, fp32 unless said.
The source has 24 frames, so the non-causal attention's blocks are the
reference's largest divisor of 24 not above 16 (12).

- ``encode`` and ``apply`` within 1e-5 of JAX's; ``loss_fn`` within 1e-6
  and every leaf's gradient within 1e-5 of its largest entry at cut None,
  0, 1, ``enc_layers``, ``enc_layers + 1`` and the head's, with the
  leaves below each cut getting none.
- ``lomo_pieces`` chained is ``loss_fn`` bit for bit.
- Serving: ``prefill`` and three decode steps (logits, self-attention
  cache, memory) within 1e-4 of JAX's at fp32, within 2e-2 of the
  logits' largest entry at bf16 (``chip_smoke.py``'s bf16 ``TOL``), from
  the same bf16 weights; ``ServeEngine``'s greedy tokens equal to the
  JAX engine's on a padded batch of mixed lengths, and its
  ``ValueError`` without ``src_embeds``, as the reference's.
- Runner level against JAX's ``make_runner``, two steps each
  (``test_torch_moe.run_both``'s tolerances): every strategy, HiFT at
  m = 1 and at m = 2, whose second group spans ``enc[1]`` and ``dec[0]``;
  the staged fused path (``lomo``/``adalomo``) against the reference's
  own pieces; one NF4 HiFT step (every frozen projection of both stacks
  and the frozen head through the dequant matmul, nothing decoded whole).
- A checkpoint round trip of an encdec ``TrainState``; the launchers at
  ``--smoke --device cpu``; ``chip_smoke.py``'s encdec phases rehearsed on
  the CPU.
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
from repro.core.strategy import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import (flatten_with_paths,  # noqa: E402
                                       tree_cast, tree_map,
                                       unflatten_from_paths)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import (HiFTConfig, LiSAConfig, QuantConfig,  # noqa: E402
                              strategy_ids)
from repro_torch.dist import quant as Q  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import get_family  # noqa: E402
from repro_torch.models.base import layer_at  # noqa: E402
from repro_torch.serve import engine as TS  # noqa: E402
from test_torch_mezo import jax_step_noise  # noqa: E402
from test_torch_moe import _jax, _np, _port, _tb, run_both  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401

F32 = torch.float32
JCFG = dataclasses.replace(jax_get_config("seamless-m4t-large-v2",
                                          smoke=True), ce_chunk=16)
CFG = ArchConfig(**dataclasses.asdict(JCFG))
S_ENC, S_DEC = 24, 32


@functools.lru_cache(maxsize=None)
def _np_params(seed=5):
    shapes = flatten_with_paths(jax.eval_shape(
        lambda: JE.init(JCFG, jax.random.PRNGKey(0))))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, sd in shapes.items():
        z = rng.standard_normal(sd.shape)
        leaf = path.split("/")[-1]
        if leaf == "scale":
            z = 1 + 0.1 * z
        elif leaf == "tok":
            z = 0.02 * z
        elif leaf.startswith("b"):
            z = 0.1 * z
        else:
            z = z / np.sqrt(sd.shape[-2])
        flat[path] = z.astype(np.float32)
    return unflatten_from_paths(flat)


def _batches(n, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return [{"src_embeds": rng.standard_normal(
                (b, S_ENC, CFG.d_model)).astype(np.float32),
             "tokens": rng.integers(0, CFG.vocab, (b, S_DEC)).astype(np.int32),
             "labels": rng.integers(0, CFG.vocab, (b, S_DEC)).astype(np.int32)}
            for _ in range(n)]


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jp():
    return jax.tree.map(jnp.asarray, _np_params())


# ------------------------------------------------------------ model level

def test_config_registry_and_init_match_the_reference():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config("seamless-m4t-large-v2",
                                             smoke=smoke)) == \
            dataclasses.asdict(jax_get_config("seamless-m4t-large-v2",
                                              smoke=smoke))
    assert get_family(CFG) is TE
    assert [u.label() for u in TE.unit_spec(CFG)] == \
        [u.label() for u in JE.unit_spec(JCFG)]
    for u in TE.unit_spec(CFG):
        assert TE.unit_first_depth(CFG, u) == JE.unit_first_depth(JCFG, u)
    want = flatten_with_paths(jax.eval_shape(
        lambda: JE.init(JCFG, jax.random.PRNGKey(0))))
    got = flatten_with_paths(TE.init(CFG, torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    full = get_config("seamless-m4t-large-v2")
    p = TE.init(full, torch.Generator(), device="meta")
    assert p["dec"]["cross_attn"]["wk"].shape == (24, 1024, 16 * 64)
    assert p["head"]["w"].shape == (1024, 256_256)


def test_encode_and_apply_match_jax():
    b = _batches(1)[0]
    tp = bridge.to_torch(_np_params())
    got = TE.encode(CFG, tp, torch.from_numpy(b["src_embeds"]),
                    compute_dtype=F32)
    want = jax.jit(lambda p, x: JE.encode(JCFG, p, x,
                                          compute_dtype=jnp.float32))(
        _jp(), jnp.asarray(b["src_embeds"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    got = TE.apply(CFG, tp, _tb(b), compute_dtype=F32)
    want = jax.jit(lambda p, x: JE.apply(JCFG, p, x,
                                         compute_dtype=jnp.float32))(
        _jp(), _jb(b))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


CUTS = {"none": None, "0": 0, "1": 1, "enc": 2, "dec1": 3, "head": 4}


@pytest.mark.parametrize("name", list(CUTS))
def test_loss_and_grads_match_jax(name):
    """Loss and every leaf's gradient at each cut; the leaves below the cut
    get none: from ``enc_layers`` on the whole encoder and ``src_proj``,
    above it the decoder's lower layers too."""
    cut = CUTS[name]
    b = _batches(1)[0]
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JE.loss_fn(
        JCFG, p, _jb(b), cut=cut, compute_dtype=jnp.float32)))(_jp())
    tp = bridge.to_torch(_np_params())
    flat = flatten_with_paths(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl = TE.loss_fn(CFG, tp, _tb(b), cut=cut, compute_dtype=F32)
    gs = torch.autograd.grad(tl, list(flat.values()), allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=1e-6)
    want = _np(jax.tree.map(np.asarray, jg))
    for (path, t), g in zip(flat.items(), gs):
        g = np.zeros(t.shape, np.float32) if g is None else g.numpy()
        w = want[path]
        np.testing.assert_allclose(
            g, w, rtol=0, atol=1e-5 * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"cut={cut}: {path}")
        below = cut is not None and (
            path.startswith("embed") or
            path.startswith("enc") and cut >= CFG.enc_layers)
        if below:
            assert not np.any(g), f"cut={cut}: {path} has a gradient"
    if cut == CFG.enc_layers + 1:
        g_dec = dict(zip(flat, gs))["dec/mlp/w_up"].numpy()
        assert not np.any(g_dec[0]) and np.any(g_dec[1])


def test_lomo_pieces_compose_to_loss_fn():
    tp = bridge.to_torch(_np_params())
    batch = _tb(_batches(1)[0])
    pieces = TE.lomo_pieces(CFG, compute_dtype=F32)
    assert pieces.stage_keys == ("enc", "dec")
    ep, stages, sp, hp = pieces.split(tp)
    assert sp is None
    with torch.no_grad():
        want = TE.loss_fn(CFG, tp, batch, compute_dtype=F32)
        h, side = None, None
        for i, stack in enumerate(stages):
            h, side = pieces.stage_inits[i](ep, h, batch)
            for j in range(CFG.enc_layers if i == 0 else CFG.dec_layers):
                h = pieces.stage_fns[i](layer_at(stack, j), sp, side, h)
        got = pieces.head_loss_fn(hp, ep, h, batch)
    assert float(got) == float(want)
    merged = pieces.merge(ep, stages, sp, hp)
    assert merged["enc"] is tp["enc"] and merged["dec"] is tp["dec"]


# ------------------------------------------------------------ serving

def _serve_inputs(b=3, s=12, seed=4):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, S_ENC, CFG.d_model)).astype(np.float32)
    toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    nxt = [rng.integers(0, CFG.vocab, (b, 1)).astype(np.int32)
           for _ in range(3)]
    return src, toks, nxt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill, then three decode steps on the same tokens: the logits,
    the self-attention cache and the stored memory.  bf16: both packages
    start from the same bf16 weights (the port's engines cast once, JAX
    casts at use) and compute in bf16."""
    jdt, tdt = (jnp.float32, F32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    npp = _np_params()
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), npp)
    tp = tree_cast(bridge.to_torch(npp), tdt)
    src, toks, nxt = _serve_inputs()
    b, s, max_len = toks.shape[0], toks.shape[1], 16
    tol = 1e-4 if dtype == "float32" else None

    def close(got, want, what):
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        if tol is not None:
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                                       err_msg=what)
        else:
            err = float(np.abs(got - want).max())
            assert err <= 2e-2 * float(np.abs(want).max()), (what, err)

    jprefill = jax.jit(lambda p, x, c: JE.prefill(JCFG, p, x, c,
                                                  compute_dtype=jdt))
    jdecode = jax.jit(lambda p, c, t: JE.decode_step(JCFG, p, c, t,
                                                     compute_dtype=jdt))
    jcache = JE.init_cache(JCFG, b, max_len, S_ENC, dtype=jdt)
    jl, jcache = jprefill(jp, {"src_embeds": jnp.asarray(src),
                               "tokens": jnp.asarray(toks)}, jcache)
    tcache = TE.init_cache(CFG, b, max_len, S_ENC, dtype=tdt)
    tl, tcache = TE.prefill(CFG, tp, {"src_embeds": torch.from_numpy(src),
                                      "tokens": torch.from_numpy(toks).long()},
                            tcache, compute_dtype=tdt)
    close(tl, jl, "prefill logits")
    close(tcache["memory"], jcache["memory"], "memory")
    assert tcache["memory"].dtype == tdt
    for step, n in enumerate(nxt):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(n))
        tl, tcache = TE.decode_step(CFG, tp, tcache,
                                    torch.from_numpy(n).long(),
                                    compute_dtype=tdt)
        close(tl, jl, f"decode {step}")
    for key in ("k", "v"):
        close(tcache[key], jcache[key], key)
    assert tcache["pos"] == int(jcache["pos"]) == s + 3


def test_engine_matches_jax_and_needs_src_embeds():
    """Greedy tokens of a padded batch of mixed lengths (the left pad
    attends, as in the reference) equal the JAX engine's; both engines
    refuse a call without ``src_embeds`` (the port also one whose rows are
    not the batch's); the continuous engine refuses encdec, as the
    reference's does."""
    from repro.serve.engine import ContinuousServeEngine as JaxCont
    npp = _np_params()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab, n).astype(np.int32)
               for n in (10, 4, 7)]
    src = rng.standard_normal((4, 20, CFG.d_model)).astype(np.float32)
    jeng = JaxServe(JCFG, jax.tree.map(jnp.asarray, npp), max_len=20,
                    batch=4, compute_dtype=jnp.float32)
    want = jeng.generate([jnp.asarray(p) for p in prompts], max_new_tokens=5,
                         src_embeds=jnp.asarray(src))
    eng = TS.ServeEngine(CFG, bridge.to_torch(npp), max_len=20, batch=4,
                         compute_dtype=F32, device="cpu")
    assert eng.generate(prompts, max_new_tokens=5,
                        src_embeds=torch.from_numpy(src)) == want
    with pytest.raises(ValueError, match="src_embeds"):
        eng.generate(prompts, max_new_tokens=2,
                     src_embeds=torch.from_numpy(src[:3]))
    with pytest.raises(ValueError, match="src_embeds"):
        jeng.generate([jnp.asarray(p) for p in prompts], max_new_tokens=2)
    with pytest.raises(ValueError, match="src_embeds"):
        eng.generate(prompts, max_new_tokens=2)
    with pytest.raises(ValueError, match="dense"):
        JaxCont(JCFG, None)
    with pytest.raises(ValueError, match="dense"):
        TS.ContinuousServeEngine(CFG, bridge.to_torch(npp), device="cpu")


# ------------------------------------------------------------ runner level

STRATEGIES = {
    "hift_m1": ("hift", {"hift": HiFTConfig(m=1, strategy="top2down")},
                {"hift": JHiFTConfig(m=1, strategy="top2down")}, "adam"),
    "hift_m2": ("hift", {"hift": HiFTConfig(m=2, strategy="top2down")},
                {"hift": JHiFTConfig(m=2, strategy="top2down")}, "adam"),
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


@functools.lru_cache(maxsize=None)
def _start_grads():
    b = _batches(1, seed=1)[0]
    g = jax.jit(jax.grad(lambda p: JE.loss_fn(
        JCFG, p, _jb(b), compute_dtype=jnp.float32)))(_jp())
    return _np(jax.tree.map(np.asarray, g))


def _run_both(strategy, pkw, jkw, update, steps=2):
    npp = _np_params()
    if strategy == "mezo":
        pkw = dict(pkw, noise=jax_step_noise(npp))
    return run_both(JCFG, CFG, npp, strategy, steps, pkw, jkw, update,
                    start_grads=_start_grads(), batches=_batches)


def test_every_registered_strategy_is_covered():
    assert {v[0] for v in STRATEGIES.values()} == set(strategy_ids())


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_matches_the_jax_runner(name):
    strategy, pkw, jkw, update = STRATEGIES[name]
    tr, jr = _run_both(strategy, pkw, jkw, update)
    if strategy == "hift":
        labels = [tr.group_for_step(s).label() for s in range(2)]
        assert labels == [jr.group_for_step(s).label() for s in range(2)]
        if name == "hift_m2":     # top2down: (dec[1], head), (enc[1], dec[0])
            assert labels[1] == "g1(enc[1:2],dec[0:1])"
    if strategy in ("lomo", "adalomo"):
        assert tr.strategy._pieces is not None     # the staged fused path


def test_nf4_hift_step_matches_jax():
    """One NF4 HiFT step (bf16 moments) on the embed group: every frozen
    projection of both stacks (a layer view each) and the frozen head
    multiply through the dequant matmul, and the only records decoded
    whole are the active group's (its fp32 master, on the first visit)."""
    from repro_torch.kernels import dequant_matmul as DM
    npp = _np_params()
    tr = _port(CFG, npp, "hift", hift=HiFTConfig(m=1),
               quant=QuantConfig("nf4", "bf16"))
    jr = _jax(JCFG, npp, "hift", hift=JHiFTConfig(m=1),
              quant=JQuantConfig("nf4", "bf16"))
    assert tr.group_for_step(0).label() == jr.group_for_step(0).label() == \
        "g0(embed)"
    params = tr.params
    want = {(params["head"]["w"]["q"].data_ptr(), (CFG.d_model,
                                                   CFG.vocab_padded))}
    recs = []
    tree_map(recs.append, {k: params[k] for k in ("enc", "dec")},
             is_leaf=Q.is_quantized)
    for rec in recs:
        if Q.is_quantized(rec) and len(Q.quant_shape(rec)) == 3:
            want |= {(rec["q"][i].data_ptr(), Q.quant_shape(rec)[1:])
                     for i in range(rec["q"].shape[0])}
    seen, decoded = set(), []
    real_dm, real_dq = DM.dequant_matmul, Q.dequantize_leaf

    def dm(x, w):
        seen.add((w.q.data_ptr(), tuple(w.shape)))
        return real_dm(x, w)

    def dq(leaf):
        decoded.append(leaf["q"].data_ptr())
        return real_dq(leaf)

    active = {params["embed"][k]["q"].data_ptr() for k in ("src_proj", "tok")}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(DM, "dequant_matmul", dm)
        mp.setattr(Q, "dequantize_leaf", dq)
        b = _batches(1, seed=2)[0]
        np.testing.assert_allclose(float(tr.train_step(_tb(b))),
                                   float(jr.train_step(_jb(b))), rtol=0,
                                   atol=1e-5)
    finally:
        mp.undo()
    assert want <= seen, sorted(want - seen)[:4]
    assert decoded and set(decoded) <= active
    rec = tr.params["dec"]["cross_attn"]["wk"]
    assert set(rec) == {"q", "s", "t"} and rec["q"].dtype == torch.uint8


def test_checkpoint_round_trip(tmp_path):
    """An encdec HiFT state saved after a step and restored continues
    exactly as the live runner does."""
    from repro_torch.train import checkpoint as ckpt
    npp = _np_params()
    b0, b1 = (_tb(b) for b in _batches(2, seed=6))
    live = _port(CFG, npp, "hift", hift=HiFTConfig(m=2))
    live.train_step(b0)
    ckpt.save(tmp_path, 1, live.state_dict())
    back = _port(CFG, npp, "hift", hift=HiFTConfig(m=2))
    back.load_state_dict(ckpt.restore(tmp_path, 1))
    assert float(back.train_step(b1)) == float(live.train_step(b1))
    for path, t in flatten_with_paths(live.params).items():
        assert torch.equal(t, flatten_with_paths(back.params)[path]), path


# ------------------------------------------------------------ the rest

@pytest.mark.parametrize("strategy", ["hift", "fpft", "lomo", "adalomo",
                                      "mezo"])
def test_launcher_trains_seamless_on_cpu(strategy, capsys):
    from repro_torch.launch import train as train_cli
    out = train_cli.main(["--arch", "seamless-m4t-large-v2", "--smoke",
                          "--steps", "2", "--batch", "2", "--seq", "16",
                          "--device", "cpu", "--strategy", strategy])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    text = capsys.readouterr().out
    assert "family=encdec" in text and "done: final loss" in text


def test_source_stub_draws_frames_per_step():
    from repro_torch.data.synthetic import (DataConfig, SourceStubLM,
                                            SyntheticLM)
    src = SourceStubLM(SyntheticLM(DataConfig(vocab=512, seq_len=16,
                                              global_batch=2)), 64)
    a, b = src.batch_at(0), src.batch_at(1)
    assert a["src_embeds"].shape == (2, 16, 64)
    assert torch.equal(a["src_embeds"], src.batch_at(0)["src_embeds"])
    assert not torch.equal(a["src_embeds"], b["src_embeds"])


def test_launcher_serves_seamless_on_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "seamless-m4t-large-v2", "--device", "cpu",
                       "--requests", "2", "--max-new", "3"])
    assert len(outs) == 2 and all(len(o) == 3 for o in outs)
    assert "served 2 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="dense"):
        serve.main(["--arch", "seamless-m4t-large-v2", "--device", "cpu",
                    "--continuous"])


def test_chip_smoke_encdec_phases_run_small_on_the_cpu(capsys):
    """``chip_smoke.py``'s card-against-CPU encdec phases, rehearsed on
    the CPU alone at SMOKE width (both sides the CPU): every run emits its
    line and no loss, norm or token differs; the kernel cases' work counts
    every (query, key) pair of the non-causal calls."""
    import json

    from test_torch_training import _chip_smoke
    chip_smoke = _chip_smoke()
    chip_smoke.phase_train_encdec_card_vs_cpu(torch, cfg=CFG,
                                              devices=("cpu", "cpu"))
    chip_smoke.phase_serve_encdec_card_vs_cpu(torch, cfg=CFG,
                                              devices=("cpu", "cpu"))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [d.get("run") for d in lines] == ["hift", "lomo", "adalomo",
                                             "mezo", None]
    assert all(d["max_rel_loss_gap"] == 0.0 for d in lines[:4])
    assert lines[0]["groups"] == ["g0(embed)", "g1(enc[0:1])",
                                  "g2(enc[1:2])", "g3(dec[0:1])"]
    assert lines[4]["tokens_equal"]
    cases = chip_smoke.encdec_attention_cases()
    assert len(cases) == 8
    flops, nbytes = chip_smoke.work(*cases[2][0:1], "bfloat16", cases[2][3])
    assert flops == 4 * 64 * 16 * 4 * 37 * 300
    assert nbytes == 4 * (2 * 37 + 2 * 300) * 16 * 64 * 2
