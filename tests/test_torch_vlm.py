"""The port's vlm family (internvl2-26b's LM backbone with its stub
frontend), held against the JAX package on the CPU.

Same weights (the JAX ``init`` tree's shapes filled from a numpy seed:
dense weights N(0, 1) / sqrt(fan_in), embedding 0.02, norm scales
1 + 0.1 z), bridged to torch; tokens, labels and ``vision_embeds`` (B, vt,
D) from a numpy seed; internvl2-26b's SMOKE twin (2 layers, vt = 8,
GQA 4 over 2) with ``ce_chunk = 16``, fp32 throughout.

- ``apply`` logits (vision positions included, as the reference's) within
  1e-5, and ``loss_fn`` (text positions only) and every leaf's gradient
  against ``jax.grad`` at cut None / 0 / 1: losses within 1e-6,
  gradients within 1e-5 of each leaf's largest entry.
- ``prefill`` with ragged left pad behind the vision prefix, then decode:
  logits within 1e-4 of JAX's, and the k/v cache at every valid position
  (pad positions hold what the pad tokens computed and are never read).
- The plain attention versions with ``prefix`` against an oracle built
  from an explicit (B, S) mask in float64, within 1e-5, valid rows only;
  ``prefix = 0`` gives the left-pad attention bit for bit.
- ``ServeEngine``'s greedy tokens equal to the JAX engine's (zero vision
  embeddings in front of left-padded prompts).
- Two HiFT steps against the JAX runner (losses within 1e-5).
- The reference's continuous engine admits vlm and then fails in its first
  prefill (``KeyError: 'vision_embeds'``); the port's refuses vlm at
  construction.
- The launchers with ``--arch internvl2-26b --smoke --device cpu``.
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
from repro.core import LRSchedule as JLRSchedule  # noqa: E402
from repro.core import make_runner as jax_make_runner  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import ContinuousServeEngine as JaxCont  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServe  # noqa: E402
from repro.serve.scheduler import ServeRequest as JReq  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import (flatten_with_paths,  # noqa: E402
                                       unflatten_from_paths)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import HiFTConfig, LRSchedule, make_runner  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import get_family  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401

F32 = torch.float32
LR = 1e-3
JCFG = dataclasses.replace(jax_get_config("internvl2-26b", smoke=True),
                           ce_chunk=16)
CFG = ArchConfig(**dataclasses.asdict(JCFG))
VT = CFG.vision_tokens


@functools.lru_cache(maxsize=None)
def _np_params(seed=6):
    shapes = flatten_with_paths(jax.eval_shape(
        lambda: JT.init(JCFG, jax.random.PRNGKey(0))))
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


def _batches(n, seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, CFG.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, CFG.vocab, (b, s)).astype(np.int32),
             "vision_embeds": rng.standard_normal(
                 (b, VT, CFG.d_model)).astype(np.float32)}
            for _ in range(n)]


def _tb(batch):
    return {k: (torch.from_numpy(v) if v.dtype == np.float32
                else torch.from_numpy(v).long()) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(tree):
    return {p: np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                          else x)
            for p, x in flatten_with_paths(tree).items()}


# ------------------------------------------------------------ model level

def test_apply_matches_jax_with_the_vision_prefix():
    npp = _np_params()
    batch = _batches(1)[0]
    want = np.asarray(JT.apply(JCFG, jax.tree.map(jnp.asarray, npp),
                               _jb(batch), compute_dtype=jnp.float32))
    with torch.no_grad():
        got = TT.apply(CFG, bridge.to_torch(npp), _tb(batch),
                       compute_dtype=F32).numpy()
    assert got.shape == want.shape == (2, VT + 32, CFG.vocab_padded)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _grads(cut):
    npp = _np_params()
    batch = _batches(1)[0]
    jl, jg = jax.value_and_grad(lambda p: JT.loss_fn(
        JCFG, p, _jb(batch), cut=cut, compute_dtype=jnp.float32))(
            jax.tree.map(jnp.asarray, npp))
    tp = bridge.to_torch(npp)
    flat = flatten_with_paths(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl = TT.loss_fn(CFG, tp, _tb(batch), cut=cut, compute_dtype=F32)
    gs = torch.autograd.grad(tl, list(flat.values()), allow_unused=True)
    tg = {p: (np.zeros(t.shape, np.float32) if g is None else g.numpy())
          for (p, t), g in zip(flat.items(), gs)}
    return float(jl), _np(jax.tree.map(np.asarray, jg)), float(tl.detach()), tg


@pytest.mark.parametrize("cut", [None, 0, 1], ids=["fpft", "cut0", "cut1"])
def test_loss_and_grads_match_jax(cut):
    jl, jg, tl, tg = _grads(cut)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6)
    assert tg.keys() == jg.keys()
    for path, w in jg.items():
        np.testing.assert_allclose(
            tg[path], w, rtol=0,
            atol=1e-5 * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"cut={cut}: {path}")


def test_lomo_pieces_compose_to_loss_fn():
    tp = bridge.to_torch(_np_params())
    batch = _tb(_batches(1)[0])
    embed_fn, block_fn, head_loss_fn = TT.lomo_pieces(CFG, compute_dtype=F32)
    with torch.no_grad():
        want = TT.loss_fn(CFG, tp, batch, compute_dtype=F32)
        h = embed_fn(tp["embed"], batch)
        assert h.shape[1] == VT + 32
        for i in range(CFG.n_layers):
            h = block_fn({k: (v[i] if not isinstance(v, dict) else
                              {kk: vv[i] for kk, vv in v.items()})
                          for k, v in tp["layers"].items()}, h)
        got = head_loss_fn(tp["head"], tp["embed"], h, batch)
    assert float(got) == float(want)


# ------------------------------------------------------------ serving

def _ragged(b=3, s=12, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    pad = np.array([0, 5, 9][:b], np.int32)
    vis = rng.standard_normal((b, VT, CFG.d_model)).astype(np.float32)
    return toks, pad, vis


def test_prefill_and_decode_with_pad_behind_the_prefix_match_jax():
    npp = _np_params()
    jp, tp = jax.tree.map(jnp.asarray, npp), bridge.to_torch(npp)
    toks, pad, vis = _ragged()
    b, s = toks.shape
    max_len = VT + s + 4
    jcache = JT.init_cache(JCFG, b, max_len, dtype=jnp.float32)
    jl, jcache = JT.prefill(JCFG, jp, {"tokens": jnp.asarray(toks),
                                       "pad": jnp.asarray(pad),
                                       "vision_embeds": jnp.asarray(vis)},
                            jcache, compute_dtype=jnp.float32)
    tcache = TT.init_cache(CFG, b, max_len, dtype=F32)
    tl, tcache = TT.prefill(CFG, tp, {"tokens": torch.from_numpy(toks).long(),
                                      "pad": torch.from_numpy(pad),
                                      "vision_embeds": torch.from_numpy(vis)},
                            tcache, compute_dtype=F32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    valid = np.asarray(JT._pad_valid(JCFG, jnp.asarray(pad), VT + s))
    rng = np.random.default_rng(5)
    for step in range(3):
        for key in ("k", "v"):
            got = tcache[key].numpy()[:, :, :VT + s]
            want = np.asarray(jcache[key])[:, :, :VT + s]
            np.testing.assert_allclose(got[:, valid], want[:, valid],
                                       atol=1e-4, rtol=1e-4)
        nxt = rng.integers(0, CFG.vocab, (b, 1)).astype(np.int32)
        jl, jcache = JT.decode_step(JCFG, jp, jcache, jnp.asarray(nxt),
                                    compute_dtype=jnp.float32)
        tl, tcache = TT.decode_step(CFG, tp, tcache,
                                    torch.from_numpy(nxt).long(),
                                    compute_dtype=F32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4, err_msg=f"decode {step}")
    assert tcache["pos"] == int(jcache["pos"]) == VT + s + 3


def _oracle(q, k, v, valid):
    """Attention of float64 copies with an explicit (B, S_q, S_k) mask."""
    n_rep = q.shape[-2] // k.shape[-2]
    k = k.double().repeat_interleave(n_rep, dim=-2)
    v = v.double().repeat_interleave(n_rep, dim=-2)
    sc = torch.einsum("b...qhd,bkhd->bhqk", q.double().reshape(
        q.shape[0], -1, *q.shape[-2:]), k) / np.sqrt(q.shape[-1])
    sc = sc.masked_fill(~valid[:, None], -np.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)


@pytest.mark.parametrize("prefix", [0, 8, 21])
def test_plain_attention_with_prefix_matches_a_mask_oracle(prefix):
    g = torch.Generator().manual_seed(prefix)
    b, s, h, kvh, hd = 3, 40, 6, 2, 16
    q = torch.randn(b, s, h, hd, generator=g)
    k = torch.randn(b, s, kvh, hd, generator=g)
    v = torch.randn(b, s, kvh, hd, generator=g)
    starts = torch.tensor([0, 7, 40 - prefix - 1], dtype=torch.int32)
    pos = torch.arange(s)
    key_ok = (pos[None] < prefix) | (pos[None] >= prefix + starts[:, None])
    causal = pos[:, None] >= pos[None, :]
    got = ref.flash_attention_ref(q, k, v, starts, True, prefix)
    want = _oracle(q, k, v, key_ok[:, None, :] & causal[None])
    rows = key_ok                       # valid query rows
    np.testing.assert_allclose(got[rows].numpy(), want[rows].numpy(),
                               rtol=0, atol=1e-5)
    if prefix == 0:
        assert torch.equal(got, ref.flash_attention_ref(q, k, v, starts))
    lengths = torch.tensor([40, 33, 40], dtype=torch.int32)
    qd = q[:, -1]
    got = ref.flash_decode_ref(qd, k, v, lengths, starts, prefix)
    want = _oracle(qd[:, None], k, v,
                   (key_ok & (pos[None] < lengths[:, None]))[:, None])[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    # the wrappers on CPU tensors are the plain versions
    from repro_torch.kernels import flash_attention as K
    assert torch.equal(K.flash_decode(qd, k, v, lengths, starts, prefix),
                       got)
    with pytest.raises(ValueError, match="prefix"):
        K.flash_attention(q, k, v, starts, prefix=s + 1)


def test_engine_matches_jax_on_mixed_length_prompts():
    npp = _np_params()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab, n).astype(np.int32)
               for n in (10, 4, 7)]
    want = JaxServe(JCFG, jax.tree.map(jnp.asarray, npp), max_len=VT + 16,
                    batch=4, compute_dtype=jnp.float32).generate(
        [jnp.asarray(p) for p in prompts], max_new_tokens=5)
    eng = TE.ServeEngine(CFG, bridge.to_torch(npp), max_len=VT + 16, batch=4,
                         compute_dtype=F32, device="cpu")
    assert eng.generate(prompts, max_new_tokens=5) == want
    with pytest.raises(ValueError, match="vision tokens"):
        eng.generate(prompts, max_new_tokens=8)


def test_continuous_engine_fails_on_vlm_in_the_reference_and_is_refused():
    """The reference admits vlm (its pad families) and then fails in its
    first prefill: ``_start`` builds no ``vision_embeds``."""
    npp = jax.tree.map(jnp.asarray, _np_params())
    eng = JaxCont(JCFG, npp, slots=2, block_size=8, prefill_bucket=16)
    with pytest.raises(KeyError, match="vision_embeds"):
        eng.run([JReq(prompt=[1, 2, 3], max_new_tokens=2)])
    with pytest.raises(ValueError, match="vision_embeds"):
        TE.ContinuousServeEngine(CFG, bridge.to_torch(_np_params()),
                                 device="cpu")


# ------------------------------------------------------------ training

def test_two_hift_steps_match_the_jax_runner():
    npp = _np_params()
    tr = make_runner(CFG, "hift", params=bridge.to_torch(npp),
                     schedule=LRSchedule(base_lr=LR), device="cpu",
                     hift=HiFTConfig(m=2, strategy="top2down"))
    jr = jax_make_runner(JCFG, "hift",
                         params=jax.tree.map(jnp.asarray, npp),
                         schedule=JLRSchedule(base_lr=LR),
                         hift=JHiFTConfig(m=2, strategy="top2down"))
    for i, b in enumerate(_batches(2, seed=1)):
        np.testing.assert_allclose(float(tr.train_step(_tb(b))),
                                   float(jr.train_step(_jb(b))), rtol=0,
                                   atol=1e-5, err_msg=f"step {i}")
    assert [tr.group_for_step(s).label() for s in range(2)] == \
        [jr.group_for_step(s).label() for s in range(2)]
    assert get_family(CFG) is TT


@pytest.mark.parametrize("strategy", ["hift", "hift_pipelined", "lisa",
                                      "fpft", "fpft_streamed", "lomo",
                                      "adalomo", "mezo"])
def test_launcher_trains_internvl2_on_cpu(strategy, capsys):
    from repro_torch.launch import train as train_cli
    out = train_cli.main(["--arch", "internvl2-26b", "--smoke", "--steps",
                          "2", "--batch", "2", "--seq", "32", "--device",
                          "cpu", "--strategy", strategy])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    text = capsys.readouterr().out
    assert "family=vlm" in text and "done: final loss" in text


def test_launcher_serves_internvl2_on_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "internvl2-26b", "--device", "cpu",
                       "--requests", "2", "--max-new", "3"])
    assert len(outs) == 2 and all(len(o) == 3 for o in outs)
    assert "served 2 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="vlm"):
        serve.main(["--arch", "internvl2-26b", "--device", "cpu",
                    "--continuous"])


def test_vision_stub_draws_per_step_from_the_seed():
    from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                            VisionStubLM)
    src = VisionStubLM(SyntheticLM(DataConfig(vocab=CFG.vocab, seq_len=8,
                                              global_batch=2, seed=3)),
                       VT, CFG.d_model)
    a, b = src.batch_at(0), src.batch_at(1)
    assert a["vision_embeds"].shape == (2, VT, CFG.d_model)
    assert torch.equal(a["vision_embeds"], src.batch_at(0)["vision_embeds"])
    assert not torch.equal(a["vision_embeds"], b["vision_embeds"])


def test_chip_smoke_serving_phase_runs_small_on_the_cpu(capsys):
    """``chip_smoke.py``'s card-against-CPU moe and vlm serving phase,
    rehearsed on the CPU alone at SMOKE width: one line an arch, the same
    tokens and no route flip."""
    import json

    from test_torch_training import _chip_smoke
    _chip_smoke().phase_serve_moe_vlm_card_vs_cpu(torch, smoke=True,
                                                  devices=("cpu", "cpu"))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [d["arch"] for d in lines] == ["deepseek-moe-smoke",
                                          "internvl2-smoke"]
    assert all(d["tokens_equal"] and d["route_flips"] == 0 for d in lines)
    assert lines[0]["routes"] > 0 and lines[1]["routes"] == 0
