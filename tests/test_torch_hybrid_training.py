"""The port's hybrid training slice (zamba2), held against the JAX package
on the CPU.

Same weights (``test_torch_hybrid_serving._np_params``: the JAX init's
shapes filled from a numpy seed, the SSM scalars at a slow decay, since
the reference's fp32 chunked scan loses ~6e-4 at the published init),
bridged to torch; batches of 2 x 32 tokens and labels from a numpy seed;
the SMOKE config (4 layers, two super-blocks of ``attn_every = 2``) with
``ce_chunk = 16``, so the head's graph holds two checkpointed CE blocks.
fp32 throughout.

- Model level, without jit: the loss and the gradient of every leaf at
  ``cut`` in {None, 0, 1, attn_every, n_layers} against ``jax.grad`` of
  ``repro.models.zamba2.loss_fn``: losses within 1e-6, each gradient
  within 1e-5 of its leaf's largest entry (the same math summed in other
  orders; 3e-6 was seen).  At ``cut = attn_every`` (the shared unit's
  HiFT cut) super-block 0 runs below the cut in both packages, so the
  shared block's gradient is not FPFT's: held to the reference's, and to
  differ from FPFT's by more than 10 % of its largest entry.
- ``lomo_pieces`` chained is ``loss_fn`` bit for bit, and ``split``
  returns views of the stacked layers (an in-place write shows).
- Runner level against JAX's ``make_runner``: ``hift`` (m = 2, top2down:
  head; layer 3 + shared; layers 1-2; embed + layer 0), every other
  strategy for two steps (MeZO on JAX's z through ``noise=``), and one
  NF4 HiFT step: losses and params as ``_run_both`` states (LOMO and
  MeZO within 1e-5; AdamW's and AdaLomo's first updates are about
  lr sign(g), so a gradient near zero that rounds to the other sign moves
  its element 2 lr apart).  The backward through an NF4/int8 frozen tree
  at the model level (gradients within 1e-5 of each leaf's largest
  entry).  ``lomo`` and ``adalomo`` update the
  shared block once with the gradient summed over both applications,
  ``hift`` with the reference's super-block cut.
- ``chip_smoke.py``'s card-against-CPU hybrid phase, rehearsed at SMOKE
  width with the CPU on both sides.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HiFTConfig as JHiFTConfig  # noqa: E402
from repro.core import LRSchedule as JLRSchedule  # noqa: E402
from repro.core import make_runner as jax_make_runner  # noqa: E402
from repro.core.strategy import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import zamba2 as JZ  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import (flatten_with_paths,  # noqa: E402
                                       tree_map, unflatten_from_paths)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import (HiFTConfig, LRSchedule,  # noqa: E402
                              QuantConfig, make_runner)
from repro_torch.models import zamba2 as TZ  # noqa: E402
from repro_torch.models.base import LayerStack, layer_at  # noqa: E402
from test_torch_hybrid_serving import JCFG as _JSMOKE  # noqa: E402
from test_torch_hybrid_serving import _np_params  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401

JCFG = dataclasses.replace(_JSMOKE, ce_chunk=16)
CFG = ArchConfig(**dataclasses.asdict(JCFG))
LR = 1e-3
CUTS = [None, 0, 1, CFG.attn_every, CFG.n_layers]


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, CFG.vocab, (2, 32)).astype(np.int32),
             "labels": rng.integers(0, CFG.vocab, (2, 32)).astype(np.int32)}
            for _ in range(n)]


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


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


@functools.lru_cache(maxsize=None)
def _grads(cut):
    """(JAX loss, JAX grads, port loss, port grads) at ``cut``."""
    npp = _np_params()
    batch = _batches(1)[0]
    jl, jg = jax.value_and_grad(lambda p: JZ.loss_fn(
        JCFG, p, _jb(batch), cut=cut, compute_dtype=jnp.float32))(
            jax.tree.map(jnp.asarray, npp))
    tp = bridge.to_torch(npp)
    flat = flatten_with_paths(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl = TZ.loss_fn(CFG, tp, _tb(batch), cut=cut,
                    compute_dtype=torch.float32)
    gs = torch.autograd.grad(tl, list(flat.values()), allow_unused=True)
    tg = {p: (np.zeros(t.shape, np.float32) if g is None else g.numpy())
          for (p, t), g in zip(flat.items(), gs)}
    return (float(jl), _np(jax.tree.map(np.asarray, jg)), float(tl.detach()),
            tg)


# ------------------------------------------------------------ model level

@pytest.mark.parametrize("cut", CUTS, ids=[f"cut{c}" for c in CUTS])
def test_loss_and_grads_match_jax(cut):
    jl, jg, tl, tg = _grads(cut)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6)
    _assert_rel_close(tg, jg, err=f"cut={cut}: ")
    # below the (rounded) cut nothing gets a gradient, in both packages
    if cut is not None and cut >= CFG.attn_every:
        assert not np.any(tg["embed/tok"])
        assert not np.any(tg["layers/mamba/in_proj"][:CFG.attn_every])


def test_shared_hift_gradient_follows_the_reference_cut_not_fpft():
    """The shared unit's HiFT cut is ``attn_every``, rounded down to
    super-block 0's end: its first application runs without a graph, so
    HiFT's shared gradient drops it where FPFT's sums both."""
    _, fpft, _, tfpft = _grads(None)
    _, hift, _, thift = _grads(CFG.attn_every)
    for path in fpft:
        if not path.startswith("shared/"):
            continue
        scale = float(np.abs(fpft[path]).max())
        assert np.abs(hift[path] - fpft[path]).max() > 0.1 * scale, path
        assert np.abs(thift[path] - tfpft[path]).max() > 0.1 * scale, path
    assert TZ.unit_first_depth(CFG, TZ.unit_spec(CFG)[-2]) == CFG.attn_every


def test_unit_spec_and_first_depths_are_the_references():
    units = TZ.unit_spec(CFG)
    junits = JZ.unit_spec(JCFG)
    assert [u.label() for u in units] == [u.label() for u in junits]
    from repro.models import unit_first_depth as jfd
    from repro_torch.models.base import unit_first_depth as tfd
    assert [tfd(CFG, u) for u in units] == [jfd(JCFG, u) for u in junits]


def test_apply_takes_a_layer_stack_straddling_a_super_block():
    """A grouped strategy's ``LayerStack`` (pieces 0:1, 1:3, 3:4: each
    super-block straddles two) gives the stacked tree's logits exactly."""
    tp = bridge.to_torch(_np_params())
    batch = _tb(_batches(1)[0])
    stack = LayerStack([tree_map(lambda x, lo=lo, hi=hi: x[lo:hi],
                                 tp["layers"])
                        for lo, hi in ((0, 1), (1, 3), (3, 4))])
    with torch.no_grad():
        want = TZ.apply(CFG, tp, batch, compute_dtype=torch.float32)
        got = TZ.apply(CFG, dict(tp, layers=stack), batch,
                       compute_dtype=torch.float32)
    assert torch.equal(got, want)


def test_lomo_pieces_compose_to_loss_fn_and_split_returns_views():
    tp = bridge.to_torch(_np_params())
    batch = _tb(_batches(1)[0])
    pieces = TZ.lomo_pieces(CFG, compute_dtype=torch.float32)
    assert pieces.shared_key == "shared"
    assert pieces.liveness_m == CFG.attn_every
    ep, (sb,), sp, hp = pieces.split(tp)
    with torch.no_grad():
        want = TZ.loss_fn(CFG, tp, batch, compute_dtype=torch.float32)
        h, _ = pieces.stage_inits[0](ep, None, batch)
        for j in range(CFG.n_layers // CFG.attn_every):
            h = pieces.stage_fns[0](layer_at(sb, j), sp, None, h)
        got = pieces.head_loss_fn(hp, ep, h, batch)
    assert float(got) == float(want)
    n_sb = CFG.n_layers // CFG.attn_every
    for path, v in flatten_with_paths(sb).items():
        full = flatten_with_paths(tp["layers"])[path]
        assert v.shape[:2] == (n_sb, CFG.attn_every), path
        assert v.data_ptr() == full.data_ptr(), path
    # an in-place write through a super-block slice lands in the layers
    layer_at(sb, 1)["mamba"]["in_proj"][0].add_(1.0)
    assert torch.equal(tp["layers"]["mamba"]["in_proj"][CFG.attn_every],
                       layer_at(sb, 1)["mamba"]["in_proj"][0])
    merged = pieces.merge(ep, (sb,), sp, hp)
    for path, v in flatten_with_paths(merged).items():
        assert v.data_ptr() == flatten_with_paths(tp)[path].data_ptr()
        assert v.shape == flatten_with_paths(tp)[path].shape


# ------------------------------------------------------------ runner level

def _port(strategy, **kw):
    return make_runner(CFG, strategy, params=bridge.to_torch(_np_params()),
                       schedule=LRSchedule(base_lr=LR), device="cpu", **kw)


def _jax(strategy, **kw):
    return jax_make_runner(JCFG, strategy,
                           params=jax.tree.map(jnp.asarray, _np_params()),
                           schedule=JLRSchedule(base_lr=LR), **kw)


@functools.lru_cache(maxsize=None)
def _start_grads():
    return _grads(None)[1]


def _run_both(strategy, steps, pkw=None, jkw=None, update="linear"):
    """``steps`` steps of both runners on the same batches.  ``update``:
    "linear" (SGD, SGD-m, MeZO: the update is linear in the gradient):
    losses within 1e-5, params within atol 1e-5; "adam": AdamW's first
    step moves an element by ~lr sign(g), so where a gradient near zero
    rounds to the other sign in one package the element lands 2 lr away
    (seen: 13 of zamba2's 38,912 in_proj elements by 2e-3 after four HiFT
    steps, moving the loss by 9e-5): losses within 1e-5 before any such
    step and 2e-4 after, params within atol 1e-5 but for at most 0.1 % of
    a leaf, none beyond 2 lr steps + 1e-5; "adalomo": the same sign-like
    update, params compared where the starting gradient exceeds 1e-4."""
    tr, jr = _port(strategy, **(pkw or {})), _jax(strategy, **(jkw or {}))
    for i, b in enumerate(_batches(steps, seed=1)):
        atol = 2e-4 if update == "adam" and i >= 2 else 1e-5
        np.testing.assert_allclose(float(tr.train_step(_tb(b))),
                                   float(jr.train_step(_jb(b))), rtol=0,
                                   atol=atol, err_msg=f"{strategy} step {i}")
    got, want = _np(tr.params), _np(jax.tree.map(np.asarray, jr.params))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if update == "adalomo":
            keep = np.abs(_start_grads()[path]) > 1e-4
            g, w = g[keep], w[keep]
        d = np.abs(g - w)
        if update == "adam":
            assert (d > 1e-5).sum() <= 1e-3 * d.size, (strategy, path)
            assert d.max() <= 2 * LR * steps + 1e-5, (strategy, path)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"{strategy}: {path}")
    return tr, jr


def test_hift_covers_head_shared_both_super_blocks_and_embed():
    tr, jr = _run_both("hift", 4, {"hift": HiFTConfig(m=2,
                                                      strategy="top2down")},
                       {"hift": JHiFTConfig(m=2, strategy="top2down")},
                       update="adam")
    labels = [tr.group_for_step(s).label() for s in range(4)]
    assert labels == ["g3(head)", "g2(shared,layers[3:4])",
                      "g1(layers[1:3])", "g0(embed,layers[0:1])"]
    assert labels == [jr.group_for_step(s).label() for s in range(4)]
    assert tr.strategy._cut(tr.strategy.groups[2]) == CFG.attn_every


def test_nf4_hift_step_matches_jax():
    """One quantized HiFT step (NF4 resident tree, bf16 moments) on the
    head group: every frozen leaf runs from codes in the forward (the
    embedding's gathered rows, the shared block's projections through its
    views, ``conv_w`` and the ``(L, H)`` SSM scalars decoded at use)."""
    hift = dict(m=2, strategy="top2down")
    tr = _port("hift", hift=HiFTConfig(**hift),
               quant=QuantConfig("nf4", "bf16"))
    jr = _jax("hift", hift=JHiFTConfig(**hift),
              quant=JQuantConfig("nf4", "bf16"))
    assert tr.group_for_step(0).label() == jr.group_for_step(0).label() == \
        "g3(head)"
    b = _batches(1, seed=2)[0]
    np.testing.assert_allclose(float(tr.train_step(_tb(b))),
                               float(jr.train_step(_jb(b))), rtol=0,
                               atol=1e-5)


def test_nf4_frozen_tree_grads_match_jax():
    """The backward through frozen codes, model level: the shared block
    and layer 3 active in fp32, the rest NF4-encoded.  The port hands the
    records to the model; the reference runs on the decoded tree, as its
    HiFT step decodes the frozen tree (the codes are the reference's bit
    for bit: ``test_torch_quant``).  Super-block 1's frozen layer 2 and the
    head multiply through their views, so the gradient reaches the active
    leaves through ``dequant_matmul``'s backward.  Loss within 1e-6,
    gradients within 1e-5 of each leaf's largest entry."""
    from repro_torch.dist.quant import dequantize_tree, quantize_tree
    npp = _np_params()
    lo = CFG.n_layers - 1
    tp = bridge.to_torch(npp)
    frozen = quantize_tree({"embed": tp["embed"], "head": tp["head"],
                            "pre": tree_map(lambda x: x[:lo], tp["layers"])},
                           "nf4")
    decoded = _np(dequantize_tree(frozen))
    jfrozen = jax.tree.map(jnp.asarray, unflatten_from_paths(decoded))
    active = {"shared": npp["shared"],
              "post": jax.tree.map(lambda x: x[lo:], npp["layers"])}
    batch = _batches(1, seed=3)[0]

    def jloss(a):
        layers = jax.tree.map(lambda x, y: jnp.concatenate([x, y]),
                              jfrozen["pre"], a["post"])
        full = {"embed": jfrozen["embed"], "layers": layers,
                "shared": a["shared"], "head": jfrozen["head"]}
        return JZ.loss_fn(JCFG, full, _jb(batch), cut=lo,
                          compute_dtype=jnp.float32)

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, active))
    tactive = tree_map(lambda t: t.requires_grad_(True),
                       bridge.to_torch(active))
    full = {"embed": frozen["embed"],
            "layers": LayerStack([frozen["pre"], tactive["post"]]),
            "shared": tactive["shared"], "head": frozen["head"]}
    tl = TZ.loss_fn(CFG, full, _tb(batch), cut=lo,
                    compute_dtype=torch.float32)
    flat = flatten_with_paths(tactive)
    gs = torch.autograd.grad(tl, list(flat.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=1e-6)
    _assert_rel_close({p: g.numpy() for p, g in zip(flat, gs)},
                      _np(jax.tree.map(np.asarray, jg)))


@pytest.mark.parametrize("strategy", ["hift", "hift_pipelined", "lisa",
                                      "fpft", "fpft_streamed", "lomo",
                                      "adalomo", "mezo"])
def test_launcher_trains_zamba2_on_cpu(strategy, capsys):
    from repro_torch.launch import train as train_cli
    out = train_cli.main(["--arch", "zamba2-2.7b", "--smoke", "--steps", "2",
                          "--batch", "2", "--seq", "32", "--device", "cpu",
                          "--strategy", strategy])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    text = capsys.readouterr().out
    assert "family=hybrid" in text and "done: final loss" in text


def test_lomo_updates_shared_with_the_gradient_of_every_application():
    """Unclipped LOMO is one SGD step on the FPFT gradient: the shared
    block moves by lr times the gradient summed over both super-blocks
    (``_grads(None)``, held to JAX above), where HiFT's cut drops super-
    block 0's application."""
    from repro_torch.core import LOMOConfig
    lr = 0.1            # the step well above the params' fp32 rounding
    r = make_runner(CFG, "lomo", params=bridge.to_torch(_np_params()),
                    schedule=LRSchedule(base_lr=lr), device="cpu",
                    lomo=LOMOConfig(grad_clip=0.0))
    before = _np(r.params)
    r.train_step(_tb(_batches(1)[0]))
    after = _np(r.params)
    _, _, _, fpft = _grads(None)
    _, _, _, hift = _grads(CFG.attn_every)
    for path in before:
        if path.startswith("shared/"):
            step = (before[path] - after[path]) / lr
            np.testing.assert_allclose(step, fpft[path], rtol=0,
                                       atol=1e-3 * np.abs(fpft[path]).max(),
                                       err_msg=path)
            assert np.abs(step - hift[path]).max() > \
                0.1 * np.abs(fpft[path]).max(), path


def test_chip_smoke_hybrid_phase_runs_small_on_the_cpu(capsys):
    """``chip_smoke.py``'s card-against-CPU hybrid phase, rehearsed on the
    CPU alone at SMOKE width (both sides the CPU): its runs, groups and
    gates hold, and it emits one line a strategy."""
    import json

    from test_torch_training import _chip_smoke
    chip_smoke = _chip_smoke()
    cfg = dataclasses.replace(CFG, n_layers=4)
    chip_smoke.phase_train_hybrid_card_vs_cpu(torch, cfg=cfg,
                                              devices=("cpu", "cpu"))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [d["run"] for d in lines] == ["hift", "lomo", "adalomo", "mezo"]
    assert lines[0]["groups"] == ["g1(shared,head,layers[3:4])",
                                  "g0(embed,layers[0:3])"] * 2
    assert all(d["max_rel_loss_gap"] == 0.0 for d in lines)
