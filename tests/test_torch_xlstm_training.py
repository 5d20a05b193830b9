"""The port's xlstm training slice (xlstm-1.3b), held against the JAX
package on the CPU.

Same weights (``test_torch_xlstm._np_params``: the JAX init's shapes
filled from a numpy seed, the forget gate's bias near 3, so the mLSTM
keeps ~95 % of its state a step and a wrong carry shows), bridged to
torch; batches of tokens and labels from a numpy seed; xlstm's SMOKE
config (4 layers, d 32, 4 heads, ``slstm_every`` 2: two super-blocks of
one mLSTM and one sLSTM block) with ``ce_chunk = 16``, so the head's graph
holds several checkpointed CE blocks.  fp32 throughout, on one intra-op
thread.

- Model level, without jit on the port's side: the loss and the gradient
  of every leaf against ``jax.grad`` of ``repro.models.xlstm.loss_fn`` at
  ``cut`` None and at each unit's first depth (0-4), at S = 32 (one scan
  chunk) and, at cut None and at super-block 1's cut, S = 256 (two chunks
  of 128: the scan's inter-chunk path differentiated): losses within
  1e-5, each gradient within 1e-5 of its leaf's largest entry (the same
  math summed in other orders; 4e-6 was seen).  Below the rounded cut no
  leaf gets a gradient.  The sLSTM's stacked ``(H, dh, 4 dh)`` recurrent
  product gives each of ``r_z``, ``r_i``, ``r_f``, ``r_o`` its own.
- ``apply`` over ``LayerStack`` pieces that straddle a super-block is the
  stacked tree's forward bit for bit; ``lomo_pieces`` chained is
  ``loss_fn`` bit for bit, and ``split`` returns views.
- Runner level against JAX's ``make_runner``, 3 steps each:
  ``test_torch_xlstm_strategies.py`` (every strategy, ``run_both``'s
  tolerances).  Here: one NF4 HiFT step (every frozen projection and the
  head through the dequant matmul's views, the sLSTM's recurrent weights
  decoded at use), loss within 1e-5; the backward through an NF4 frozen
  tree at the model level, gradients within 1e-5 of each leaf's largest
  entry.
- The launcher (``--arch xlstm-1.3b --smoke --device cpu``) with ``hift``
  and ``fpft``; ``chip_smoke.py``'s card-against-CPU xlstm training phase
  rehearsed with the CPU on both sides.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HiFTConfig as JHiFTConfig  # noqa: E402
from repro.core.strategy import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import (flatten_with_paths,  # noqa: E402
                                       tree_map, unflatten_from_paths)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import HiFTConfig, QuantConfig  # noqa: E402
from repro_torch.dist import quant as Q  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.models.base import (LayerStack, layer_at,  # noqa: E402
                                     stack_len)
from test_torch_moe import _jax, _np, _port, _tb  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401
from test_torch_xlstm import JCFG as _JSMOKE  # noqa: E402
from test_torch_xlstm import _np_params  # noqa: E402

JCFG = dataclasses.replace(_JSMOKE, ce_chunk=16)
CFG = ArchConfig(**dataclasses.asdict(JCFG))
F32 = torch.float32
N_SB = CFG.n_layers // CFG.slstm_every
# (S, cut): every unit's first depth at S = 32; the inter-chunk path at
# S = 256 with and without super-block 0 below the cut
DEPTHS = sorted({TX.unit_first_depth(CFG, u) for u in TX.unit_spec(CFG)})
GRAD_CASES = [(32, None)] + [(32, d) for d in DEPTHS] + [(256, None),
                                                        (256, 2)]


def batches(n, seed=0, s=32):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, CFG.vocab, (2, s)).astype(np.int32),
             "labels": rng.integers(0, CFG.vocab, (2, s)).astype(np.int32)}
            for _ in range(n)]


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_rel_close(got, want, rel=1e-5, err=""):
    """Each leaf within ``rel`` of its largest entry."""
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=rel * max(float(np.abs(w).max()),
                                                  1e-30),
                                   err_msg=f"{err}{path}")


@functools.lru_cache(maxsize=None)
def _grads(s, cut):
    """(JAX loss, JAX grads, port loss, port grads) at ``cut`` on one
    batch of 2 x ``s``."""
    npp = _np_params()
    batch = batches(1, seed=s, s=s)[0]
    jl, jg = jax.value_and_grad(lambda p: JX.loss_fn(
        JCFG, p, _jb(batch), cut=cut, compute_dtype=jnp.float32))(
            jax.tree.map(jnp.asarray, npp))
    tp = bridge.to_torch(npp)
    flat = flatten_with_paths(tp)
    for t in flat.values():
        t.requires_grad_(True)
    tl = TX.loss_fn(CFG, tp, _tb(batch), cut=cut, compute_dtype=F32)
    gs = torch.autograd.grad(tl, list(flat.values()), allow_unused=True)
    tg = {p: (np.zeros(t.shape, np.float32) if g is None else g.numpy())
          for (p, t), g in zip(flat.items(), gs)}
    return (float(jl), _np(jax.tree.map(np.asarray, jg)), float(tl.detach()),
            tg)


# ------------------------------------------------------------ model level

@pytest.mark.parametrize("s,cut", GRAD_CASES,
                         ids=[f"S{s}-cut{c}" for s, c in GRAD_CASES])
def test_loss_and_grads_match_jax(s, cut):
    jl, jg, tl, tg = _grads(s, cut)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    _assert_rel_close(tg, jg, err=f"S={s} cut={cut}: ")
    # below the (rounded) cut nothing gets a gradient, in both packages
    sb_cut = 0 if cut is None else min(cut // CFG.slstm_every, N_SB)
    m_per = CFG.slstm_every - 1
    for path, g in tg.items():
        if path.startswith("embed/") and cut is not None:
            assert not np.any(g) and not np.any(jg[path]), path
        if path.startswith("mlstm/"):
            assert not np.any(g[:sb_cut * m_per]), path
        if path.startswith("slstm/"):
            assert not np.any(g[:sb_cut]), path
    # the head trains at every cut, the top super-block at every cut below
    # the head's
    assert np.any(tg["head/w"])
    assert np.any(tg["slstm/r_o"][-1]) == (sb_cut < N_SB)


def test_each_recurrent_weight_gets_its_own_gradient():
    """The four recurrent products run as one stacked ``(H, dh, 4 dh)``
    product; each weight's gradient is the reference's, and no two are
    alike (a mixed-up slice of the stack would swap or share them)."""
    _, jg, _, tg = _grads(256, None)
    names = ("r_z", "r_i", "r_f", "r_o")
    for k in names:
        _assert_rel_close({k: tg[f"slstm/{k}"]}, {k: jg[f"slstm/{k}"]})
    for a in names:
        for b in names:
            if a < b:
                d = np.abs(tg[f"slstm/{a}"] - tg[f"slstm/{b}"]).max()
                assert d > 1e-3 * np.abs(jg[f"slstm/{a}"]).max(), (a, b)


def test_apply_takes_layer_stacks_straddling_a_super_block():
    """HiFT's split of a group that straddles super-blocks 0 and 1 (sLSTM
    0 with mLSTM 1): each stack as ``LayerStack`` pieces, one layer a
    piece, gives the stacked tree's logits exactly."""
    tp = bridge.to_torch(_np_params())
    batch = _tb(batches(1)[0])

    def pieces(tree):
        return LayerStack([tree_map(lambda x, i=i: x[i:i + 1], tree)
                           for i in range(stack_len(tree))])

    with torch.no_grad():
        want = TX.apply(CFG, tp, batch, compute_dtype=F32)
        got = TX.apply(CFG, dict(tp, mlstm=pieces(tp["mlstm"]),
                                 slstm=pieces(tp["slstm"])),
                       batch, compute_dtype=F32)
        cut = TX.apply(CFG, dict(tp, mlstm=pieces(tp["mlstm"])), batch,
                       cut=CFG.slstm_every, compute_dtype=F32)
    assert torch.equal(got, want)
    assert torch.equal(cut, want)


def test_lomo_pieces_compose_to_loss_fn_and_split_returns_views():
    tp = bridge.to_torch(_np_params())
    batch = _tb(batches(1)[0])
    pieces = TX.lomo_pieces(CFG, compute_dtype=F32)
    assert pieces.shared_key is None
    assert pieces.liveness_m == CFG.slstm_every
    ep, (sb,), sp, hp = pieces.split(tp)
    assert sp is None
    with torch.no_grad():
        want = TX.loss_fn(CFG, tp, batch, compute_dtype=F32)
        h, _ = pieces.stage_inits[0](ep, None, batch)
        for j in range(N_SB):
            h = pieces.stage_fns[0](layer_at(sb, j), sp, None, h)
        got = pieces.head_loss_fn(hp, ep, h, batch)
    assert float(got) == float(want)
    m_per = CFG.slstm_every - 1
    full = flatten_with_paths(tp)
    for path, v in flatten_with_paths(sb).items():
        lead = (N_SB, m_per) if path.startswith("mlstm/") else (N_SB,)
        assert v.shape[:len(lead)] == lead, path
        assert v.data_ptr() == full[path].data_ptr(), path
    # an in-place write through a super-block slice lands in the layers
    layer_at(sb, 1)["mlstm"]["wq"][0].add_(1.0)
    assert torch.equal(tp["mlstm"]["wq"][m_per],
                       layer_at(sb, 1)["mlstm"]["wq"][0])
    merged = pieces.merge(ep, (sb,), sp, hp)
    for path, v in flatten_with_paths(merged).items():
        assert v.data_ptr() == full[path].data_ptr(), path
        assert v.shape == full[path].shape, path


# ------------------------------------------------------------ quantized

def test_nf4_hift_step_matches_jax():
    """One NF4 HiFT step (bf16 moments) on the embed group, whose backward
    runs through every frozen layer: each frozen 2-d projection of every
    layer (a layer view each) and the frozen head multiply through the
    dequant matmul, the sLSTM's recurrent weights are decoded at use
    (``QuantView.decode``), and the only record decoded whole is the
    active group's (its fp32 master, on the first visit)."""
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
    projections = {"mlstm": ("w_up", "w_gate", "wq", "wk", "wv", "w_i",
                             "w_f", "w_down"),
                   "slstm": ("w_zifo", "w_out")}
    for stack, names in projections.items():
        for name in names:
            rec = params[stack][name]
            want |= {(rec["q"][i].data_ptr(), Q.quant_shape(rec)[1:])
                     for i in range(rec["q"].shape[0])}
    seen, decoded, views = set(), [], []
    real_dm, real_dq = DM.dequant_matmul, Q.dequantize_leaf
    real_decode = Q.QuantView.decode

    def dm(x, w):
        seen.add((w.q.data_ptr(), tuple(w.shape)))
        return real_dm(x, w)

    def dq(leaf):
        decoded.append(leaf["q"].data_ptr())
        return real_dq(leaf)

    def decode(view):
        views.append(tuple(view.shape))
        return real_decode(view)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(DM, "dequant_matmul", dm)
        mp.setattr(Q, "dequantize_leaf", dq)
        mp.setattr(Q.QuantView, "decode", decode)
        b = batches(1, seed=2)[0]
        np.testing.assert_allclose(float(tr.train_step(_tb(b))),
                                   float(jr.train_step(_jb(b))), rtol=0,
                                   atol=1e-5)
    finally:
        mp.undo()
    assert want <= seen, sorted(want - seen)[:4]
    assert decoded and set(decoded) == {params["embed"]["tok"]["q"]
                                        .data_ptr()}
    H, dh = CFG.n_heads, CFG.d_model // CFG.n_heads
    # four recurrent weights a sLSTM layer, in the forward and in each
    # super-block's checkpointed recompute
    assert views.count((H, dh, dh)) >= 4 * N_SB * 2
    assert set(params["slstm"]["r_z"]) == {"q", "s", "t"}


def test_nf4_frozen_tree_grads_match_jax():
    """The backward through frozen codes, model level: super-block 1 (mLSTM
    1 and sLSTM 1) active in fp32, the rest NF4-encoded.  The port hands
    the records to the model; the reference runs on the decoded tree, as
    its HiFT step decodes the frozen tree.  The frozen head multiplies
    through its view, so the gradient reaches the active leaves through
    ``dequant_matmul``'s backward.  Loss within 1e-6, gradients within
    1e-5 of each leaf's largest entry."""
    from repro_torch.dist.quant import dequantize_tree, quantize_tree
    npp = _np_params()
    tp = bridge.to_torch(npp)
    frozen = quantize_tree({"embed": tp["embed"], "head": tp["head"],
                            "m_pre": tree_map(lambda x: x[:1], tp["mlstm"]),
                            "s_pre": tree_map(lambda x: x[:1], tp["slstm"])},
                           "nf4")
    jfrozen = jax.tree.map(jnp.asarray, unflatten_from_paths(
        _np(dequantize_tree(frozen))))
    active = {"m": jax.tree.map(lambda x: x[1:], npp["mlstm"]),
              "s": jax.tree.map(lambda x: x[1:], npp["slstm"])}
    batch = batches(1, seed=3)[0]
    cut = CFG.slstm_every

    def jloss(a):
        full = {"embed": jfrozen["embed"], "head": jfrozen["head"],
                "mlstm": jax.tree.map(lambda x, y: jnp.concatenate([x, y]),
                                      jfrozen["m_pre"], a["m"]),
                "slstm": jax.tree.map(lambda x, y: jnp.concatenate([x, y]),
                                      jfrozen["s_pre"], a["s"])}
        return JX.loss_fn(JCFG, full, _jb(batch), cut=cut,
                          compute_dtype=jnp.float32)

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, active))
    tactive = tree_map(lambda t: t.requires_grad_(True),
                       bridge.to_torch(active))
    full = {"embed": frozen["embed"], "head": frozen["head"],
            "mlstm": LayerStack([frozen["m_pre"], tactive["m"]]),
            "slstm": LayerStack([frozen["s_pre"], tactive["s"]])}
    tl = TX.loss_fn(CFG, full, _tb(batch), cut=cut, compute_dtype=F32)
    flat = flatten_with_paths(tactive)
    gs = torch.autograd.grad(tl, list(flat.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=1e-6)
    _assert_rel_close({p: g.numpy() for p, g in zip(flat, gs)},
                      _np(jax.tree.map(np.asarray, jg)))


# ------------------------------------------------------------ surfaces

@pytest.mark.parametrize("strategy", ["hift", "fpft"])
def test_launcher_trains_xlstm_on_cpu(strategy, capsys):
    from repro_torch.launch import train as train_cli
    out = train_cli.main(["--arch", "xlstm-1.3b", "--smoke", "--steps", "2",
                          "--batch", "2", "--seq", "32", "--device", "cpu",
                          "--strategy", strategy])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    text = capsys.readouterr().out
    assert "family=xlstm" in text and "done: final loss" in text
    if strategy == "hift":
        assert "hift k=6" in text


def test_chip_smoke_xlstm_training_phase_runs_small_on_the_cpu(capsys):
    """``chip_smoke.py``'s card-against-CPU xlstm training phase, rehearsed
    on the CPU alone at SMOKE width (both sides the CPU): HiFT m=1 through
    the embed, the first mLSTM, the first sLSTM and the head, then one
    ``lomo`` step; each run emits its line, and no loss differs."""
    import json

    from test_torch_training import _chip_smoke
    chip_smoke = _chip_smoke()
    chip_smoke.phase_train_xlstm_card_vs_cpu(torch, cfg=CFG,
                                             devices=("cpu", "cpu"))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [d["run"] for d in lines] == ["hift", "lomo"]
    assert lines[0]["groups"] == ["g0(embed)", "g1(mlstm[0:1])",
                                  "g2(slstm[0:1])", "g5(head)"]
    assert all(d["max_rel_loss_gap"] == 0.0 for d in lines)
