"""The port's fused-backward strategies (``lomo``, ``adalomo``) on the CPU,
held against the JAX package (the counterpart of the reference's
``tests/test_lomo_pieces.py`` and its LOMO cases in
``tests/test_strategy_api.py``).

Params are the JAX init of the llama2-7b (untied head) and roberta-base
(tied head) smoke configs, bridged to torch, with norm scales and biases
perturbed (``test_torch_training._np_params``); batches are the
synthetic LM's at 2 x 32 with ``ce_chunk=16``, so the head's graph holds
two checkpointed CE blocks and the generic fallback's loss runs remat per
layer.

Tolerances (fp32 throughout; the same arithmetic summed in other orders by
XLA and by PyTorch's CPU kernels, and XLA fuses multiply-adds):

- losses within 1e-5 of the JAX runner's over three steps;
- params within atol 1e-6 after LOMO (SGD moves each element by lr times
  its gradient, ~1e-3 here) and grad norms within rtol 1e-5;
- AdaLomo's moments within 1e-5 relative, to each leaf's largest entry
  (``_assert_moments_close``): they see g^2, so a gradient's rounding
  (~1e-6 of its leaf's scale, sums taken in other orders) doubles and
  compounds over three steps, and an element with a tiny gradient carries
  its leaf's absolute error; its params within atol 1e-5 where the starting
  gradient's magnitude exceeds 1e-4: the RMS-normalised update is about
  sign(g) while the moments are young, so a rounding sign flip at g ~ 0
  moves an element by 2 lr in opposite directions on the two sides (the
  reference's ``tests/test_lomo_pieces.py`` masks so too);
- fused against generic, and the staged driver against the 3-tuple body:
  the same tolerances (one step's gradients through other graphs, and the
  tied head's embedding update as two increments or one).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import LRSchedule as JLRSchedule  # noqa: E402
from repro.core import make_runner as jax_make_runner  # noqa: E402
from repro.core.strategy import AdaLomoConfig as JAdaLomoConfig  # noqa: E402
from repro.core.strategy import LOMOConfig as JLOMOConfig  # noqa: E402
from repro.core.strategy import \
    adalomo_init_opt_state as jax_adalomo_init  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import flatten_with_paths  # noqa: E402
from repro_torch.core import (AdaLomoConfig, LOMOConfig,  # noqa: E402
                              LRSchedule, StreamConfig, make_runner)
from repro_torch.core.strategy import (adalomo_init_opt_state,  # noqa: E402
                                       adalomo_step_body, lomo_step_body)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.base import LomoPieces, layer_at  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from test_torch_pipeline import _assert_same, _snap, one_thread  # noqa: E402,F401
from test_torch_training import (_batches, _cfgs, _jbatch,  # noqa: E402
                                 _jtree, _np_params)

LR = 1e-2
LOSS_ATOL = 1e-5
UNTIED, TIED = "llama2-7b", "roberta-base"


def _port(name, strategy, lr=LR, **kw):
    _, cfg = _cfgs(name)
    return make_runner(cfg, strategy, params=bridge.to_torch(_np_params(name)),
                       schedule=LRSchedule(base_lr=lr), device="cpu", **kw)


def _jax(name, strategy, lr=LR, **kw):
    jcfg, _ = _cfgs(name)
    return jax_make_runner(jcfg, strategy, params=_jtree(_np_params(name)),
                           schedule=JLRSchedule(base_lr=lr), **kw)


def _np(tree):
    return {p: np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                          else x)
            for p, x in flatten_with_paths(tree).items()}


def _jax_grads(name):
    """The reference's gradient at the starting params (the masks)."""
    jcfg, cfg = _cfgs(name)
    batch = _jbatch(_batches(cfg, 1)[0])
    return _np(jax.tree.map(np.asarray, jax.grad(
        lambda p: JT.loss_fn(jcfg, p, batch, compute_dtype=jnp.float32))(
            _jtree(_np_params(name)))))


def _assert_moments_close(got, want):
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=path)


def _assert_masked_close(got, want, grads, atol=1e-5):
    for path, g in grads.items():
        mask = np.abs(g) > 1e-4
        np.testing.assert_allclose(got[path][mask], want[path][mask],
                                   atol=atol, err_msg=path)


# ----------------------------------------------------------------- pieces

@pytest.mark.parametrize("name", [UNTIED, TIED])
def test_lomo_pieces_reproduce_loss_fn(name):
    """The port's pieces chained reproduce the port's ``loss_fn`` bit for
    bit (the same ops), and the reference's pieces within 1e-6."""
    jcfg, cfg = _cfgs(name)
    npp = _np_params(name)
    params = bridge.to_torch(npp)
    batch = _batches(cfg, 1)[0]
    embed_fn, block_fn, head_loss_fn = TT.lomo_pieces(
        cfg, compute_dtype=torch.float32)
    with torch.no_grad():
        h = embed_fn(params["embed"], batch)
        for i in range(cfg.n_layers):
            h = block_fn(layer_at(params["layers"], i), h)
        got = head_loss_fn(params["head"], params["embed"], h, batch)
        want = TT.loss_fn(cfg, params, batch, compute_dtype=torch.float32)
    assert torch.equal(got, want)
    je, jb, jh = JT.lomo_pieces(jcfg, compute_dtype=jnp.float32)

    @jax.jit
    def chained(jp, jbatch):
        h = je(jp["embed"], jbatch)
        for i in range(jcfg.n_layers):
            h = jb(jax.tree.map(lambda x: x[i], jp["layers"]), h)
        return jh(jp["head"], jp["embed"], h, jbatch)

    np.testing.assert_allclose(float(got),
                               float(chained(_jtree(npp), _jbatch(batch))),
                               atol=1e-6)


# ------------------------------------------------------------ LOMO vs JAX

LOMO_CASES = [   # (arch, grad_clip, steps): weight decay 0.01 throughout
    (UNTIED, 1.0, 3), (UNTIED, 0.0, 1), (TIED, 1.0, 1), (TIED, 0.0, 3)]


@pytest.mark.parametrize("name,clip,steps", LOMO_CASES)
def test_lomo_matches_jax(name, clip, steps):
    _, cfg = _cfgs(name)
    tr = _port(name, "lomo", lomo=LOMOConfig(grad_clip=clip,
                                              weight_decay=0.01))
    jr = _jax(name, "lomo", lomo=JLOMOConfig(grad_clip=clip,
                                              weight_decay=0.01))
    assert tr.strategy._fused
    for b in _batches(cfg, steps):
        np.testing.assert_allclose(float(tr.train_step(b)),
                                   float(jr.train_step(_jbatch(b))),
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(float(tr.last_metrics["grad_norm"]),
                                   float(jr.last_metrics["grad_norm"]),
                                   rtol=1e-5)
    got, want = _np(tr.params), _np(jax.tree.map(np.asarray, jr.params))
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-6,
                                   err_msg=path)
    assert tr.state.opt_state == {}
    assert tr.strategy.peak_grad_params(tr.params) < tr.total_params()


@pytest.mark.parametrize("name", [UNTIED, TIED])
def test_lomo_is_one_sgd_step(name):
    """LOMO == ``fpft`` with plain SGD and the same global clip and decay,
    within rounding: fusing the update into the backward does not change
    the step."""
    _, cfg = _cfgs(name)
    lomo = _port(name, "lomo", lomo=LOMOConfig(grad_clip=1.0,
                                                weight_decay=0.01))
    fpft = _port(name, "fpft", optimizer=make_optimizer(
        "sgd", grad_clip=1.0, weight_decay=0.01))
    for b in _batches(cfg, 2):
        np.testing.assert_allclose(float(lomo.train_step(b)),
                                   float(fpft.train_step(b)), atol=LOSS_ATOL)
    got, want = _np(lomo.params), _np(fpft.params)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-6,
                                   err_msg=path)


# -------------------------------------------------- fused, generic, staged

@pytest.mark.parametrize("strategy", ["lomo", "adalomo"])
def test_fused_matches_generic_fallback(strategy):
    """A custom ``loss_fn`` routes through the segment fallback; on the
    tied config both paths give the same steps (clip on, so both run two
    sweeps)."""
    _, cfg = _cfgs(TIED)
    kw = ({"lomo": LOMOConfig(grad_clip=1.0, weight_decay=0.01)}
          if strategy == "lomo" else
          {"adalomo": AdaLomoConfig(grad_clip=1.0, weight_decay=0.01)})
    fused = _port(TIED, strategy, **kw)
    generic = _port(TIED, strategy, loss_fn=TT.loss_fn, **kw)
    assert fused.strategy._fused and not generic.strategy._fused
    assert generic.strategy.peak_grad_params(generic.params) == \
        generic.total_params()
    for b in _batches(cfg, 2):
        np.testing.assert_allclose(float(fused.train_step(b)),
                                   float(generic.train_step(b)),
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(float(fused.last_metrics["grad_norm"]),
                                   float(generic.last_metrics["grad_norm"]),
                                   rtol=1e-5)
    got, want = _np(fused.params), _np(generic.params)
    if strategy == "lomo":
        for path in want:
            np.testing.assert_allclose(got[path], want[path], atol=1e-6,
                                       err_msg=path)
    else:
        _assert_masked_close(got, want, _jax_grads(TIED))
        _assert_moments_close(_np(fused.opt_state["moments"]),
                              _np(generic.opt_state["moments"]))


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_staged_driver_matches_three_tuple_body(clip):
    """``_lomo_pieces_body`` (reached through ``pieces=LomoPieces``) against
    the dense 3-tuple body on the tied config: the same step, the tied
    embedding updated once with the summed gradient instead of two
    increments.  The grad norms agree under the clip, where both come
    from the norm sweep's exact sum; unclipped, the 3-tuple body reports
    the two embedding increments' norms apart (the reference's choice)."""
    _, cfg = _cfgs(TIED)
    lomo = LOMOConfig(grad_clip=clip, weight_decay=0.01)
    pieces = TT.lomo_pieces(cfg, compute_dtype=torch.float32)
    three = lomo_step_body(cfg, lomo=lomo, pieces=pieces)
    staged = lomo_step_body(cfg, lomo=lomo,
                            pieces=LomoPieces.from_embed_block_head(*pieces))
    batch = _batches(cfg, 1)[0]
    pa = bridge.to_torch(_np_params(TIED))
    pb = bridge.to_torch(_np_params(TIED))
    _, la, na = three(pa, batch, LR)
    _, lb, nb = staged(pb, batch, LR)
    assert float(la) == float(lb)
    if clip:
        np.testing.assert_allclose(float(na), float(nb), rtol=1e-5)
    got, want = _np(pa), _np(pb)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-6,
                                   err_msg=path)


def test_grad_clip_runs_a_second_sweep():
    """Under ``grad_clip > 0`` every layer is recomputed twice (the norm
    sweep and the update sweep), once without."""
    _, cfg = _cfgs(UNTIED)
    calls = []
    embed_fn, block_fn, head_loss_fn = TT.lomo_pieces(
        cfg, compute_dtype=torch.float32)

    def counted(lp, h):
        calls.append(torch.is_grad_enabled())
        return block_fn(lp, h)

    pieces = LomoPieces.from_embed_block_head(embed_fn, counted,
                                              head_loss_fn)
    batch = _batches(cfg, 1)[0]
    n = cfg.n_layers
    for clip, sweeps in ((0.0, 1), (1.0, 2)):
        calls.clear()
        body = adalomo_step_body(cfg, adalomo=AdaLomoConfig(grad_clip=clip),
                                 pieces=pieces)
        params = bridge.to_torch(_np_params(UNTIED))
        body(params, adalomo_init_opt_state(cfg, params), batch, LR)
        # the forward without a graph, then one recompute a layer a sweep
        assert calls == [False] * n + [True] * (n * sweeps), (clip, calls)


# --------------------------------------------------------- AdaLomo vs JAX

ADALOMO_CASES = [   # (arch, config keywords, lr)
    (UNTIED, {}, LR), (TIED, {"grad_clip": 1.0, "weight_decay": 0.01}, LR),
    (UNTIED, {"relative_step": True}, 0.1)]


@pytest.mark.parametrize("name,akw,lr", ADALOMO_CASES)
def test_adalomo_matches_jax(name, akw, lr):
    _, cfg = _cfgs(name)
    tr = _port(name, "adalomo", adalomo=AdaLomoConfig(**akw), lr=lr)
    jr = _jax(name, "adalomo", adalomo=JAdaLomoConfig(**akw), lr=lr)
    for b in _batches(cfg, 3):
        np.testing.assert_allclose(float(tr.train_step(b)),
                                   float(jr.train_step(_jbatch(b))),
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(float(tr.last_metrics["grad_norm"]),
                                   float(jr.last_metrics["grad_norm"]),
                                   rtol=1e-5)
    jstate = jax.tree.map(np.asarray, jr.state.opt_state)
    assert int(tr.opt_state["count"]) == int(jstate["count"]) == 3
    assert tr.opt_state["count"].dtype == torch.int64
    _assert_moments_close(_np(tr.opt_state["moments"]),
                          _np(jstate["moments"]))
    _assert_masked_close(_np(tr.params), _np(jax.tree.map(np.asarray,
                                                           jr.params)),
                         _jax_grads(name))


def test_adalomo_state_is_factored_per_layer():
    """The state's shapes are ``adalomo_init_opt_state``'s and the
    reference's: factored ``vr``/``vc`` per matrix (per layer for stacked
    leaves), a full per-layer ``v`` for stacked vectors, and the count."""
    jcfg, cfg = _cfgs(UNTIED)
    r = _port(UNTIED, "adalomo")
    shapes = {p: tuple(t.shape) for p, t in
              flatten_with_paths(r.opt_state).items()}
    made = adalomo_init_opt_state(cfg, r.params)
    assert shapes == {p: tuple(t.shape) for p, t in
                      flatten_with_paths(made).items()}
    ref = jax_adalomo_init(jcfg, _jtree(_np_params(UNTIED)))
    assert shapes == {p: tuple(np.shape(x)) for p, x in
                      flatten_with_paths(ref).items()}
    mom = r.opt_state["moments"]
    assert set(mom["layers"]["attn"]["wq"]) == {"vr", "vc"}
    assert mom["layers"]["attn"]["wq"]["vr"].shape[0] == cfg.n_layers
    assert set(mom["layers"]["ln1"]["scale"]) == {"v"}
    assert sum(int(np.prod(s)) for s in shapes.values()) < \
        0.05 * r.total_params()


# ------------------------------------------------------ streaming, launcher

@pytest.mark.parametrize("strategy", ["lomo", "adalomo"])
def test_stream_is_bit_equal_to_unstreamed(strategy):
    """``stream=StreamConfig(depth=2)`` moves segments through the bundle
    pipeline (the identity on the CPU, its bookkeeping still run): every
    loss and state leaf equal to the unstreamed run's, bit for bit."""
    _, cfg = _cfgs(TIED)
    plain = _port(TIED, strategy)
    streamed = _port(TIED, strategy, stream=StreamConfig(depth=2))
    for b in _batches(cfg, 2):
        assert float(plain.train_step(b)) == float(streamed.train_step(b))
        _assert_same(_snap(plain.state), _snap(streamed.state))
    stats = streamed.strategy._seg_pipe.stats
    segments = 3 * (2 if strategy == "adalomo" else 1)
    assert stats.offloads == 2 * segments
    assert stats.prefetch_misses + stats.prefetch_hits == 2 * segments


@pytest.mark.parametrize("strategy,clip", [("lomo", None), ("lomo", "0"),
                                           ("adalomo", "1.0"),
                                           ("mezo", None)])
def test_launcher_runs_the_fused_and_zeroth_order_strategies(capsys,
                                                             strategy, clip):
    argv = ["--arch", "llama2-7b", "--smoke", "--steps", "3", "--device",
            "cpu", "--strategy", strategy]
    if clip is not None:
        argv += ["--grad-clip", clip]
    out = train_cli.main(argv)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert "done: final loss" in capsys.readouterr().out


def test_quant_is_rejected():
    """No frozen tree to encode, no moment tree to narrow."""
    from repro_torch.core import QuantConfig
    _, cfg = _cfgs(UNTIED)
    for strategy in ("lomo", "adalomo", "mezo"):
        with pytest.raises(ValueError, match="does not support"):
            make_runner(cfg, strategy, device="cpu",
                        quant=QuantConfig(frozen="nf4"))
    from repro_torch.core import CrossPodConfig
    with pytest.raises(ValueError, match="does not support cross_pod: the "
                                         "fused backward"):
        make_runner(cfg, "lomo", device="cpu", cross_pod=CrossPodConfig())
