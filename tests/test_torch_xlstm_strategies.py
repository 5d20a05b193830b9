"""The port's xlstm training slice (xlstm-1.3b): every strategy against
the JAX runner on the CPU, three steps each (MeZO two).

The setting of ``test_torch_xlstm_training`` (same weights, batches of 2 x
32 tokens, the SMOKE config with ``ce_chunk = 16``, one intra-op thread)
and ``test_torch_moe.run_both``'s tolerances: losses within 1e-5 (AdamW
from the third step: 2e-4, after a near-zero gradient's sign-like first
update lands on the other sign in one package), params within atol 1e-5
but for AdamW's and AdaLomo's sign-like first updates (AdamW: at most
0.1 % of a leaf beyond 1e-5 and none beyond 2 lr steps + 1e-5; AdaLomo:
params held where the starting gradient exceeds 1e-4).

One slice is held to the 2-lr bound alone: the sLSTM's input-gate bias,
``slstm/b_zifo[:, d:2d]``.  Where the input gate wins the stabilizer's
max at every step (these weights), the stabilizer moves with any
constant shift of the input gate and the output ``o c / n`` does not, so
the bias's true gradient is zero and both packages' gradients there are
rounding (1e-9 against the leaf's 5e-2); AdamW's first update is about lr
sign(g), so each package moves those elements by lr in a direction of its
own.  ``test_the_input_gate_bias_is_a_zero_gradient_direction`` holds
the premise.

MeZO runs two steps: its projected gradient divides the two packages'
loss difference (~1e-6, the forward's summation order) by 2 eps = 2e-3,
so the params part by ~lr 5e-4 z a step and the gap compounds (losses 0,
5.2e-6, 1.9e-5, 1.8e-4 apart over four steps).  HiFT runs at m = 1 (six
groups, top2down: head, sLSTM 1, mLSTM 1) and at m = 2 (its second group
straddles super-blocks 0 and 1); ``lomo`` and ``adalomo`` run the staged
fused backward a super-block a grain; MeZO draws the reference's z
through ``noise=``.  A file of its own so the tier-1 run's ``--dist
loadfile`` gives these JAX compiles their own worker.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HiFTConfig as JHiFTConfig  # noqa: E402
from repro.core import LiSAConfig as JLiSAConfig  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.core import HiFTConfig, LiSAConfig, strategy_ids  # noqa: E402
from test_torch_mezo import jax_step_noise  # noqa: E402
from test_torch_moe import _np, run_both  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401
from test_torch_xlstm import _np_params  # noqa: E402
from test_torch_xlstm_training import CFG, JCFG, _jb, batches  # noqa: E402

STEPS = 3
D = CFG.d_model
# the sLSTM's input-gate bias (b_zifo is z | i | f | o): a zero-gradient
# direction, held to the 2-lr bound alone (the module's docstring)
IGATE_BIAS = ("slstm/b_zifo", (slice(None), slice(D, 2 * D)))
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


@functools.lru_cache(maxsize=None)
def _start_grads():
    b = batches(1, seed=1)[0]
    g = jax.jit(jax.grad(lambda p: JX.loss_fn(
        JCFG, p, _jb(b), compute_dtype=jnp.float32)))(
            jax.tree.map(jnp.asarray, _np_params()))
    return _np(jax.tree.map(np.asarray, g))


def test_every_registered_strategy_is_covered():
    assert {v[0] for v in STRATEGIES.values()} == set(strategy_ids())


def test_the_input_gate_bias_is_a_zero_gradient_direction():
    """At these weights the reference's FPFT gradient of the input-gate
    bias is rounding, 1e-6 of its leaf's largest entry or less, where
    every other slice of the leaf carries a real gradient."""
    g = np.abs(_start_grads()[IGATE_BIAS[0]])
    scale = g.max()
    assert g[IGATE_BIAS[1]].max() < 1e-6 * scale
    for sl in (slice(0, D), slice(2 * D, 3 * D), slice(3 * D, 4 * D)):
        assert g[:, sl].min() > 1e-4 * scale


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_matches_the_jax_runner(name):
    strategy, pkw, jkw, update = STRATEGIES[name]
    steps = STEPS
    if strategy == "mezo":
        pkw = dict(pkw, noise=jax_step_noise(_np_params()))
        steps = 2
    tr, jr = run_both(JCFG, CFG, _np_params(), strategy, steps, pkw, jkw,
                      update, start_grads=_start_grads(), batches=batches,
                      bound_only=dict([IGATE_BIAS]))
    if strategy == "hift":
        labels = [tr.group_for_step(s).label() for s in range(steps)]
        assert labels == [jr.group_for_step(s).label()
                          for s in range(steps)]
        assert tr.k == (6 if name == "hift_m1" else 3)
        if name == "hift_m2":   # bottom2up: the second group straddles
            assert labels[1] == "g1(slstm[0:1],mlstm[1:2])"
    if strategy in ("lomo", "adalomo"):
        assert tr.strategy._pieces is not None     # the staged fused path
