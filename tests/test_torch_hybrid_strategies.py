"""The port's hybrid training slice (zamba2): every strategy beside
``hift`` against the JAX runner on the CPU, two steps each.

The setting and tolerances of ``test_torch_hybrid_training`` (same
weights, batches and config; ``_run_both``): losses within 1e-5 (AdamW
after a step that lands on a near-zero gradient's sign flip: 2e-4), params
within atol 1e-5 but for AdamW's and AdaLomo's sign-like first updates.
``lomo`` and ``adalomo`` run the staged fused backward over super-blocks,
summing the shared block's gradient over both applications as the
reference does; MeZO draws the reference's z through ``noise=``.  A file
of its own so the tier-1 run's ``--dist loadfile`` gives these JAX
compiles their own worker.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.core import LiSAConfig as JLiSAConfig  # noqa: E402
from repro_torch.core import LiSAConfig  # noqa: E402
from test_torch_hybrid_training import _np_params, _run_both  # noqa: E402
from test_torch_mezo import jax_step_noise  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401

STRATEGIES = {
    "hift_pipelined": ({}, {}, "adam"),
    "lisa": ({"lisa": LiSAConfig(m=1, switch_every=1, seed=2)},
             {"lisa": JLiSAConfig(m=1, switch_every=1, seed=2)}, "adam"),
    "fpft": ({}, {}, "adam"),
    "fpft_streamed": ({"stream_window": 1 << 16}, {"stream_window": 1 << 16},
                      "adam"),
    "lomo": ({}, {}, "linear"),
    "adalomo": ({}, {}, "adalomo"),
    "mezo": ({"noise": jax_step_noise(_np_params()), "seed": 3},
             {"seed": 3}, "linear"),
}


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_strategy_matches_the_jax_runner(strategy):
    pkw, jkw, update = STRATEGIES[strategy]
    _run_both(strategy, 2, pkw, jkw, update=update)


