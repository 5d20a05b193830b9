"""The last dense configs (deepseek-7b, internlm2-1.8b, smollm-360m) and
the six archs of the moe, vlm and dense configs in the port's registry,
held against the JAX package on the CPU.

- Each ``CONFIG`` and ``SMOKE`` equals the reference's field by field,
  and resolves through ``get_config``.
- One SMOKE HiFT step pair of each dense config (the embed step, a
  backward through every layer, then layer 0) against the JAX runner,
  with ``test_torch_paper_configs``'s tolerances (losses rtol 3e-5;
  params rtol 1e-5 / atol 1e-6, AdamW's 2 lr allowance for at most 1 % of
  a leaf).
- smollm-360m's GQA of 3 query heads a kv head (15 over 5 at full width):
  both engines' greedy tokens equal the JAX engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve.scheduler import ServeRequest  # noqa: E402
from test_torch_paper_configs import (_assert_params_close,  # noqa: E402
                                      _run_both)
from test_torch_training import LR, _cfgs  # noqa: E402
from test_torch_training import one_thread  # noqa: E402,F401

DENSE = ["deepseek-7b", "internlm2-1.8b", "smollm-360m"]
ALL = DENSE + ["internvl2-26b", "deepseek-moe-16b", "arctic-480b"]


@pytest.mark.parametrize("name", ALL)
def test_configs_equal_the_references(name):
    for smoke in (False, True):
        got = treg.get_config(name, smoke=smoke)
        want = jreg.get_config(name, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), smoke
        got = treg.get_config(name, smoke=smoke, optimized=True)
        want = jreg.get_config(name, smoke=smoke, optimized=True)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), smoke
    assert treg.normalize(name) in treg.PORTED_IDS


@pytest.mark.parametrize("name", DENSE)
def test_smoke_hift_steps_match_jax(name):
    jl, tl, jparams, tr = _run_both(name, "adamw", 2)
    np.testing.assert_allclose(tl, jl, rtol=3e-5)
    _assert_params_close(tr, jparams, 2, LR)


def test_smollm_gqa3_engines_match_jax():
    jcfg, cfg = _cfgs("smollm-360m")
    jcfg = dataclasses.replace(jcfg, n_heads=6, kv_heads=2, head_dim=8)
    cfg = dataclasses.replace(cfg, n_heads=6, kv_heads=2, head_dim=8)
    assert cfg.n_heads // cfg.kv_heads == 3
    shapes = jax.eval_shape(lambda: JT.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(9)
    npp = jax.tree.map(lambda sd: (rng.standard_normal(sd.shape)
                                   / np.sqrt(sd.shape[-1]))
                       .astype(np.float32), shapes)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (9, 3, 6)]
    want = JaxServe(jcfg, jax.tree.map(jnp.asarray, npp), max_len=16,
                    batch=4, compute_dtype=jnp.float32).generate(
        [jnp.asarray(p) for p in prompts], max_new_tokens=5)
    tp = bridge.to_torch(npp)
    eng = TE.ServeEngine(cfg, tp, max_len=16, batch=4,
                         compute_dtype=torch.float32, device="cpu")
    assert eng.generate(prompts, max_new_tokens=5) == want
    cont = TE.ContinuousServeEngine(cfg, tp, slots=2, block_size=8,
                                    prefill_bucket=16, device="cpu")
    reqs = [ServeRequest(prompt=list(map(int, p)), max_new_tokens=5)
            for p in prompts]
    cont.run(reqs)
    assert [r.out_tokens for r in reqs] == want
