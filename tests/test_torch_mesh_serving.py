"""The port's serving under a ``DeviceMesh`` on the CPU: four gloo
processes on (data=2, model=2) and (data=4, model=1) meshes, held against
the unsharded port engine, the JAX engine and the reference's placement
rules.

The module fixture writes the tiny dense config's JAX-initialised params,
a training batch (``conftest.make_batch``) and four ragged prompts to an
.npz, then starts four ``tests/torch_serve_worker.py`` processes once for
the whole file (one gloo rank and one intra-op thread each, joined
through a ``FileStore`` under ``tmp_path``; a ``timeout=`` on each, so a
wedged worker fails the file).  While they run, the parent serves the
dense prompts through ``repro.serve.engine.ServeEngine`` (the reference
holds its own sharded tokens equal to that engine) and runs the serve
launcher without ``--mesh``.  What the ranks ran is in the worker's
docstring.

Greedy tokens are compared exactly: under a mesh each rank runs its rows
through the same plain versions as the unsharded engine, so nothing but
the rows' grouping changes.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_batch, tiny_dense_cfg
from test_torch_distributed import _dims, _ref_dims, _stub_mesh
from repro.common.pytree import flatten_with_paths as jflat
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JaxServe

_REPO = Path(__file__).resolve().parent.parent
WORLD = 4
FAMILIES = ("tiny", "internvl2-26b", "zamba2-2.7b", "deepseek-moe-16b",
            "seamless-m4t-large-v2", "xlstm-1.3b")
MAX_NEW = 6            # the worker's
LAUNCH = ["--arch", "llama2-7b", "--smoke", "--device", "cpu",
          "--requests", "4", "--max-new", str(MAX_NEW)]


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, n) for n in (9, 5, 12, 7)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' JSON, the JAX engine's dense tokens and the launcher's
    output without a mesh, the last two computed here while the workers
    run."""
    d = tmp_path_factory.mktemp("serve")
    cfg = tiny_dense_cfg(ce_chunk=0)
    params = jax.tree.map(np.asarray, JT.init(cfg, jax.random.PRNGKey(0)))
    batch = jax.tree.map(lambda x: np.asarray(x).astype(np.int64),
                         make_batch(cfg, batch=4, seq=32))
    arrs = {f"p/{k}": v for k, v in jflat(params).items()}
    arrs.update({f"b/{k}": v for k, v in batch.items()})
    arrs.update({f"prompt/{i}": p for i, p in enumerate(_prompts())})
    np.savez(d / "in.npz", **arrs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(
        [sys.executable, str(_REPO / "tests" / "torch_serve_worker.py"),
         str(d / "store"), str(WORLD), str(r), str(d / "in.npz"), str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        jeng = JaxServe(cfg, jax.tree.map(jnp.asarray, params),
                        max_len=12 + MAX_NEW, batch=4)
        jax_tokens = jeng.generate([jnp.asarray(p, jnp.int32)
                                    for p in _prompts()], MAX_NEW)
        from repro_torch.launch import serve as launch_serve
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launch_serve.main(LAUNCH)
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return dict(ranks=[json.loads((d / f"rank{r}.json").read_text())
                       for r in range(WORLD)],
                jax=jax_tokens, launcher=buf.getvalue())


def _ok(res):
    assert "error" not in res, res["error"]
    return res


def _every_rank(runs, key):
    """The case's result on rank 0, after holding every rank's equal."""
    got = [_ok(r[key]) for r in runs["ranks"]]
    for g in got[1:]:
        assert g["tokens"] == got[0]["tokens"], key
    return got[0]


@pytest.mark.parametrize("spec", ["2x2", "4x1"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_on_a_mesh_gives_the_unsharded_tokens(runs, arch, spec):
    """Every family's smoke config: the rows split over the data axes (2
    a rank on 2x2, 1 on 4x1; the moe family's whole, its experts'
    capacity coupling them), every rank returns every prompt's tokens,
    equal to the unsharded engine's; on 2x2 the params are split over the
    model axis."""
    got = _every_rank(runs, f"serve/{arch}/{spec}")
    want = _ok(runs["ranks"][0][f"serve/{arch}/plain"])
    assert got["tokens"] == want["tokens"]
    assert len(got["tokens"]) == 4 and \
        all(len(t) == MAX_NEW for t in got["tokens"])
    data = 1 if arch == "deepseek-moe-16b" else int(spec.split("x")[0])
    assert got["rows"] == [4 // data] and want["rows"] == [4]
    assert (got["model_sharded"] > 0) == (spec == "2x2")


def test_the_dense_engine_on_a_mesh_gives_the_jax_engines_tokens(runs):
    for spec in ("2x2", "4x1"):
        got = _every_rank(runs, f"serve/tiny/{spec}")
        assert got["tokens"] == runs["jax"], spec


def test_rows_replicate_where_the_batch_does_not_divide(runs):
    """A batch of 3 on two data ranks: every rank runs all 3 rows."""
    got = _every_rank(runs, "serve/tiny3/2x2")
    want = _ok(runs["ranks"][0]["serve/tiny3/plain"])
    assert got["rows"] == [3]
    assert got["tokens"] == want["tokens"]
    assert got["tokens"] == runs["jax"][:3]


def test_continuous_engine_on_a_mesh_gives_the_unsharded_tokens(runs):
    got = _every_rank(runs, "continuous/2x2")
    want = _ok(runs["ranks"][0]["continuous/plain"])
    assert got["tokens"] == want["tokens"]
    assert [len(t) for t in got["tokens"]] == [6, 3, 8, 2, 5]
    assert got["refills"] == want["refills"] > 0
    assert got["model_sharded"] > 0


@pytest.mark.parametrize("mesh", ["mesh", "none"])
def test_train_to_serve_handoff_from_a_sharded_state(runs, mesh):
    """The reference's ``test_sharded_train_to_serve_handoff``: 2 FPFT
    steps on the 2x2 mesh, then ``from_train_state``; with ``mesh=None``
    the engine gathers the DTensor leaves (it once passed them on to the
    model as DTensors)."""
    for r in runs["ranks"]:
        res = _ok(r["handoff"])
        assert res["state_model_sharded"] > 0
        got = _ok(res[mesh])
        assert got["tokens"] == res["want"]
        assert (got["model_sharded"] > 0) == (mesh == "mesh")
    assert runs["ranks"][1]["handoff"]["want"] == \
        runs["ranks"][0]["handoff"]["want"]


def test_the_launcher_serves_on_a_mesh_and_prints_on_rank_0(runs):
    out = [r["launcher"] for r in runs["ranks"]]
    for o in out:
        assert isinstance(o, str), o["error"]
    lines = [ln for ln in runs["launcher"].splitlines()
             if ln.startswith("request ")]
    assert len(lines) == 4
    assert [ln for ln in out[0].splitlines()
            if ln.startswith("request ")] == lines
    assert out[1:] == ["", "", ""]


# ------------------------------------------------------ placement rules

def _smoke_trees(arch):
    """A family's smoke params and its serving cache at batch 4, max_len
    48 (the port's ``init_cache``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_family
    cfg = get_config("llama2-7b" if arch == "tiny" else arch, smoke=True)
    fam = get_family(cfg)
    params = fam.init(cfg, torch.Generator().manual_seed(0))
    if cfg.family == "xlstm":
        cache = fam.init_cache(cfg, 4)
    elif cfg.family == "encdec":
        cache = fam.init_cache(cfg, 4, 48, enc_len=40)
    else:
        cache = fam.init_cache(cfg, 4, 48)
    return cfg, params, cache


def _np(tree):
    """The tree's tensors as numpy zeros of their shapes (the reference's
    rules read shapes only); other leaves (``pos``) as they are."""
    from repro_torch.common.pytree import tree_map
    return tree_map(lambda t: np.zeros(tuple(t.shape))
                    if isinstance(t, torch.Tensor) else t, tree)


@pytest.mark.parametrize("sizes", [dict(data=2, model=2),
                                   dict(data=4, model=1),
                                   dict(data=1, model=4)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_placement_rules_match_the_reference(monkeypatch, arch,
                                                     sizes):
    """``cache_shardings``, ``prefill_step_shardings`` and
    ``decode_step_shardings`` against the reference's, leaf for leaf, on
    the family's smoke cache (its ``NamedSharding`` stubbed to hand back
    the PartitionSpec, so no fabricated devices are needed)."""
    from repro.dist import shardings as JS
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.dist import shardings as S
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    mesh = _stub_mesh(**sizes)
    cfg, params, cache = _smoke_trees(arch)
    prompts = {"tokens": torch.zeros(4, 12, dtype=torch.long),
               "pad": torch.zeros(4, dtype=torch.int32)}
    logits = torch.zeros(4, 1, cfg.vocab_padded)
    tokens = torch.zeros(4, 1, dtype=torch.long)
    pairs = [(S.cache_shardings(cache, mesh),
              JS.cache_shardings(_np(cache), mesh), cache)]
    for got, want, like in (
            (S.prefill_step_shardings(mesh, params, prompts, cache, logits),
             JS.prefill_step_shardings(mesh, _np(params), _np(prompts),
                                       _np(cache), _np(logits)),
             ((params, prompts, cache), (logits, cache))),
            (S.decode_step_shardings(mesh, params, cache, tokens, logits),
             JS.decode_step_shardings(mesh, _np(params), _np(cache),
                                      _np(tokens), _np(logits)),
             ((params, cache, tokens), (logits, cache)))):
        for g2, w2, l2 in zip(got, want, like):
            pairs += list(zip(g2, w2, l2))
    for got, want, like in pairs:
        got, want = flatten_with_paths(got), flatten_with_paths(want)
        for path, t in flatten_with_paths(like).items():
            ndim = getattr(t, "ndim", 0)
            assert _dims(got[path], mesh, ndim) == \
                _ref_dims(want[path], ndim), (path, sizes)
    # the rule's layouts: the model axis splits the KV sequence, and the
    # encdec memory's source frames take the data axes
    specs = flatten_with_paths(S.cache_shardings(cache, mesh))
    if sizes == dict(data=2, model=2) and "k" in cache:
        assert _dims(specs["k"], mesh, 5) == [None, ("data",), ("model",),
                                              None, None]
    if sizes == dict(data=2, model=2) and "memory" in cache:
        assert _dims(specs["memory"], mesh, 3) == [None, ("data",),
                                                   ("model",)]


# ---------------------------------------------------------------- refusals

@pytest.mark.parametrize("engine", ["ServeEngine", "ContinuousServeEngine"])
def test_a_cuda_mesh_for_a_cpu_engine_raises(engine):
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E
    cfg = get_config("llama2-7b", smoke=True)
    params = T.init(cfg, torch.Generator().manual_seed(0))
    mesh = SimpleNamespace(device_type="cuda", mesh_dim_names=("data",
                                                               "model"))
    with pytest.raises(ValueError, match="must agree"):
        getattr(E, engine)(cfg, params, device="cpu", mesh=mesh)
