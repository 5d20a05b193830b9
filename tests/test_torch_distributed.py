"""The port's distributed training on the CPU: four gloo processes on a
(data=2, model=2) mesh, held against the unsharded port and the JAX
package.

The module fixture writes the tiny dense config's JAX-initialised params,
a batch (``conftest.make_batch``) and a tiny moe layer to an .npz, then
starts four ``tests/torch_dist_worker.py`` processes (one gloo rank and
one intra-op thread each, joined through a ``FileStore`` under
``tmp_path``; a ``timeout=`` on each, so a wedged worker fails the file)
and reads their JSON.  What the ranks ran is in the worker's docstring.

Tolerances are the reference's own for its sharded steps
(``tests/test_sharded_step.py``): losses 1e-4 where the update is linear
in the gradient (SGD, LOMO, MeZO), 1e-3 under AdamW and AdaLomo; params
1e-4 and 5e-3.  The sharded step reduces gradients over the data axis in
another order than the unsharded one, and AdamW's division by sqrt(v)
amplifies that near zero.  Cross-pod HiFT with AdamW is held to the AdamW
bounds: its int8 codec can round a value the other way after such a
difference.  MeZO is held to the unsharded port only: its noise is the
port's generator, not ``jax.random`` (ROADMAP, deliberate differences).

Quantized residency is held by its fp32 masters (5e-3) and its resident
codes: a code may move only to an adjacent code, at <= 0.1 % of a leaf's
entries (``tests/test_torch_crosspod.py``'s rule for a gradient a few ulps
off).  Under Mixed^Hi the gradients are bf16: each data rank rounds its
half-batch gradient to bf16 before the reduce, so the 2x2 run drifts from
the unsharded one by bf16 ulps, as Mixed^Hi without a codec does (losses
2.2e-3 apart after 7 steps at this size); it is held to one bf16 ulp at
1.0 (2^-8) in its losses and to 5e-3 in its masters, and again on a
(data=1, model=4) mesh, where no data split rounds the gradients and the
model-sharded update, the gathered re-encode and the codes must equal the
unsharded run's bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conftest import make_batch, tiny_dense_cfg
from repro.common.pytree import flatten_with_paths as jflat
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import CrossPodConfig as JCrossPodConfig
from repro.core import HiFTConfig as JHiFTConfig
from repro.core import LRSchedule as JLRSchedule
from repro.core import QuantConfig as JQuantConfig
from repro.core import StreamConfig as JStreamConfig
from repro.core import make_runner as jax_make_runner
from repro.models import moe as JM
from repro.models import transformer as JT

_REPO = Path(__file__).resolve().parent.parent
WORLD = 4

LINEAR = {"hift_sgd", "fpft_sgd", "mezo", "lomo", "fpft_crosspod",
          "hift_sgd_masked", "fpft_sgd_masked", "lomo_masked", "lomo_stream"}
ADAPTIVE = {"hift_adamw", "fpft_adamw", "adalomo", "hift_crosspod", "lisa",
            "hift_pipelined", "hift_nf4", "hift_pipelined_nf4", "lisa_nf4",
            "fpft_streamed",
            "adalomo_stream", "fpft_adafactor", "hift_adafactor",
            "fpft_adamw_clip"}
# bf16 gradients (Mixed^Hi) on the 2x2 mesh; the same case on 1x4
BF16 = {"hift_int8_mixed"}
EXACT = {"hift_int8_mixed/1x4"}
QUANT = ("hift_nf4", "hift_pipelined_nf4", "lisa_nf4",
         "hift_int8_mixed/1x4")


def _moe_cfg():
    return JArchConfig(name="tiny-moe", family="moe", n_layers=2, d_model=32,
                       n_heads=4, kv_heads=2, d_ff=64, vocab=128,
                       n_experts=4, top_k=2, n_shared_experts=1, moe_d_ff=32,
                       block_q=16, block_k=16, ce_chunk=0)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    cfg = tiny_dense_cfg(ce_chunk=0)
    params = jax.tree.map(np.asarray, JT.init(cfg, jax.random.PRNGKey(0)))
    batch = jax.tree.map(lambda x: np.asarray(x).astype(np.int64),
                         make_batch(cfg, batch=4, seq=32))
    masked = _masked_labels(batch["labels"])
    mp = jax.tree.map(np.asarray, JM.moe_ffn_init(jax.random.PRNGKey(1),
                                                  _moe_cfg()))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (4, 8, 32)))
    arrs = {f"p/{k}": v for k, v in jflat(params).items()}
    arrs.update({f"b/{k}": v for k, v in batch.items()})
    arrs.update({f"m/p/{k}": v for k, v in jflat(mp).items()})
    arrs["m/x"] = x
    arrs["masked_labels"] = masked
    np.savez(d / "in.npz", **arrs)
    return d, cfg, params, batch, mp, x


def _masked_labels(labels):
    """The labels with -1 (ignored) spans that leave the data ranks of a
    2x2 mesh (rows 0-1 and rows 2-3) different numbers of targets."""
    out = labels.copy()
    out[0, 20:] = -1
    out[2, 6:] = -1
    out[3, 12:] = -1
    return out


JAX_CASES = ("hift_sgd", "hift_adamw", "fpft_sgd", "fpft_adamw", "lomo",
             "adalomo", "fpft_crosspod", "hift_sgd_masked", "fpft_sgd_masked",
             "lomo_masked", "hift_nf4", "fpft_streamed", "fpft_adafactor")
# the JAX runner's steps held against the sharded run's first ones (HiFT:
# the embed, layer 0 and layer 1 groups, each a compile of its own)
JAX_STEPS = 3


@pytest.fixture(scope="module")
def runs(inputs):
    """The ranks' JSON, and the JAX runner's losses of ``JAX_CASES``,
    computed here while the workers run."""
    d, cfg, params, batch, _, _ = inputs
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(
        [sys.executable, str(_REPO / "tests" / "torch_dist_worker.py"),
         str(d / "store"), str(WORLD), str(r), str(d / "in.npz"), str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        jax_losses = {name: _jax_losses(cfg, params, batch, name)
                      for name in JAX_CASES}
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return dict(ranks=[json.loads((d / f"rank{r}.json").read_text())
                       for r in range(WORLD)], jax=jax_losses)


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["ranks"]


# the JAX runner's arguments for each case of JAX_CASES (a "_masked"
# case takes its base case's)
_JAX_KW = {
    "hift_sgd": ("hift", dict(optimizer="sgd", schedule=JLRSchedule(1e-2),
                              hift=JHiFTConfig(m=1))),
    "hift_adamw": ("hift", dict(optimizer="adamw",
                                schedule=JLRSchedule(1e-3),
                                hift=JHiFTConfig(m=1))),
    "fpft_sgd": ("fpft", dict(optimizer="sgd",
                              schedule=JLRSchedule(1e-2))),
    "fpft_adamw": ("fpft", dict(optimizer="adamw",
                                schedule=JLRSchedule(1e-3))),
    "lomo": ("lomo", dict(schedule=JLRSchedule(1e-2))),
    "adalomo": ("adalomo", dict(schedule=JLRSchedule(1e-3))),
    "fpft_crosspod": ("fpft", dict(
        optimizer="sgd", schedule=JLRSchedule(1e-2),
        cross_pod=JCrossPodConfig(pods=2, compress=True))),
    "hift_nf4": ("hift", dict(optimizer="adamw", schedule=JLRSchedule(1e-3),
                              hift=JHiFTConfig(m=1),
                              quant=JQuantConfig(frozen="nf4"))),
    "fpft_streamed": ("fpft_streamed", dict(
        optimizer="adamw", schedule=JLRSchedule(1e-3),
        stream=JStreamConfig(chunk_bytes=1 << 13))),
    "fpft_adafactor": ("fpft", dict(optimizer="adafactor",
                                    schedule=JLRSchedule(1e-3))),
}


def _jax_losses(cfg, params, batch, name):
    """The JAX runner's unsharded losses for a case of the worker (a
    ``_masked`` case on the masked labels)."""
    if name.endswith("_masked"):
        kw = _JAX_KW[name[:-len("_masked")]]
        batch = dict(batch, labels=_masked_labels(batch["labels"]))
    else:
        kw = _JAX_KW[name]
    runner = jax_make_runner(cfg, kw[0], params=jax.tree.map(jnp.asarray,
                                                              params), **kw[1])
    b = jax.tree.map(jnp.asarray, batch)
    return [float(runner.train_step(b)) for _ in range(JAX_STEPS)]


@pytest.mark.parametrize("name", sorted(LINEAR | ADAPTIVE | BF16 | EXACT))
def test_sharded_matches_unsharded(ranks, name):
    got = ranks[0][name]
    if name in EXACT:
        assert got["sharded"] == got["plain"]
        assert got["dparams"] == 0.0
        return
    ltol, ptol = ((1e-4, 1e-4) if name in LINEAR else
                  (2.0 ** -8, 5e-3) if name in BF16 else (1e-3, 5e-3))
    np.testing.assert_allclose(got["sharded"], got["plain"], atol=ltol)
    assert got["dparams"] < ptol, got["dparams"]


@pytest.mark.parametrize("name", QUANT)
def test_quantized_residency_on_the_mesh(ranks, name):
    """The resident codes after the run: a code moves only to an adjacent
    one, at <= 0.1 % of a leaf's entries (on 1x4: none moves), and the
    active group's bundle holds model-sharded leaves."""
    got = ranks[0][name]
    codes = got["codes"]
    assert codes["records"] > 0
    assert codes["max_code_step"] <= 1, codes
    assert codes["max_changed_frac"] <= 1e-3, codes
    if name in EXACT:
        assert codes["max_code_step"] == 0, codes
    assert got["sharded_opt_leaves"] > 0


def test_streamed_moments_are_model_sharded(ranks):
    """fpft_streamed's host moments are the rank's shards (and so are
    the params); the coupled optimizers still shard the params."""
    assert ranks[0]["fpft_streamed"]["sharded_opt_leaves"] > 0
    for name in ("fpft_adafactor", "fpft_adamw_clip", "lomo_stream",
                 "adalomo_stream"):
        assert ranks[0][name]["sharded_leaves"] > 0, name


def test_fpft_streamed_state_continues_in_fpft_on_the_mesh(ranks):
    """A sharded ``fpft_streamed`` state saved under the mesh restores into
    a mesh-built ``fpft`` runner, and the next step is bit-equal."""
    for r in ranks:
        c = r["ckpt_streamed"]
        assert c["losses"][0] == c["losses"][1]
        assert c["dparams"] == 0.0 and c["dopt"] == 0.0


# the strategies the reference's sharded workers hold; the others are held
# to the unsharded port above, which the other port files hold to JAX
@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_losses_match_jax(runs, name):
    ltol = 1e-4 if name in LINEAR else 1e-3
    np.testing.assert_allclose(runs["ranks"][0][name]["sharded"][:JAX_STEPS],
                               runs["jax"][name], atol=ltol)


def test_the_masked_batch_splits_its_targets_unequally(inputs):
    """The ``_masked`` cases' premise: the two data ranks' rows hold
    different numbers of labelled targets, so a plain mean of the ranks'
    losses would not be the batch's."""
    labels = _masked_labels(inputs[3]["labels"])
    counts = [(labels[rows, 1:] >= 0).sum() for rows in (slice(0, 2),
                                                        slice(2, 4))]
    assert counts[0] > 2 * counts[1] > 0, counts


def test_the_mesh_shards_and_the_ranks_agree_bitwise(ranks):
    assert ranks[0]["mesh"] == {"data": 2, "model": 2}
    assert "needs 8 ranks" in ranks[0]["too_big"]     # a world of 4
    # the model axis really splits the AdamW moments and the FPFT params
    assert ranks[0]["fpft_adamw"]["sharded_leaves"] > 0
    assert ranks[0]["hift_adamw"]["sharded_leaves"] > 0
    for r in ranks[1:]:
        for name in LINEAR | ADAPTIVE | BF16 | EXACT:
            assert r[name]["sharded"] == ranks[0][name]["sharded"], name
            assert r[name]["digest"] == ranks[0][name]["digest"], name


def test_checkpoint_gathers_sharded_leaves_and_resumes_in_lockstep(
        inputs, ranks):
    for r in ranks:
        c = r["ckpt"]
        assert c["gathered_leaves"] > 0
        assert c["resumed"][0] == c["resumed"][1]
        assert c["pre"] == ranks[0]["ckpt"]["pre"]
    # the format is unchanged: the reference reads what the mesh wrote,
    # every leaf whole and equal to the port's own read
    from repro.train import checkpoint as jckpt
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.train import checkpoint as ckpt
    d = inputs[0] / "shared" / "ckpt"
    want = flatten_with_paths(ckpt.restore(d, 2))
    got = jflat(jckpt.restore(d, 2))
    assert got.keys() == want.keys()
    for path, t in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), t.numpy(),
                                      err_msg=path)
    assert want["params/embed/tok"].shape == (256, 64)


@pytest.mark.parametrize("name", ["hift_adamw", "fpft_adamw", "adalomo",
                                  "fpft_crosspod", "hift_nf4",
                                  "fpft_streamed"])
def test_elastic_restore_onto_1x4_and_4x1(ranks, name):
    res = ranks[0][f"elastic/{name}"]
    tol = 1e-4 if name == "fpft_crosspod" else 1e-3
    for spec in ("1x4", "4x1"):
        assert res[f"{spec}/drelayout"] == 0.0      # a relayout, bit-exact
        np.testing.assert_allclose(res[spec], res["ref"], atol=tol)


def test_moe_spmd_matches_the_per_shard_oracle(inputs, ranks):
    """Each rank's expert-parallel output equals JAX's ``moe_ffn`` on its
    data shard's tokens (the same local capacity); its gradients equal the
    port's single-device ``moe_ffn`` on those rows; at tp = 1 the path is
    ``moe_ffn`` bit for bit."""
    _, _, _, _, mp, x = inputs
    cfg = _moe_cfg()
    for r in ranks:
        m = r["moe"]
        rows = np.split(x, 2)[m["rank"][0]]
        want = np.asarray(JM.moe_ffn(jax.tree.map(jnp.asarray, mp),
                                     jnp.asarray(rows), cfg))
        np.testing.assert_allclose(np.asarray(m["out"]), want, rtol=1e-5,
                                   atol=1e-5)
        assert m["dout"] < 1e-5
        assert m["dgrad"] < 1e-5 * max(m["gscale"], 1.0)
        assert m["tp1_bitwise"]
        assert m["ctx_ok"]       # the constrain helpers, in and out of it


@pytest.mark.parametrize("e_base", [0, 2])
def test_local_dispatch_matches_the_reference(inputs, e_base):
    import torch

    from repro_torch import bridge
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import moe as M
    _, _, _, _, mp, x = inputs
    jcfg = _moe_cfg()
    cfg = ArchConfig(**{f: getattr(jcfg, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "kv_heads",
        "d_ff", "vocab", "n_experts", "top_k", "n_shared_experts",
        "moe_d_ff", "block_q", "block_k", "ce_chunk")})
    xt = x.reshape(-1, 32)
    logits = (xt @ mp["router"]).astype(np.float32)
    el = 2
    sl = slice(e_base, e_base + el)
    want = JM._local_dispatch_ffn(
        jnp.asarray(xt), jnp.asarray(logits), jnp.asarray(mp["w_gate"][sl]),
        jnp.asarray(mp["w_up"][sl]), jnp.asarray(mp["w_down"][sl]), jcfg,
        e_base, el)
    p = bridge.to_torch(mp)
    got = M._local_dispatch_ffn(
        torch.tensor(xt), torch.tensor(logits), p["w_gate"][sl],
        p["w_up"][sl], p["w_down"][sl], cfg, e_base, el)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------- mesh specs

def test_parse_mesh_spec_forms():
    from repro_torch.launch.mesh import parse_mesh_spec
    assert parse_mesh_spec("2x4") == {"data": 2, "model": 4}
    assert parse_mesh_spec("2,4") == {"data": 2, "model": 4}
    assert parse_mesh_spec("data=2,model=4") == {"data": 2, "model": 4}
    assert parse_mesh_spec("pod=2,data=2,model=2") == \
        {"pod": 2, "data": 2, "model": 2}


@pytest.mark.parametrize("bad", ["", "2x4x8", "0x4", "data=2,data=2", "=3"])
def test_parse_mesh_spec_rejects(bad):
    from repro_torch.launch.mesh import parse_mesh_spec
    with pytest.raises(ValueError):
        parse_mesh_spec(bad)


def test_mesh_needs_a_process_group_and_one_device_a_process():
    from repro_torch.launch import mesh as lm
    with pytest.raises(ValueError, match="init_distributed"):
        lm.mesh_from_spec("2x2")
    with pytest.raises(ValueError, match="one process drives"):
        lm.init_distributed("file:///nonexistent", 2, 0,
                            local_device_count=2, device="cpu")


def test_the_launcher_trains_under_a_coordinator(tmp_path):
    """Two launcher processes on a (data=2, model=1) mesh through a
    FileStore, gloo on the CPU: both print the ``distributed: process i/n``
    line and train in lockstep."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(_REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama2-7b", "--smoke", "--steps", "2", "--seq", "32",
           "--device", "cpu", "--mesh", "2x1", "--coordinator",
           f"file://{tmp_path}/store", "--num-processes", "2",
           "--crosspod-pods", "2", "--strategy", "fpft", "--process-id"]
    procs = [subprocess.Popen(cmd + [str(i)], env=env, cwd=tmp_path,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"distributed: process {i}/2, gloo backend" in out
        assert "mesh {'data': 2, 'model': 1}" in out
    finals = [o.split("done: final loss")[1].split()[0] for o in outs]
    assert finals[0] == finals[1]


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b",
                                  "seamless-m4t-large-v2", "internvl2-26b",
                                  "deepseek-moe-16b"])
def test_the_other_families_train_on_the_mesh(ranks, arch):
    """HiFT with AdamW (losses within 1e-3) and FPFT with SGD (1e-4) of
    each family's smoke config give the unsharded port's losses on the
    2x2 mesh; the moe
    config drops no route, so expert parallelism is held to the
    single-device dispatch."""
    for strategy, tol in (("hift", 1e-3), ("fpft", 1e-4)):
        got = ranks[0][f"family/{arch}/{strategy}"]
        np.testing.assert_allclose(got["sharded"], got["plain"], atol=tol)


# ------------------------------------------------------ placement rules

def _stub_mesh(**sizes):
    """What the rules read of a mesh: its axis names and its shape."""
    from types import SimpleNamespace
    import torch
    return SimpleNamespace(mesh_dim_names=tuple(sizes),
                           mesh=torch.zeros(tuple(sizes.values())),
                           axis_names=tuple(sizes),
                           devices=np.zeros(tuple(sizes.values())),
                           device_type="cpu")


def _dims(spec, mesh, ndim):
    """A port spec (one placement a mesh dim) as the reference's
    PartitionSpec entries (one a tensor dim)."""
    from torch.distributed.tensor import Shard
    out = [None] * ndim
    for name, p in zip(mesh.mesh_dim_names, spec):
        if isinstance(p, Shard):
            out[p.dim] = (out[p.dim] or ()) + (name,)
    return out


def _ref_dims(pspec, ndim):
    entries = list(pspec) + [None] * (ndim - len(pspec))
    return [None if e is None else (e,) if isinstance(e, str) else tuple(e)
            for e in entries]


@pytest.mark.parametrize("sizes", [dict(data=2, model=2),
                                   dict(data=2, model=4),
                                   dict(pod=2, data=2, model=2),
                                   dict(data=4, model=1)])
def test_placement_rules_match_the_reference(monkeypatch, sizes):
    """Every structural rule of ``dist.shardings`` against the
    reference's on the same shapes (its ``NamedSharding`` stubbed to hand
    back the PartitionSpec, so no fabricated devices are needed)."""
    import torch

    from repro.dist import shardings as JS
    from repro_torch.dist import shardings as S
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    mesh = _stub_mesh(**sizes)
    shapes = {"embed": (256, 64), "layers/w": (4, 64, 128),
              "layers/b": (4, 128), "scale": (64,), "odd": (3, 5),
              "count": ()}
    tree = {k: torch.zeros(v) for k, v in shapes.items()}
    jtree = {k: np.zeros(v) for k, v in shapes.items()}
    batch = {"tokens": torch.zeros(8, 16), "odd": torch.zeros(3, 16)}
    jbatch = {k: np.zeros(tuple(v.shape)) for k, v in batch.items()}
    res = {k: torch.zeros((2,) + v) for k, v in shapes.items()}
    jres = {k: np.zeros((2,) + v) for k, v in shapes.items()}
    chunks = {"c": torch.zeros(1024), "d": torch.zeros(7)}
    jchunks = {k: np.zeros(tuple(v.shape)) for k, v in chunks.items()}
    bundle = {"opt": {"m": tree, "count": torch.zeros(())}, "ef": res}
    jbundle = {"opt": {"m": jtree, "count": np.zeros(())}, "ef": jres}
    pairs = [(S.param_shardings(tree, mesh), JS.param_shardings(jtree, mesh),
              tree),
             (S.replicated(tree, mesh), JS.replicated(jtree, mesh), tree),
             (S.opt_state_shardings(tree, tree, mesh),
              JS.opt_state_shardings(jtree, jtree, mesh), tree),
             (S.batch_shardings(batch, mesh),
              JS.batch_shardings(jbatch, mesh), batch),
             (S.crosspod_residual_shardings(res, mesh),
              JS.crosspod_residual_shardings(jres, mesh), res),
             (S.chunk_window_shardings(chunks, mesh),
              JS.chunk_window_shardings(jchunks, mesh), chunks),
             (S.bundle_shardings(bundle, mesh),
              JS.bundle_shardings(jbundle, mesh), bundle)]
    from repro_torch.common.pytree import flatten_with_paths
    for got, want, like in pairs:
        got, want = flatten_with_paths(got), flatten_with_paths(want)
        for path, t in flatten_with_paths(like).items():
            assert _dims(got[path], mesh, t.ndim) == \
                _ref_dims(want[path], t.ndim), path
    assert S.data_axes(mesh) == JS.data_axes(mesh)
    # a bundle mirrors its active group's specs path by path, the "ef"
    # residuals shifted past the pods dim
    specs = S.param_shardings(tree, mesh)
    mirrored = flatten_with_paths(S.mirror_specs(
        bundle, {k: tuple(v.shape) for k, v in tree.items()},
        flatten_with_paths(specs), mesh))
    want = flatten_with_paths(S.bundle_shardings(bundle, mesh))
    assert mirrored == want


def _tiny_torch_params():
    import torch

    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import get_family
    cfg = ArchConfig(name="tiny", family="dense", n_layers=4, d_model=64,
                     n_heads=4, kv_heads=2, d_ff=128, vocab=256, block_q=16,
                     block_k=16, ce_chunk=0)
    return cfg, get_family(cfg).init(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")


def _numpy_like(tree):
    from repro_torch.common.pytree import (flatten_with_paths,
                                           unflatten_from_paths)
    return unflatten_from_paths({p: np.zeros(tuple(t.shape)) for p, t in
                                 flatten_with_paths(tree).items()})


def _same_specs(got, want, like, mesh):
    from repro_torch.common.pytree import flatten_with_paths
    got, want = flatten_with_paths(got), flatten_with_paths(want)
    for path, t in flatten_with_paths(like).items():
        assert _dims(got[path], mesh, t.ndim) == \
            _ref_dims(want[path], t.ndim), path


@pytest.mark.parametrize("sizes", [dict(data=2, model=2),
                                   dict(data=4, model=1),
                                   dict(data=1, model=4)])
def test_record_and_quantized_bundle_placements_match_the_reference(
        monkeypatch, sizes):
    """The param and replicated rules on int8 and NF4 record trees (the
    zero-size templates included) equal the reference's leaf for leaf, and
    the quantized grouped step's bundle specs (the param rule on the dense
    tree the records decode to, mirrored into the master and moments)
    equal the reference's ``bundle_shardings`` of the same bundle, for
    every group."""
    from repro.dist import shardings as JS
    from repro_torch.core import HiFTConfig, QuantConfig, make_strategy
    from repro_torch.core import split_params
    from repro_torch.dist import shardings as S
    from repro_torch.dist.quant import quantize_tree
    from repro_torch.optim import make_optimizer
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    mesh = _stub_mesh(**sizes)
    cfg, params = _tiny_torch_params()
    for fmt in ("int8", "nf4"):
        records = quantize_tree(params, fmt)
        jrecords = _numpy_like(records)
        _same_specs(S.param_shardings(records, mesh),
                    JS.param_shardings(jrecords, mesh), records, mesh)
        _same_specs(S.replicated(records, mesh),
                    JS.replicated(jrecords, mesh), records, mesh)
        strategy = make_strategy("hift", cfg, make_optimizer("adamw"),
                                 device="cpu", mesh=mesh,
                                 hift=HiFTConfig(m=1),
                                 quant=QuantConfig(frozen=fmt))
        for group in strategy.groups:
            active, _ = split_params(records, group)
            bundle = strategy._init_bundle(active)
            specs, shapes = strategy._step_specs(active)
            _same_specs(strategy._bundle_specs(bundle, shapes, specs),
                        JS.bundle_shardings(_numpy_like(bundle), mesh),
                        bundle, mesh)


def test_no_mesh_refusal_is_left():
    """Every option the reference runs under a mesh constructs under one
    with a model axis of 2: quantized residency in the grouped
    strategies, the streamed strategies, and the coupled optimizers."""
    from repro_torch.core import (LiSAConfig, QuantConfig, StreamConfig,
                                  make_strategy)
    from repro_torch.optim import make_optimizer
    mesh = _stub_mesh(data=2, model=2)
    cfg, _ = _tiny_torch_params()
    adamw = make_optimizer("adamw")
    nf4 = dict(quant=QuantConfig(frozen="nf4"))
    built = [make_strategy(name, cfg, opt, device="cpu", mesh=mesh, **kw)
             for name, opt, kw in (
                 ("hift", adamw, nf4), ("hift_pipelined", adamw, nf4),
                 ("lisa", adamw, dict(nf4, lisa=LiSAConfig(m=1))),
                 ("fpft_streamed", adamw, {}),
                 ("lomo", None, dict(stream=StreamConfig())),
                 ("adalomo", None, dict(stream=StreamConfig())),
                 ("fpft", make_optimizer("adafactor"), {}),
                 ("hift", make_optimizer("adafactor"), {}),
                 ("fpft", make_optimizer("adamw", grad_clip=1.0), {}))]
    assert [s._coupled_update for s in built[-3:]] == [True] * 3
    assert not any(s._coupled_update for s in built[:-3])
