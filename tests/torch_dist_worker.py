"""One rank of the port's multi-process CPU run (test_torch_distributed.py).

    python tests/torch_dist_worker.py STORE WORLD RANK INPUTS OUTDIR

Joins a gloo process group of WORLD processes through the FileStore
STORE (one device, one intra-op thread a process), builds the (data=2,
model=2) mesh and runs, on the tiny dense config of
tests/sharded_worker.py and the params and batch in INPUTS (an .npz the
parent wrote from the JAX package's init):

- every strategy unsharded and on the mesh (losses, final params
  gathered), cross-pod FPFT among them; quantized residency (NF4, int8
  under Mixed^Hi: the masters, the resident codes' distance), streamed
  FPFT and streamed LOMO/AdaLomo, Adafactor and a global-norm clip under
  the model axis; three of them again on a batch whose data ranks hold
  different numbers of labelled targets (``MASKED``);
- a checkpoint of a sharded FPFT state and a lockstep resume; a sharded
  ``fpft_streamed`` state restored into a mesh-built ``fpft`` runner;
- the elastic resize: 3 steps on 2x2, then ``restore_state(strategy=)``
  onto 1x4 and 4x1;
- expert-parallel moe on the mesh against ``moe_ffn`` on the rank's data
  rows, with gradients;
- HiFT and FPFT of every other family's smoke config (``FAMILIES``).

Writes OUTDIR/rank<RANK>.json.  Not named test_*: pytest must not
collect it.  It imports neither jax nor repro.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

_SRC = Path(__file__).resolve().parent.parent / "src"
sys.path.insert(0, str(_SRC))

from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import flatten_with_paths  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import (AdaLomoConfig, CrossPodConfig,  # noqa: E402
                              HiFTConfig, LiSAConfig, LRSchedule, QuantConfig,
                              StreamConfig, make_runner)
from repro_torch.dist.quant import is_quantized, unpack_nf4  # noqa: E402
from repro_torch.optim import get_policy, make_optimizer  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.dist import shardings as S  # noqa: E402
from repro_torch.launch.mesh import init_distributed, mesh_from_spec  # noqa
from repro_torch.train import checkpoint as ckpt  # noqa: E402


def tiny_cfg():
    return ArchConfig(name="tiny", family="dense", n_layers=4, d_model=64,
                      n_heads=4, kv_heads=2, d_ff=128, vocab=256,
                      block_q=16, block_k=16, ce_chunk=0)


def moe_cfg():
    return ArchConfig(name="tiny-moe", family="moe", n_layers=2, d_model=32,
                      n_heads=4, kv_heads=2, d_ff=64, vocab=128,
                      n_experts=4, top_k=2, n_shared_experts=1,
                      moe_d_ff=32, block_q=16, block_k=16, ce_chunk=0)


def _load(path):
    data = np.load(path)
    flat = {k[2:]: data[k] for k in data.files if k.startswith("p/")}
    from repro_torch.common.pytree import unflatten_from_paths
    batch = {k[2:]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith("b/")}
    masked = dict(batch, labels=torch.from_numpy(data["masked_labels"]))
    moe = {k[2:]: data[k] for k in data.files if k.startswith("m/")}
    return (bridge.to_torch(unflatten_from_paths(flat)), batch, masked,
            unflatten_from_paths(moe))


def _steps(runner, batches):
    return [float(runner.train_step(b)) for b in batches]


def _full(tree):
    return {p: t.detach().float() for p, t in
            flatten_with_paths(S.gather(tree)).items()}


def _diff(a, b):
    fa, fb = _full(a), _full(b)
    assert fa.keys() == fb.keys()
    # a codec record's zero-size template holds no value
    return max(float((fa[p] - fb[p]).abs().max()) for p in fa
               if fa[p].numel())


def _digest(tree):
    """Bytes of every leaf, for the ranks' bit-equality check."""
    import hashlib
    h = hashlib.sha256()
    for p, t in sorted(_full(tree).items()):
        h.update(p.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


# fpft_streamed's chunk bytes: the rank's shards of the tiny params make
# dozens of chunks
STREAM_CHUNK = 1 << 13

CASES = {
    "hift_sgd": ("hift", dict(optimizer="sgd", schedule=LRSchedule(1e-2),
                              hift=HiFTConfig(m=1)), "k+1"),
    "hift_adamw": ("hift", dict(optimizer="adamw",
                                schedule=LRSchedule(1e-3),
                                hift=HiFTConfig(m=1)), "k+1"),
    "fpft_sgd": ("fpft", dict(optimizer="sgd", schedule=LRSchedule(1e-2)), 3),
    "fpft_adamw": ("fpft", dict(optimizer="adamw",
                                schedule=LRSchedule(1e-3)), 3),
    "mezo": ("mezo", dict(schedule=LRSchedule(1e-3)), 3),
    "lomo": ("lomo", dict(schedule=LRSchedule(1e-2)), 3),
    "adalomo": ("adalomo", dict(schedule=LRSchedule(1e-3)), 3),
    "fpft_crosspod": ("fpft", dict(optimizer="sgd", schedule=LRSchedule(1e-2),
                                   cross_pod=CrossPodConfig(2, True)), 3),
    "hift_crosspod": ("hift", dict(optimizer="adamw",
                                   schedule=LRSchedule(1e-3),
                                   hift=HiFTConfig(m=1),
                                   cross_pod=CrossPodConfig(2, True)), "k+1"),
    "lisa": ("lisa", dict(optimizer="adamw", schedule=LRSchedule(1e-3),
                          lisa=LiSAConfig(m=1, switch_every=1)), 3),
    "hift_pipelined": ("hift_pipelined", dict(optimizer="adamw",
                                              schedule=LRSchedule(1e-3)),
                       "k+1"),
    "hift_nf4": ("hift", dict(optimizer="adamw", schedule=LRSchedule(1e-3),
                              hift=HiFTConfig(m=1),
                              quant=QuantConfig(frozen="nf4")), "k+1"),
    "hift_int8_mixed": ("hift", dict(
        optimizer="adamw", schedule=LRSchedule(1e-3), hift=HiFTConfig(m=1),
        policy=get_policy("mixed_hi"),
        quant=QuantConfig(frozen="int8", moments="bf16")), "k+1"),
    "hift_pipelined_nf4": ("hift_pipelined", dict(
        optimizer="adamw", schedule=LRSchedule(1e-3),
        quant=QuantConfig(frozen="nf4")), "k+1"),
    "lisa_nf4": ("lisa", dict(optimizer="adamw", schedule=LRSchedule(1e-3),
                              lisa=LiSAConfig(m=1, switch_every=1),
                              quant=QuantConfig(frozen="nf4")), 3),
    "fpft_streamed": ("fpft_streamed", dict(
        optimizer="adamw", schedule=LRSchedule(1e-3),
        stream=StreamConfig(chunk_bytes=STREAM_CHUNK)), 3),
    "lomo_stream": ("lomo", dict(schedule=LRSchedule(1e-2),
                                 stream=StreamConfig()), 3),
    "adalomo_stream": ("adalomo", dict(schedule=LRSchedule(1e-3),
                                       stream=StreamConfig()), 3),
    "fpft_adafactor": ("fpft", dict(optimizer="adafactor",
                                    schedule=LRSchedule(1e-3)), 3),
    "hift_adafactor": ("hift", dict(optimizer="adafactor",
                                    schedule=LRSchedule(1e-3),
                                    hift=HiFTConfig(m=1)), "k+1"),
    "fpft_adamw_clip": ("fpft", dict(
        optimizer=make_optimizer("adamw", grad_clip=1.0),
        schedule=LRSchedule(1e-3)), 3),
}


# cases run again on the masked batch (``<case>_masked``): the loss is a
# mean over labelled targets, which the data ranks hold in unequal numbers
MASKED = ("hift_sgd", "fpft_sgd", "lomo")
# cases run again on a (data=1, model=4) mesh (``<case>/1x4``): every rank
# differentiates the whole batch, so bf16 gradients round as the
# unsharded run's do and the model-sharded update is held bit for bit
MODEL_ONLY = ("hift_int8_mixed",)


def _model_sharded(tree) -> int:
    """The DTensor leaves of ``tree`` that shard a dim."""
    return sum(isinstance(t, S.DTensor) and any(
        isinstance(p, S.Shard) for p in t.placements)
        for t in flatten_with_paths(tree).values())


def _records(tree) -> dict:
    """{path: record} of the codec records of a (gathered) param tree."""
    out = {}

    def walk(node, path):
        if is_quantized(node):
            out[path] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)

    walk(S.gather(tree), "")
    return out


def _code_index(rec) -> torch.Tensor:
    """A record's codes as integers on the codebook's scale (NF4 nibbles
    unpacked)."""
    q = rec["q"]
    if q.dtype == torch.int8:
        return q.to(torch.int64)
    return unpack_nf4(q, rec["t"].shape[-1]).to(torch.int64)


def _codes(plain, shard) -> dict:
    """How far the mesh run's resident codes lie from the plain run's:
    the largest code distance and the largest share of a leaf's entries
    that differ."""
    a, b = _records(plain), _records(shard)
    step, frac = 0, 0.0
    for path, rec in a.items():
        d = (_code_index(rec) - _code_index(b[path])).abs()
        step = max(step, int(d.max()))
        frac = max(frac, float((d > 0).float().mean()))
    return {"records": len(a), "max_code_step": step,
            "max_changed_frac": frac}


def _masters(state) -> dict:
    """The bundles' fp32 masters and the params' unencoded leaves,
    gathered: what a quantized run's params are held by."""
    tree = S.gather(state.to_tree())
    out = {f"m/{gi}/{p}": t for gi, b in tree["opt_state"].items()
           for p, t in flatten_with_paths(b["master"]).items()}
    recs = _records(state.params)
    out.update({f"p/{p}": t for p, t in flatten_with_paths(
        tree["params"]).items() if not any(p.startswith(r + "/")
                                           for r in recs)})
    return out


def compare(cfg, params, batch, masked, mesh, out):
    runs = [(name, spec, batch) for name, spec in CASES.items()]
    runs += [(f"{name}_masked", CASES[name], masked) for name in MASKED]
    for name, (strategy, kw, n), batch in runs:
        plain = make_runner(cfg, strategy, params=params, device="cpu", **kw)
        shard = make_runner(cfg, strategy, params=params, device="cpu",
                            mesh=mesh, **kw)
        n = plain.k + 1 if n == "k+1" else n
        lp = _steps(plain, [batch] * n)
        out[name] = _held(plain, shard, _steps(shard, [batch] * n), lp,
                          "quant" in kw)
        if name in MODEL_ONLY:
            shard = make_runner(cfg, strategy, params=params, device="cpu",
                                mesh=mesh_from_spec("1x4"), **kw)
            out[f"{name}/1x4"] = _held(plain, shard,
                                       _steps(shard, [batch] * n), lp,
                                       "quant" in kw)


def _held(plain, shard, ls, lp, quant) -> dict:
    """What a case is held by: the losses, the params' (or under quant the
    masters' and the codes') distance from the unsharded run, the params'
    digest and the model-sharded leaves."""
    out = {"plain": lp, "sharded": ls, "digest": _digest(shard.params),
           "sharded_leaves": _model_sharded(shard.state.to_tree()),
           "sharded_opt_leaves": _model_sharded(shard.state.opt_state)}
    if quant:
        # the params are codes: the masters are held, and the codes by
        # their distance
        mp, ms = _masters(plain.state), _masters(shard.state)
        out["dparams"] = max(float((mp[p].float() - ms[p].float()).abs()
                                   .max()) for p in mp)
        out["codes"] = _codes(plain.params, shard.params)
    else:
        out["dparams"] = _diff(plain.params, shard.params)
    return out


def checkpoint(cfg, params, batch, mesh, out, root):
    kw = dict(optimizer="adamw", schedule=LRSchedule(1e-3), device="cpu")
    r = make_runner(cfg, "fpft", params=params, mesh=mesh, **kw)
    pre = _steps(r, [batch] * 2)
    d = Path(root) / "ckpt"
    ckpt.save_state(d, 2, r.state)
    gathered = ckpt.save.gathered_leaves
    restored = ckpt.restore_state(d, 2)
    r2 = make_runner(cfg, "fpft", params=params, mesh=mesh, **kw)
    r2.load_state_dict(restored.to_tree())
    out["ckpt"] = {"pre": pre, "gathered_leaves": int(gathered),
                   "resumed": _steps(r, [batch]) + _steps(r2, [batch])}
    # a sharded fpft_streamed state continues in a mesh-built fpft runner
    strategy, skw, _ = CASES["fpft_streamed"]
    r = make_runner(cfg, strategy, params=params, mesh=mesh, device="cpu",
                    **skw)
    _steps(r, [batch] * 2)
    d = Path(root) / "ckpt_streamed"
    ckpt.save_state(d, 2, r.state)
    r2 = make_runner(cfg, "fpft", params=params, mesh=mesh, **kw)
    r2.state = ckpt.restore_state(d, 2, strategy=r2.strategy)
    out["ckpt_streamed"] = {
        "losses": _steps(r, [batch]) + _steps(r2, [batch]),
        "dparams": _diff(r.params, r2.params),
        "dopt": _diff(r.state.opt_state, r2.state.opt_state)}


ELASTIC = {
    "hift_adamw": ("hift", dict(optimizer="adamw", schedule=LRSchedule(1e-3),
                                hift=HiFTConfig(m=1, strategy="random",
                                                seed=3))),
    "fpft_adamw": ("fpft", dict(optimizer="adamw", schedule=LRSchedule(1e-3))),
    "adalomo": ("adalomo", dict(schedule=LRSchedule(1e-3),
                                adalomo=AdaLomoConfig())),
    "fpft_crosspod": ("fpft", dict(optimizer="sgd", schedule=LRSchedule(1e-2),
                                   cross_pod=CrossPodConfig(2, True))),
    "hift_nf4": ("hift", dict(optimizer="adamw", schedule=LRSchedule(1e-3),
                              hift=HiFTConfig(m=1, strategy="random",
                                              seed=3),
                              quant=QuantConfig(frozen="nf4"))),
    "fpft_streamed": CASES["fpft_streamed"][:2],
}


def elastic(cfg, params, out, root):
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4, seed=0))
    batches = [data.batch_at(s) for s in range(6)]
    for name, (strategy, kw) in ELASTIC.items():
        res = {}
        runner = make_runner(cfg, strategy, params=params, device="cpu",
                             mesh=mesh_from_spec("2x2"), **kw)
        _steps(runner, batches[:3])
        d = Path(root) / f"el_{name}"
        ckpt.save_state(d, 3, runner.state)
        saved = ckpt.restore_state(d, 3)
        res["ref"] = _steps(runner, batches[3:])
        for spec in ("1x4", "4x1"):
            fresh = make_runner(cfg, strategy, params=params, device="cpu",
                                mesh=mesh_from_spec(spec), **kw)
            restored = ckpt.restore_state(d, 3, strategy=fresh.strategy)
            res[f"{spec}/drelayout"] = max(
                _diff(restored.params, saved.params),
                _diff(restored.opt_state, saved.opt_state) if
                flatten_with_paths(saved.opt_state) else 0.0,
                _diff(restored.extra.get("ef_residual", {"x": torch.zeros(1)}),
                      saved.extra.get("ef_residual", {"x": torch.zeros(1)})))
            fresh.state = restored
            res[spec] = _steps(fresh, batches[3:])
        out[f"elastic/{name}"] = res


FAMILIES = ("zamba2-2.7b", "xlstm-1.3b", "seamless-m4t-large-v2",
            "internvl2-26b", "deepseek-moe-16b")


def families(mesh, out):
    """Every other family's smoke config, HiFT with AdamW (2 steps) and
    FPFT with SGD (1 step), unsharded and on the mesh; the moe config with
    a capacity factor that drops no route, so its rows' local capacity
    changes nothing and expert parallelism must give the unsharded
    run's losses."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import SourceStubLM, VisionStubLM
    from repro_torch.models import get_family
    for arch in FAMILIES:
        cfg = get_config(arch, smoke=True)
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, capacity_factor=100.0)
        params = get_family(cfg).init(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
        src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                     global_batch=4, seed=0))
        if cfg.vision_tokens > 0:
            src = VisionStubLM(src, cfg.vision_tokens, cfg.d_model)
        elif cfg.family == "encdec":
            src = SourceStubLM(src, cfg.d_model)
        batches = [src.batch_at(s) for s in range(2)]
        for strategy, opt, n in (("hift", "adamw", 2), ("fpft", "sgd", 1)):
            kw = dict(params=params, optimizer=opt, device="cpu",
                      schedule=LRSchedule(1e-3))
            plain = make_runner(cfg, strategy, **kw)
            shard = make_runner(cfg, strategy, mesh=mesh, **kw)
            out[f"family/{arch}/{strategy}"] = {
                "plain": _steps(plain, batches[:n]),
                "sharded": _steps(shard, batches[:n])}


def moe(mesh, mp, out):
    """moe_ffn_spmd on the rank's data rows against moe_ffn on the same
    rows (the same local capacity), outputs and gradients."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist import ctx as dctx
    from repro_torch.models import moe as M

    cfg = moe_cfg()
    p = bridge.to_torch(mp["p"])
    x = torch.from_numpy(mp["x"])
    coord = mesh.get_coordinate()
    rows = x.chunk(2)[coord[0]]
    xd = DTensor.from_local(rows, mesh, (Shard(0), Replicate()),
                            run_check=False)
    with dctx.activation_sharding(mesh, ("data",)):
        got = M.moe_ffn_auto(p, xd, cfg).to_local()
    want = M.moe_ffn(p, rows, cfg)

    def grads(fn):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in flatten_with_paths(p).items()}
        xi = rows.clone().requires_grad_(True)
        from repro_torch.common.pytree import unflatten_from_paths
        y = fn(unflatten_from_paths(leaves), xi)
        w = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
        gs = torch.autograd.grad((y * w).sum(), [xi, *leaves.values()])
        return dict(zip(["x", *leaves], gs))

    with dctx.activation_sharding(mesh, ("data",)):
        g_spmd = grads(lambda q, xi: M.moe_ffn_spmd(q, xi, cfg))
    g_ref = grads(lambda q, xi: M.moe_ffn(q, xi, cfg))
    # the constrain helpers: the identity on plain tensors; a DTensor's
    # leading dim redistributed over the data axis inside the context
    full = torch.arange(32.0).reshape(4, 8)
    rep = DTensor.from_local(full, mesh, (Replicate(), Replicate()),
                             run_check=False)
    with dctx.activation_sharding(mesh, ("data",)):
        plain_same = dctx.constrain_layer_io(full) is full
        laid = dctx.constrain_tokens(rep)
        experts = dctx.constrain_expert(rep)
    ctx_ok = (plain_same and dctx.constrain_layer_io(rep) is rep
              and tuple(laid.placements) == (Shard(0), Replicate())
              and torch.equal(laid.to_local(), full.chunk(2)[coord[0]])
              and tuple(experts.placements) == (Replicate(), Shard(0))
              and torch.equal(experts.full_tensor(), full))
    # at tp = 1 the expert-parallel path is moe_ffn, bit for bit
    with dctx.activation_sharding(mesh_from_spec("4x1"), ("data",)):
        tp1 = M.moe_ffn_auto(p, rows, cfg)
    out["moe"] = {
        "ctx_ok": bool(ctx_ok),
        "tp1_bitwise": bool(torch.equal(tp1, want)),
        "out": got.tolist(), "dout": float((got - want).abs().max()),
        "dgrad": max(float((g_spmd[k] - g_ref[k]).abs().max())
                     for k in g_ref),
        "gscale": max(float(g_ref[k].abs().max()) for k in g_ref),
        "rank": list(coord)}


def main():
    store, world, rank, inputs, outdir = sys.argv[1:6]
    init_distributed(f"file://{store}", int(world), int(rank), device="cpu")
    cfg = tiny_cfg()
    params, batch, masked, mp = _load(inputs)
    mesh = mesh_from_spec("2x2")
    out = {"rank": int(rank), "mesh": S.sizes(mesh)}
    try:
        mesh_from_spec("4x2")
    except ValueError as e:
        out["too_big"] = str(e)
    root = Path(outdir) / "shared"
    compare(cfg, params, batch, masked, mesh, out)
    checkpoint(cfg, params, batch, mesh, out, root)
    elastic(cfg, params, out, root)
    moe(mesh, mp, out)
    families(mesh, out)
    Path(outdir, f"rank{rank}.json").write_text(json.dumps(out))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
