"""One rank of the port's multi-process serving run
(test_torch_mesh_serving.py).

    python tests/torch_serve_worker.py STORE WORLD RANK INPUTS OUTDIR

Joins a gloo process group of WORLD (4) processes through the FileStore
STORE (one device, one intra-op thread a process), builds the (data=2,
model=2) and (data=4, model=1) meshes and serves, at fp32 on the CPU:

- ``ServeEngine`` for the tiny dense config (the JAX-initialised params
  in INPUTS, an .npz the parent wrote) and each other family's smoke
  config (``FAMILIES``), without a mesh and on both meshes, the rows of
  each prefill counted (``RowSpy``); a batch of 3 on the 2x2 mesh, whose
  two data ranks cannot split it;
- ``ContinuousServeEngine`` on the 2x2 mesh, more requests than slots;
- the train→serve handoff: 2 FPFT SGD steps on the 2x2 mesh, then
  ``from_train_state`` with ``mesh=`` and with ``mesh=None``, against an
  engine on the gathered params;
- last, in a second process group (STORE + "2"), the serve launcher with
  ``--mesh 2x2 --coordinator``, its standard output kept.

Each case's exception is kept in place of its result, so the ranks run
the same cases and reach the end together.  Writes
OUTDIR/rank<RANK>.json.  Not named test_*: pytest must not collect it.
It imports neither jax nor repro.
"""
import contextlib
import io
import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

_SRC = Path(__file__).resolve().parent.parent / "src"
sys.path.insert(0, str(_SRC))

from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import (flatten_with_paths,  # noqa: E402
                                       unflatten_from_paths)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import LRSchedule, make_runner  # noqa: E402
from repro_torch.dist import shardings as S  # noqa: E402
from repro_torch.launch.mesh import init_distributed, mesh_from_spec  # noqa
from repro_torch.models import get_family  # noqa: E402
from repro_torch.serve.engine import (ContinuousServeEngine,  # noqa: E402
                                      ServeEngine)
from repro_torch.serve.scheduler import ServeRequest  # noqa: E402

FAMILIES = ("internvl2-26b", "zamba2-2.7b", "deepseek-moe-16b",
            "seamless-m4t-large-v2", "xlstm-1.3b")
MAX_NEW = 6
# the continuous case: five requests over two slots (refills), each with
# its own budget
CONT_NEW = (6, 3, 8, 2, 5)


def tiny_cfg():
    return ArchConfig(name="tiny", family="dense", n_layers=4, d_model=64,
                      n_heads=4, kv_heads=2, d_ff=128, vocab=256,
                      block_q=16, block_k=16, ce_chunk=0)


def _load(path):
    data = np.load(path)
    params = unflatten_from_paths({k[2:]: data[k] for k in data.files
                                   if k.startswith("p/")})
    batch = {k[2:]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith("b/")}
    prompts = [data[f"prompt/{i}"] for i in range(4)]
    return bridge.to_torch(params), batch, prompts


class RowSpy:
    """A family module whose ``prefill`` records its batch's rows."""

    def __init__(self, model):
        self.model, self.rows = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, cfg, params, batch, *a, **kw):
        self.rows.append(int(batch["tokens"].shape[0]))
        return self.model.prefill(cfg, params, batch, *a, **kw)


def _model_sharded(tree) -> int:
    """Leaves of ``tree`` that are DTensors split over the model axis."""
    n = 0
    for t in flatten_with_paths(tree).values():
        if isinstance(t, S.DTensor):
            names = t.device_mesh.mesh_dim_names
            n += any(isinstance(p, S.Shard) and a == "model"
                     for a, p in zip(names, t.placements))
    return n


def _generate(cfg, params, prompts, batch=4, mesh=None, **kw):
    vt = cfg.vision_tokens
    eng = ServeEngine(cfg, params, max_len=vt + 12 + MAX_NEW, batch=batch,
                      device="cpu", mesh=mesh)
    spy = eng.model = RowSpy(eng.model)
    toks = eng.generate(prompts, max_new_tokens=MAX_NEW, **kw)
    return {"tokens": toks, "rows": spy.rows,
            "model_sharded": _model_sharded(eng.params)}


def _case(out, name, fn):
    try:
        out[name] = fn()
    except Exception:                 # kept, so every rank runs every case
        out[name] = {"error": traceback.format_exc()}


def families(dense_params, prompts, meshes, out):
    """Each family's engine without a mesh and on each mesh."""
    cases = [("tiny", tiny_cfg(), dense_params, prompts)]
    for arch in FAMILIES:
        cfg = get_config(arch, smoke=True)
        params = get_family(cfg).init(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
        rng = np.random.default_rng(5)
        cases.append((arch, cfg, params, [rng.integers(1, cfg.vocab, n)
                                          for n in (7, 12, 4, 9)]))
    for arch, cfg, params, ps in cases:
        kw = {}
        if cfg.family == "encdec":
            kw["src_embeds"] = torch.randn(
                (4, 10, cfg.d_model), generator=torch.Generator()
                .manual_seed(99))
        _case(out, f"serve/{arch}/plain",
              lambda: _generate(cfg, params, ps, **kw))
        for spec, mesh in meshes.items():
            _case(out, f"serve/{arch}/{spec}",
                  lambda: _generate(cfg, params, ps, mesh=mesh, **kw))
    # a batch of 3 on two data ranks: the rows replicate
    _case(out, "serve/tiny3/plain",
          lambda: _generate(tiny_cfg(), dense_params, prompts[:3], batch=3))
    _case(out, "serve/tiny3/2x2",
          lambda: _generate(tiny_cfg(), dense_params, prompts[:3], batch=3,
                            mesh=meshes["2x2"]))


def continuous(params, prompts, mesh, out):
    def run(mesh):
        eng = ContinuousServeEngine(tiny_cfg(), params, slots=2,
                                    prefill_bucket=16, device="cpu",
                                    mesh=mesh)
        reqs = [ServeRequest(prompt=list(map(int, prompts[i % 4])),
                             max_new_tokens=n)
                for i, n in enumerate(CONT_NEW)]
        eng.run(reqs)
        return {"tokens": [r.out_tokens for r in reqs],
                "refills": eng.scheduler.stats.n_refills,
                "model_sharded": _model_sharded(eng.params)}

    _case(out, "continuous/plain", lambda: run(None))
    _case(out, "continuous/2x2", lambda: run(mesh))


def handoff(params, batch, mesh):
    """The reference's ``serve_handoff`` (tests/sharded_worker.py): 2
    sharded FPFT steps, then the state into an engine, with ``mesh=`` and
    with ``mesh=None``, against the unsharded engine on the gathered
    params."""
    cfg = tiny_cfg()
    runner = make_runner(cfg, "fpft", params=params, mesh=mesh,
                         optimizer="sgd", schedule=LRSchedule(1e-2),
                         device="cpu")
    for _ in range(2):
        runner.train_step(batch)
    state = runner.state
    rng = np.random.default_rng(11)
    ps = [rng.integers(0, cfg.vocab, 6 + 3 * i) for i in range(2)]
    kw = dict(max_len=48, batch=2, device="cpu")
    res = {"state_model_sharded": _model_sharded(state.params)}
    full = S.gather(state.params)
    res["want"] = ServeEngine(cfg, full, **kw).generate(ps, MAX_NEW)

    def serve(m):
        on = {} if m is None else {"mesh": m}    # the default, as it was
        eng = ServeEngine.from_train_state(cfg, state, **on, **kw)
        return {"tokens": eng.generate(ps, MAX_NEW),
                "model_sharded": _model_sharded(eng.params)}

    _case(res, "mesh", lambda: serve(mesh))
    _case(res, "none", lambda: serve(None))
    return res


def launcher(store, world, rank):
    """The serve launcher under ``--coordinator`` on a 2x2 mesh, in a
    process group of its own; its standard output."""
    from repro_torch.launch import serve as launch_serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main([
            "--arch", "llama2-7b", "--smoke", "--device", "cpu",
            "--requests", "4", "--max-new", str(MAX_NEW), "--mesh", "2x2",
            "--coordinator", f"file://{store}", "--num-processes",
            str(world), "--process-id", str(rank)])
    return buf.getvalue()


def main():
    store, world, rank, inputs, outdir = sys.argv[1:6]
    init_distributed(f"file://{store}", int(world), int(rank), device="cpu")
    params, batch, prompts = _load(inputs)
    meshes = {"2x2": mesh_from_spec("2x2"), "4x1": mesh_from_spec("4x1")}
    out = {"rank": int(rank)}
    families(params, prompts, meshes, out)
    continuous(params, prompts, meshes["2x2"], out)
    _case(out, "handoff", lambda: handoff(params, batch, meshes["2x2"]))
    dist.barrier()
    dist.destroy_process_group()
    _case(out, "launcher", lambda: launcher(store + "2", int(world),
                                            int(rank)))
    Path(outdir, f"rank{rank}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main()
