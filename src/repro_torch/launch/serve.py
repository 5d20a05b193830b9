"""Serving launcher: batched greedy generation for a ported ``--arch``.

    python -m repro_torch.launch.serve --arch llama2-7b --no-smoke --continuous
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --device cpu --smoke --requests 4 --max-new 16

Port of ``repro.launch.serve`` with the same flags, plus ``--device``
(default ``cuda``) and ``--seed``; ``--no-smoke`` reaches the full
published config.  Weights (random, from ``--seed``), activations and
caches are fp32, as in the JAX launcher; prompts come from numpy with the
same seed.  ``--continuous``
serves through the continuous-batching engine (paged KV cache + slot
scheduler; dense archs only, as in the reference).  The vlm family's
prompts follow ``vision_tokens`` zero embeddings, which the cache length
counts on top of ``--max-len``.  The encdec family's decoder attends to
``src_embeds`` of shape (requests, --max-len, d_model), standard normal
from a ``torch.Generator`` seeded 99 (the reference draws
``jax.random.normal(PRNGKey(99))``).  The xlstm family
(``--arch xlstm-1.3b``) serves from its constant-size state; ``--max-len``
does not bound it.

``--mesh DxM`` serves both engines on a ``DeviceMesh`` of the first D*M
ranks, with the train launcher's process flags: ``--coordinator``
(``host:port`` or an ``init_method`` URL such as ``file:///path``) with
``--num-processes`` and ``--process-id`` joins a ``torch.distributed``
group (NCCL on the card, gloo with ``--device cpu``), one process a
device.  Without ``--coordinator``, ``--mesh`` joins a world of one
through a ``FileStore`` in a temporary directory.  Every process builds
the same weights and prompts from ``--seed``; process 0 prints the
outputs and the others print nothing:

    for i in 0 1 2 3; do PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama2-7b --device cpu --mesh 2x2 \
        --coordinator file:///tmp/store --num-processes 4 --process-id $i &
    done; wait
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import (add_process_flags, init_distributed,
                                     join_from_flags, mesh_from_spec)
from repro_torch.models import get_family
from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine
from repro_torch.serve.scheduler import ServeRequest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced SMOKE config (--no-smoke: published size)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV cache")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch width for --continuous")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged-cache page size for --continuous")
    ap.add_argument("--mesh", default=None,
                    help="serve on a device mesh: DxM (data x model, e.g. "
                         "2x2) or name=size pairs over the first D*M ranks")
    add_process_flags(ap)
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    args = ap.parse_args(argv)

    device = join_from_flags(ap, args, resolve_device(args.device))
    with contextlib.ExitStack() as stack:
        if args.mesh and not args.coordinator:       # a world of one
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
            init_distributed(f"file://{tmp}/store", 1, 0, device=device.type)
        if args.coordinator or args.mesh:
            stack.callback(_leave)
        mesh = mesh_from_spec(args.mesh) if args.mesh else None
        return _serve(args, device, mesh)


def _leave() -> None:
    """Leave the process group this launcher joined, every rank at once."""
    dist.barrier()
    dist.destroy_process_group()


def _serve(args, device, mesh):
    """Build the weights and prompts, serve them, and print the outputs on
    process 0."""
    show = print if not dist.is_initialized() or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = get_family(cfg).init(cfg, gen, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, 16) for _ in range(args.requests)]

    if args.continuous:
        if cfg.family != "dense":
            raise ValueError(f"--continuous serves the dense family, not "
                             f"{cfg.family!r} ({cfg.name})")
        engine = ContinuousServeEngine(cfg, params, slots=args.slots,
                                       block_size=args.block_size,
                                       device=device, mesh=mesh)
        reqs = [ServeRequest(prompt=list(map(int, p)),
                             max_new_tokens=args.max_new) for p in prompts]
        engine.run(reqs)
        outs = [r.out_tokens for r in reqs]
        stats = engine.scheduler.stats
        for i, o in enumerate(outs):
            show(f"request {i}: {o}")
        show(f"served {len(outs)} requests | decode steps {engine.steps} | "
             f"refills {stats.n_refills} | peak active {stats.peak_active}")
        return outs

    engine = ServeEngine(cfg, params,
                         max_len=args.max_len + cfg.vision_tokens,
                         batch=args.requests, device=device, mesh=mesh)
    kw = {}
    if cfg.family == "encdec":
        gen = torch.Generator(device=device).manual_seed(99)
        kw["src_embeds"] = torch.randn(
            (args.requests, args.max_len, cfg.d_model), generator=gen,
            device=device)
    outs = engine.generate(prompts, max_new_tokens=args.max_new, **kw)
    for i, o in enumerate(outs):
        show(f"request {i}: {o}")
    show(f"served {len(outs)} requests x {args.max_new} tokens")
    return outs


if __name__ == "__main__":
    main()
