"""Training launcher for a ported ``--arch`` (port of
``repro.launch.train`` for every strategy of the reference: hift,
hift_pipelined, lisa, fpft, fpft_streamed, mezo, lomo, adalomo).

    python -m repro_torch.launch.train --arch llama2-7b --smoke --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \\
        --smoke --steps 8 --device cpu [--ckpt-dir DIR --resume auto]
    ... --strategy hift_pipelined [--pipeline-depth 3]
    ... --strategy lisa --switch-every 2
    ... --strategy fpft_streamed --stream-window 65536 --pipeline-depth 3
    ... --strategy lomo [--grad-clip 0]    # adalomo, mezo likewise
    ... --fpft                             # = --strategy fpft (deprecated)
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --smoke --steps 8 --device cpu [--strategy ...]   # hybrid family
    ... --arch deepseek-moe-16b ...   # moe family (arctic-480b too)
    ... --arch internvl2-26b ...      # vlm family
    ... --arch seamless-m4t-large-v2 ...   # encdec family
    ... --arch xlstm-1.3b ...         # xlstm family
    ... --crosspod-pods 2 [--crosspod-exact]   # the cross-pod reduce
    # one process a device, joined through a FileStore (or host:port):
    ... --device cpu --mesh 2x2 --coordinator file:///tmp/store \
        --num-processes 4 --process-id $i      # i = 0..3, gloo

The reference's flags for the ported surface (``--fpft`` its deprecated
alias for ``--strategy fpft``), plus ``--device`` (default
``cuda``; without a card it raises unless ``--device cpu``).  Weights are
random from ``--seed``; batches come from the synthetic Markov LM with the
same seed; the LR follows the reference's cosine schedule.  Prints the
reference's ``step``/``loss``/``lr`` lines and ``done: final loss``.
With ``--ckpt-dir`` it checkpoints every ``steps // 2`` steps and at the
end; ``--resume auto`` restores the newest complete checkpoint there.
For the vlm family each batch also carries ``vision_embeds``, for the
encdec family ``src_embeds`` (B, --seq, d_model), standard normal from a
``torch.Generator`` seeded by ``--seed`` and the step
(``data.synthetic.VisionStubLM``, ``SourceStubLM``; the reference draws
``jax.random``).

Distributed flags as the reference's: ``--coordinator`` (``host:port``
or an ``init_method`` URL such as ``file:///path``) with
``--num-processes`` and ``--process-id`` joins a ``torch.distributed``
group (NCCL on the card, gloo with ``--device cpu``); ``--mesh DxM`` (or
``name=size`` pairs) shards the steps over a ``DeviceMesh`` of the first
D*M ranks.  One process drives one device, so ``--local-devices`` above
1 is refused.  Every process builds the same weights and batches from
``--seed``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import tree_size
from repro_torch.configs.registry import get_config
from repro_torch.core import (AdaLomoConfig, CrossPodConfig, HiFTConfig,
                              LiSAConfig, LOMOConfig, LRSchedule, MeZOConfig,
                              make_runner, registry)
from repro_torch.data.synthetic import (DataConfig, PrefetchIterator,
                                        SourceStubLM, SyntheticLM,
                                        VisionStubLM)
from repro_torch.launch.mesh import add_process_flags, join_from_flags
from repro_torch.models import get_family
from repro_torch.optim.mixed_precision import get_policy
from repro_torch.train.loop import LoopConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--strategy", default="hift",
                    choices=registry.strategy_ids(),
                    help="fine-tuning strategy (registry-resolved)")
    ap.add_argument("--m", type=int, default=1,
                    help="units per group (hift/lisa)")
    ap.add_argument("--order", default="bottom2up",
                    choices=["bottom2up", "top2down", "random"],
                    help="HiFT group visit order")
    ap.add_argument("--switch-every", type=int, default=5,
                    help="LiSA re-sampling period")
    ap.add_argument("--grad-clip", type=float, default=None,
                    help="lomo/adalomo global-norm clip (0 disables the norm "
                         "sweep; default 1.0 for lomo, 0 for adalomo whose "
                         "per-matrix update-RMS clip already bounds steps)")
    ap.add_argument("--fused-update", dest="fused_update",
                    action="store_true", default=None,
                    help="force the fused update kernels (adamw/sgdm/"
                         "adagrad); default auto: fused for hift/lisa on "
                         "the card")
    ap.add_argument("--no-fused-update", dest="fused_update",
                    action="store_false",
                    help="force the unfused elementwise update")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help=">=2 moves hift/lisa optimizer-bundle host<->device "
                         "transfers to side streams with depth-1 lookahead "
                         "(core.pipeline); hift_pipelined defaults to 2; "
                         "for fpft_streamed it sets the chunk window depth")
    ap.add_argument("--stream-window", type=int, default=None,
                    help="fpft_streamed chunk size in bytes "
                         "(StreamConfig.chunk_bytes); the device-resident "
                         "optimizer window is pipeline-depth chunks")
    ap.add_argument("--mesh", default=None,
                    help="device mesh for sharded steps: DxM (data x model, "
                         "e.g. 2x4) or name=size pairs (data=2,model=4) over "
                         "the first D*M ranks of the process group")
    add_process_flags(ap)
    ap.add_argument("--crosspod-pods", type=int, default=0,
                    help=">=2 splits each batch into that many pod chunks "
                         "and reduces per-pod gradients "
                         "(fpft/fpft_streamed/hift/lisa)")
    ap.add_argument("--crosspod-exact", action="store_true",
                    help="cross-pod reduce WITHOUT int8 EF compression "
                         "(default compresses the wire)")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--policy", default="fp32",
                    choices=["fp32", "mixed", "mixed_hi", "bf16"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fpft", action="store_true",
                    help="deprecated alias for --strategy fpft")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    strategy = "fpft" if args.fpft else args.strategy
    device = join_from_flags(ap, args, resolve_device(args.device))
    if args.coordinator:
        import torch.distributed as dist
        print(f"distributed: process {dist.get_rank()}/"
              f"{dist.get_world_size()}, {dist.get_backend()} backend")
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = get_family(cfg).init(cfg, gen, device=device)
    n = tree_size(params)
    print(f"[{cfg.name}] {n/1e6:.1f}M params, family={cfg.family}")

    mesh = None
    if args.mesh:
        from repro_torch.dist.shardings import sizes
        from repro_torch.launch.mesh import mesh_from_spec
        mesh = mesh_from_spec(args.mesh)
        print(f"mesh {sizes(mesh)} over {mesh.size()} {mesh.device_type} "
              "ranks")

    sched = LRSchedule(base_lr=args.lr, kind="cosine",
                       total_cycles=max(args.steps, 1))
    kw = {"schedule": sched, "policy": get_policy(args.policy),
          "fused_update": args.fused_update, "device": device,
          "pipeline_depth": args.pipeline_depth}
    if mesh is not None:
        kw["mesh"] = mesh
    if args.crosspod_pods and args.crosspod_pods >= 2:
        kw["cross_pod"] = CrossPodConfig(pods=args.crosspod_pods,
                                         compress=not args.crosspod_exact)
    if args.stream_window is not None:
        kw["stream_window"] = args.stream_window
    if strategy in ("hift", "hift_pipelined"):
        kw["hift"] = HiFTConfig(m=args.m, strategy=args.order, seed=args.seed)
    elif strategy == "lisa":
        kw["lisa"] = LiSAConfig(m=args.m, switch_every=args.switch_every,
                                seed=args.seed)
    elif strategy == "mezo":
        kw["mezo"] = MeZOConfig(seed=args.seed)
    elif strategy == "lomo":
        kw["lomo"] = LOMOConfig(
            grad_clip=1.0 if args.grad_clip is None else args.grad_clip)
    elif strategy == "adalomo":
        kw["adalomo"] = AdaLomoConfig(
            grad_clip=0.0 if args.grad_clip is None else args.grad_clip)
    runner = make_runner(cfg, strategy, params=params,
                         optimizer=args.optimizer, seed=args.seed, **kw)
    if strategy in ("hift", "hift_pipelined", "lisa"):
        peak = runner.peak_trainable_params()
        print(f"{strategy} k={runner.k}, peak trainable "
              f"{peak/1e6:.2f}M ({100*peak/n:.2f}%)")

    source = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed), device=device)
    if cfg.vision_tokens > 0:
        source = VisionStubLM(source, cfg.vision_tokens, cfg.d_model)
    elif cfg.family == "encdec":
        source = SourceStubLM(source, cfg.d_model)
    data = PrefetchIterator(source)
    out = train(runner, data, LoopConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 2, 1),
        ckpt_dir=args.ckpt_dir, log_every=max(args.steps // 10, 1),
        resume=args.resume))
    print(f"done: final loss {out['losses'][-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
