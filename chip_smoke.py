#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the repository root; needs a card

Phases, one JSON line each:

0. the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
2. each kernel against its plain PyTorch version at the serving shapes
   (llama2-7b width in bf16, qwen2-0.5b's GQA widths, one fp32 case), with
   its time, the plain version's, the library call's where one PyTorch
   call computes the same function, and the bound of the work;
3. card against CPU at fp32: a 2-layer model at llama2-7b width, both
   engines, the same greedy tokens on both devices;
4. the slice at full size: llama2-7b (32 layers, bf16, random weights from
   a seed) served by ``ContinuousServeEngine`` and then ``ServeEngine``,
   with every kernel's launches counted over that run.

Then the ``nvidia-smi`` line, the kernels line and, last, the result line.
Any failure raises: the script exits non-zero and prints no result.  It
imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 2e-5}             # atol = rtol
L2_BYTES = 50 * 2**20
KERNEL_ROWS = {
    "flash_attention": "src/repro/kernels/flash_attention.py:63",
    "flash_decode": "src/repro/kernels/flash_attention.py:141",
    "paged_flash_decode": "src/repro/kernels/flash_attention.py:230",
}
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


# ------------------------------------------------------------ measurement

def time_ms(torch, fn, arg_sets, reps: int = 10, launches: int = 30):
    """Device time of one call: median over ``reps`` of the mean time of
    ~``launches`` calls, by CUDA events.  The calls cycle over
    ``arg_sets``, whose inputs together exceed the L2 cache, so each call
    reads its inputs from HBM as a layer of the model does.  A sleep kernel
    holds the stream while the host enqueues the calls, so they run back to
    back and the host's launch overhead stays out of the number."""
    rounds = max(1, launches // len(arg_sets))

    def run():
        for _ in range(rounds):
            for args in arg_sets:
                fn(*args)

    run()                                               # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * host_s * 2e9))        # >= 2x the enqueue
        e0.record()
        run()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / (rounds * len(arg_sets)))
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def copies(nbytes: int) -> int:
    return max(2, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


# ------------------------------------------------------------ phase 2

def kernel_cases(torch):
    """(kernel, case name, dtype, shapes) at the slice's shapes."""
    llama = dict(h=32, kvh=32, hd=128)
    qwen = dict(h=14, kvh=2, hd=64)
    starts4 = [0, 37, 100, 5]
    lengths4 = [544, 520, 300, 33]
    return [
        ("flash_attention", "llama2-7b continuous prefill", "bfloat16",
         dict(b=1, s=512, starts=[37], **llama)),
        ("flash_attention", "llama2-7b batched prefill (ragged)", "bfloat16",
         dict(b=4, s=301, starts=[0, 50, 120, 300], **llama)),
        ("flash_attention", "qwen2-0.5b GQA prefill", "bfloat16",
         dict(b=1, s=512, starts=[37], **qwen)),
        ("flash_attention", "llama2-7b prefill fp32", "float32",
         dict(b=1, s=256, starts=[11], **llama)),
        ("flash_decode", "llama2-7b decode", "bfloat16",
         dict(b=4, s=544, starts=starts4, lengths=lengths4, **llama)),
        ("flash_decode", "qwen2-0.5b GQA decode", "bfloat16",
         dict(b=4, s=544, starts=starts4, lengths=lengths4, **qwen)),
        ("flash_decode", "llama2-7b decode fp32", "float32",
         dict(b=4, s=544, starts=starts4, lengths=lengths4, **llama)),
        ("paged_flash_decode", "llama2-7b paged decode", "bfloat16",
         dict(b=4, bs=16, max_blocks=34, starts=starts4, lengths=lengths4,
              **llama)),
        ("paged_flash_decode", "qwen2-0.5b GQA paged decode", "bfloat16",
         dict(b=4, bs=16, max_blocks=34, starts=starts4, lengths=lengths4,
              **qwen)),
        ("paged_flash_decode", "llama2-7b paged decode fp32", "float32",
         dict(b=4, bs=16, max_blocks=34, starts=starts4, lengths=lengths4,
              **llama)),
    ]


def make_inputs(torch, kernel, dt, sh, gen):
    """One set of inputs (a tuple of the kernel's arguments) and the rows
    of its output that are defined (pad rows of prefill are not)."""
    dev = "cuda"
    b, h, kvh, hd = sh["b"], sh["h"], sh["kvh"], sh["hd"]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def idx(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    if kernel == "flash_attention":
        s = sh["s"]
        return (rnd(b, s, h, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd),
                idx(sh["starts"]))
    q = rnd(b, h, hd)
    if kernel == "flash_decode":
        s = sh["s"]
        return (q, rnd(b, s, kvh, hd), rnd(b, s, kvh, hd),
                idx(sh["lengths"]), idx(sh["starts"]))
    n_blocks = 1 + b * sh["max_blocks"]
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    tables = perm.reshape(b, sh["max_blocks"]).to(torch.int32)
    return (q, rnd(n_blocks, sh["bs"], kvh, hd),
            rnd(n_blocks, sh["bs"], kvh, hd), tables, idx(sh["lengths"]),
            idx(sh["starts"]))


def work(kernel, dtype, sh):
    """(FLOPs, bytes) this call's data needs: 4*hd operations per visible
    (query, key) pair (QK^T and PV), each needed input row read once, each
    output written once."""
    e = 2 if dtype == "bfloat16" else 4
    h, kvh, hd = sh["h"], sh["kvh"], sh["hd"]
    if kernel == "flash_attention":
        s = sh["s"]
        valid = [s - st for st in sh["starts"]]
        pairs = sum(n * (n + 1) // 2 for n in valid)
        nbytes = sum(valid) * (h + 2 * kvh) * hd * e       # q, k, v rows
        nbytes += sh["b"] * s * h * hd * e + 4 * sh["b"]    # out, starts
        return 4 * hd * h * pairs, nbytes
    window = [ln - st for st, ln in zip(sh["starts"], sh["lengths"])]
    nbytes = 2 * sh["b"] * h * hd * e + 8 * sh["b"]         # q, out, idx
    nbytes += sum(window) * 2 * kvh * hd * e                # k, v rows
    if kernel == "paged_flash_decode":
        bs = sh["bs"]
        pages = sum((ln - 1) // bs - st // bs + 1
                    for st, ln in zip(sh["starts"], sh["lengths"]))
        nbytes += 4 * pages                                 # table entries
    return 4 * hd * h * sum(window), nbytes


def library_call(torch, kernel, args, h, kvh):
    """One PyTorch call computing the same function (the yardstick), or
    None.  Masks and views are built here, outside the timed call."""
    import torch.nn.functional as F
    if kernel == "paged_flash_decode":
        return None
    gqa = {}
    if h != kvh:
        major, minor = (int(x) for x in torch.__version__.split(".")[:2])
        if (major, minor) < (2, 5):
            return None
        gqa = {"enable_gqa": True}
    if kernel == "flash_attention":
        q, k, v, starts = args
        s = q.shape[1]
        pos = torch.arange(s, device=q.device)
        mask = (pos[None, :, None] >= pos[None, None, :]) & \
            (pos[None, None, :] >= starts.long()[:, None, None])
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = mask[:, None]
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask, **gqa)
    q, k, v, lengths, starts = args
    pos = torch.arange(k.shape[1], device=q.device)
    mask = (pos[None, :] >= starts.long()[:, None]) & \
        (pos[None, :] < lengths.long()[:, None])
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = mask[:, None, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask, **gqa)


def phase_kernels(torch):
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref
    wrappers = {"flash_attention": K.flash_attention,
                "flash_decode": K.flash_decode,
                "paged_flash_decode": K.paged_flash_decode}
    plains = {"flash_attention": ref.flash_attention_ref,
              "flash_decode": ref.flash_decode_ref,
              "paged_flash_decode": ref.paged_flash_decode_ref}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for kernel, case, dtype, sh in kernel_cases(torch):
        dt = getattr(torch, dtype)
        args = make_inputs(torch, kernel, dt, sh, gen)
        got = wrappers[kernel](*args)
        want = plains[kernel](*args)
        torch.cuda.synchronize()
        if kernel == "flash_attention":       # pad rows are undefined
            keep = torch.arange(sh["s"], device="cuda")[None, :] >= \
                args[3].long()[:, None]
            got, want = got[keep], want[keep]
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{kernel} ({case}): non-finite output")
        err = (got - want).abs()
        tol = TOL[dtype]
        max_err = float(err.max())
        if bool((err > tol + tol * want.abs()).any()):
            raise RuntimeError(f"{kernel} ({case}): max |err| {max_err} "
                               f"over tolerance {tol}")
        nbytes = sum(a.numel() * a.element_size() for a in args)
        sets = [args] + [make_inputs(torch, kernel, dt, sh, gen)
                         for _ in range(copies(nbytes) - 1)]
        ms = time_ms(torch, wrappers[kernel], sets)
        plain_ms = time_ms(torch, plains[kernel], sets)
        lib = [library_call(torch, kernel, a, sh["h"], sh["kvh"])
               for a in sets]
        library_ms = None if lib[0] is None else time_ms(
            torch, lambda f: f(), [(f,) for f in lib])
        flops, wbytes = work(kernel, dtype, sh)
        bound_ms, bound_by = bound(flops, wbytes, dtype)
        row = dict(kernel=kernel, case=case, dtype=dtype, shapes=sh,
                   max_abs_err=max_err, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, flops=flops, bytes=wbytes,
                   share_of_bound=bound_ms / ms)
        emit("kernel", **row)
        results.setdefault(kernel, row)      # the first case is the main one
        del sets, lib, args
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ phases 3, 4

def serve_both(torch, cfg, params, prompts, max_new, dtype, device,
               slots, prefill_bucket, max_blocks=None):
    """Greedy tokens from both engines, with host-clock timings."""
    from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine
    from repro_torch.serve.scheduler import ServeRequest
    ceng = ContinuousServeEngine(cfg, params, slots=slots, block_size=16,
                                 prefill_bucket=prefill_bucket,
                                 max_blocks_per_slot=max_blocks,
                                 compute_dtype=dtype, device=device)
    reqs = [ServeRequest(prompt=list(map(int, p)), max_new_tokens=max_new)
            for p in prompts]
    t0 = time.perf_counter()
    ceng.run(reqs)
    if device == "cuda":
        torch.cuda.synchronize()
    t_cont = time.perf_counter() - t0
    cont = [r.out_tokens for r in reqs]
    batch = min(slots, len(prompts))
    max_len = max(len(p) for p in prompts) + max_new
    eng = ServeEngine(cfg, params, max_len=max_len, batch=batch,
                      compute_dtype=dtype, device=device)
    t0 = time.perf_counter()
    fixed = []
    for i in range(0, len(prompts), batch):
        fixed += eng.generate(prompts[i:i + batch], max_new_tokens=max_new)
    t_fixed = time.perf_counter() - t0
    return ceng, cont, fixed, t_cont, t_fixed


def phase_card_vs_cpu(torch):
    """Same fp32 weights on CPU (plain versions) and card (kernels)."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=2)
    params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu",
                    dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (64, 37, 20)]
    out = {}
    for dev in ("cpu", "cuda"):
        _, cont, fixed, _, _ = serve_both(torch, cfg, params, prompts, 8,
                                          torch.float32, dev, slots=2,
                                          prefill_bucket=64)
        out[dev] = (cont, fixed)
    # logits of one prefill and one decode step on both devices
    toks = torch.from_numpy(np.stack([np.pad(p, (64 - len(p), 0))
                                      for p in prompts])).long()
    pad = torch.tensor([64 - len(p) for p in prompts], dtype=torch.int32)
    gaps = []
    logits = {}
    for dev in ("cpu", "cuda"):
        p_dev = tree_map(lambda t: t.to(dev), params)
        cache = T.init_cache(cfg, 3, 72, dtype=torch.float32, device=dev)
        lg, cache = T.prefill(cfg, p_dev, {"tokens": toks.to(dev),
                                           "pad": pad.to(dev)}, cache,
                              torch.float32)
        nxt = lg[:, -1].argmax(-1, keepdim=True)
        lg2, _ = T.decode_step(cfg, p_dev, cache, nxt, torch.float32)
        logits[dev] = (lg.cpu(), lg2.cpu())
    for a, b in zip(logits["cpu"], logits["cuda"]):
        gaps.append(float((a - b).abs().max()))
    same = out["cpu"] == out["cuda"]
    emit("card_vs_cpu", n_layers=cfg.n_layers, d_model=cfg.d_model,
         prompts=[len(p) for p in prompts], new_tokens=8,
         tokens_equal=same, max_logit_gap=max(gaps),
         cpu_continuous=out["cpu"][0], cuda_continuous=out["cuda"][0])
    if not same:
        raise RuntimeError(f"card and CPU greedy tokens differ: {out}")
    if out["cuda"][0] != out["cuda"][1]:
        raise RuntimeError("continuous and fixed-batch tokens differ at fp32")


def phase_full(torch):
    """llama2-7b at full width and depth, bf16, both engines."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as K
    from repro_torch.models import transformer as T
    cfg = get_config("llama2-7b")
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda", dtype=bf16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    plens = [int(n) for n in rng.integers(32, 513, 8)]
    prompts = [rng.integers(0, cfg.vocab, n) for n in plens]
    max_new = 32
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()                   # count the main path's run only
    ceng, cont, fixed, t_cont, t_fixed = serve_both(
        torch, cfg, params, prompts, max_new, bf16, "cuda", slots=4,
        prefill_bucket=32, max_blocks=-(-(512 + max_new) // 16))
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    for toks in cont + fixed:
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_padded
                                           for t in toks):
            raise RuntimeError(f"bad generation {toks}")
    n_tok = len(prompts) * max_new
    agree = sum(a == b for a, b in zip(cont, fixed))
    prefix = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   len(a)) for a, b in zip(cont, fixed)]
    emit("full_size", arch=cfg.name, n_layers=cfg.n_layers, dtype="bfloat16",
         init_s=init_s, prompt_lens=plens, new_tokens=max_new,
         continuous=dict(slots=4, block_size=16, wall_s=t_cont,
                         tokens_per_s=n_tok / t_cont, steps=ceng.steps,
                         prefill_ms=[1e3 * s for s in ceng.prefill_seconds],
                         decode_step_ms_median=1e3 * statistics.median(
                             ceng.decode_seconds),
                         refills=ceng.scheduler.stats.n_refills),
         fixed_batch=dict(batch=4, wall_s=t_fixed,
                          tokens_per_s=n_tok / t_fixed),
         peak_memory_bytes=peak, launches=launches,
         engines_agree=f"{agree}/{len(prompts)} requests",
         agreeing_prefix_tokens=prefix)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    phase_profile(torch, cfg, params, prompts[:4])
    return launches


def phase_profile(torch, cfg, params, prompts, steps: int = 8):
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    contiguous decode steps of llama2-7b (batch 4, bf16) after one prefill.
    Reports the device's busy time per step (sum of kernel times), the
    host clock per step under the profiler, and the kernels that take the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    bf16 = torch.bfloat16
    plen = max(len(p) for p in prompts)
    toks = torch.tensor(np.stack([np.pad(p, (plen - len(p), 0))
                                  for p in prompts]), device="cuda")
    pad = torch.tensor([plen - len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    cache = T.init_cache(cfg, len(prompts), plen + 2 * steps, dtype=bf16,
                         device="cuda")
    logits, cache = T.prefill(cfg, params, {"tokens": toks, "pad": pad},
                              cache, bf16)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    for _ in range(2):                                  # warm up
        logits, cache = T.decode_step(cfg, params, cache, tok, bf16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = T.decode_step(cfg, params, cache, tok, bf16)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = [getattr(e, "self_device_time_total", 0.0) for e in kernels]
    busy_ms = sum(dev_us) / 1e3 / steps
    top = sorted(zip(dev_us, kernels), key=lambda t: -t[0])[:8]
    emit("decode_profile", steps=steps, batch=len(prompts),
         host_ms_per_step=1e3 * host_s / steps,
         device_busy_ms_per_step=busy_ms,
         device_idle_share=1 - busy_ms / (1e3 * host_s / steps),
         top_kernels=[dict(name=e.key[:80], ms_per_step=us / 1e3 / steps,
                           calls_per_step=e.count / steps)
                      for us, e in top])


# ------------------------------------------------------------ main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    libs = build.build_all()
    ptxas = [ln.strip() for log in build.last_build.get("logs", {}).values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()],
         ptxas=ptxas)

    rows = phase_kernels(torch)
    phase_card_vs_cpu(torch)
    launches = phase_full(torch)

    kernels = []
    for name, row in rows.items():
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE,
            replaces=KERNEL_ROWS[name], launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            case=row["case"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
