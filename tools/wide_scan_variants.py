#!/usr/bin/env python3
"""Where the wide scan's walk spends its time, on one CUDA card.

    python3 tools/wide_scan_variants.py > wide_variants.jsonl

Builds ``csrc/ssm_scan_wide.cu`` as it stands and five variants of it,
each with one part of the walk switched off by a text patch (their
results are wrong; only their time means anything), then times each at
xlstm-1.3b's prefill, 16 x 512 at (P, N) = (1025, 1024), fp32 and bf16,
as ``chip_smoke.phase_wide_ssm_kernel`` times the kernel (CUDA events,
inputs beyond L2; the scores kernel's and the walk's ms apart from
``torch.profiler``):

- ``no_p1``: the walk's C h^T (step i) not computed;
- ``no_p2``: the state update's products (step iii) not computed;
- ``no_y``: G x (step ii) not computed;
- ``ring_only``: none of the three: the ring of C and B tiles, its
  barriers, x and the update's operand alone;
- ``no_copy``: the producer copies nothing (it still signals each tile
  as landed), so the walk computes on whatever the ring holds: the
  compute and the barriers without the traffic from L2.

A patch that no longer matches the source stops the tool: update its
anchor with the kernel.  Prints the card's name and power limit first,
then one JSON line a variant and dtype.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/wide_variants"

P1 = "      if (ci > 0) {                               // the state is 0 "
P2 = "      for (int ks = 0; ks < kLc / 8; ++ks) {"
Y = "      for (int j4 = 0; j4 <= i; j4 += 4) {"
COPY = "cp_async16(dst"
PATCHES = {                    # (old, new, how many times old occurs)
    "no_p1": [(P1, "      if (false) {", 1)],
    "no_p2": [(P2, P2.replace("ks < kLc / 8", "ks < 0"), 1)],
    "no_y": [(Y, Y.replace("j4 <= i", "j4 < 0"), 1)],
    "no_copy": [(COPY, "if (false) cp_async16(dst", 1)],
}
PATCHES["ring_only"] = PATCHES["no_p1"] + PATCHES["no_p2"] + PATCHES["no_y"]
B, S = 16, 512


def sources() -> dict:
    src = (CSRC / "ssm_scan_wide.cu").read_text()
    out = {"kernel": src}
    for name, pats in PATCHES.items():
        text = src
        for old, new, count in pats:
            if text.count(old) != count:
                raise SystemExit(f"wide_scan_variants: patch {name} does "
                                 f"not match the source: {old.strip()!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(texts: dict) -> dict:
    """One nvcc a variant, all at once; name -> its C entry point."""
    from repro_torch.kernels import build as B_
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = B_.find_nvcc()
    procs = {}
    for name, text in texts.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *B_.NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(OUT / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"wide_scan_variants: {name} failed to build:\n"
                             f"{log[-2000:]}")
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).ssm_scan_wide_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    import chip_smoke as C
    from repro_torch.kernels import ssm_scan as K
    if not torch.cuda.is_available():
        print("wide_scan_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi.splitlines()[0]}), flush=True)
    fns = build(sources())
    p, n = K.WIDE
    for dtype in ("float32", "bfloat16"):
        gen = torch.Generator(device="cuda").manual_seed(3)
        sets = []
        for _ in range(2):                     # beyond L2 together
            x, a, b, c = C.ssm_inputs(torch, getattr(torch, dtype), B, S, 1,
                                      "mlstm", gen, p=p, n=n)
            sets.append((x, a, b, c, torch.empty_like(x),
                         torch.empty((B, 1, p, n), device="cuda"),
                         torch.empty(K.wide_work_floats(B, S, 1),
                                     device="cuda")))
        want, _ = C.ssm_plain(*sets[0][:4])
        stream = torch.cuda.current_stream().cuda_stream
        code = 0 if dtype == "float32" else 1
        for name, fn in fns.items():
            def call(x, a, b, c, y, hf, work, fn=fn):
                err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                         c.data_ptr(), y.data_ptr(), hf.data_ptr(),
                         work.data_ptr(), B, S, 1, p, n, code, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")
            call(*sets[0])
            torch.cuda.synchronize()
            err = float((sets[0][4].float() - want.float()).abs().max())
            ms = C.time_ms(torch, call, sets, reps=5, launches=10)
            print(json.dumps({"variant": name, "dtype": dtype, "ms": ms,
                              **C.wide_split_ms(torch, call, sets),
                              "max_abs_err_y": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
