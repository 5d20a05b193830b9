#!/usr/bin/env python3
"""Check that two checkouts' attention kernels give the same bits on the
cases both can run: the prefill and both decodes at every case of
NEW_DIR's ``chip_smoke.kernel_cases``, ``hybrid_attention_cases``,
``vlm_attention_cases`` and ``encdec_attention_cases`` whose keys are the
queries' own (a cross-attention case, over another key length, runs on
NEW_DIR only and is left out).

    python3 tools/attention_bitwise.py OLD_DIR NEW_DIR > bitwise.jsonl

Each checkout runs in a fresh process that builds its own kernels, draws
each case's inputs on the card from one seed (NEW_DIR's
``chip_smoke.make_inputs``, so both get the same arguments) and prints
the SHA-256 of each output's bytes; the last line says which cases
differ.  Exits non-zero if any does, or if no card is present.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

TURN = """
import hashlib, json, sys
sys.path.insert(0, sys.argv[2])
import chip_smoke as C              # NEW_DIR's: the cases' inputs
sys.path.insert(0, "src")           # this checkout's kernels
import torch
if not torch.cuda.is_available():
    sys.exit("attention_bitwise: no CUDA device")
from repro_torch.kernels import flash_attention as K
wrappers = {"flash_attention": K.flash_attention,
            "flash_decode": K.flash_decode,
            "paged_flash_decode": K.paged_flash_decode}
for kernel, case, dtype, sh in json.loads(sys.argv[1]):
    gen = torch.Generator(device="cuda").manual_seed(1234)
    args = C.make_inputs(torch, kernel, getattr(torch, dtype), sh, gen)
    out = wrappers[kernel](*args)
    torch.cuda.synchronize()
    data = out.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    print(json.dumps({"case": case, "kernel": kernel, "dtype": dtype,
                      "sha256": hashlib.sha256(data).hexdigest()}),
          flush=True)
"""
CASES = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as C
cases = (C.kernel_cases(torch) + C.hybrid_attention_cases()
         + C.vlm_attention_cases() + C.encdec_attention_cases())
print(json.dumps([c for c in cases if c[3].get("sk", c[3].get("s"))
                  == c[3].get("s")]))
"""


def run(cwd: Path, code: str, *args: str) -> str:
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=cwd,
                         capture_output=True, text=True, timeout=1200)
    if out.returncode != 0:
        sys.exit(f"{cwd}: {out.stderr[-2000:]}")
    return out.stdout


def main() -> int:
    old, new = (Path(p).resolve() for p in sys.argv[1:3])
    cases = run(new, CASES).strip().splitlines()[-1]
    hashes = {}
    for tag, root in (("old", old), ("new", new)):
        lines = [json.loads(x) for x in
                 run(root, TURN, cases, str(new)).splitlines()
                 if x.startswith("{")]
        for line in lines:
            print(json.dumps({"checkout": tag, **line}), flush=True)
        hashes[tag] = {x["case"]: x["sha256"] for x in lines}
    differ = [c for c in hashes["new"] if hashes["old"].get(c) !=
              hashes["new"][c]]
    print(json.dumps({"cases": len(hashes["new"]), "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
