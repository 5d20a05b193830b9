#!/usr/bin/env python3
"""Time the attention and SSM scan kernels of two checkouts of this
repository on one CUDA card, in turns: A, B, B, A.

    python3 tools/attention_ab.py [--wide] OLD_DIR NEW_DIR > ab.jsonl

Each turn starts a fresh process inside one checkout, which builds that
checkout's kernels and runs its own ``chip_smoke.phase_kernels``, case by
case, over NEW_DIR's attention cases (``kernel_cases`` and
``hybrid_attention_cases``), then its own ``chip_smoke.phase_ssm_kernel``
over NEW_DIR's ``SSM_CASES`` and this tool's ``SSM_EXTRA``, case by case
(the checkout's ``SSM_CASES`` set to each case in turn), then its own
``chip_smoke.phase_wide_ssm_kernel`` over NEW_DIR's ``WIDE_SSM_CASES``
likewise: each kernel against its plain version, with its time, the plain
version's, the library call's and the bound.  For each wide case the turn
also profiles 5 calls (``torch.profiler``) and prints the scores
kernel's and the walk's device ms a launch apart (a ``wide_split`` line,
each over the launches the profiler caught), whatever the checkout's own
phase prints.  ``--wide`` runs the wide cases alone.
Every kernel line is printed tagged with its checkout and turn, after the
card's name and power limit; a case that a checkout's kernel fails (an
older kernel's empty window, say) is printed as such and skipped.  Two
calls may land on two cards, so compare only within one run.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CASES = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as C
print(json.dumps({"attention": C.kernel_cases(torch)
                  + C.hybrid_attention_cases(), "ssm": C.SSM_CASES,
                  "wide": C.WIDE_SSM_CASES}))
"""
# scan cases timed here beside chip_smoke.py's: two prompts in bf16, a
# batch between the one prompt and the four of SSM_CASES
SSM_EXTRA = [("two prompts 2 x 512 bf16", "bfloat16", 2, 512, 80, "slow")]
TURN = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as C
if not torch.cuda.is_available():
    sys.exit("attention_ab: no CUDA device")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cases = json.loads(sys.argv[1])
for case in cases["attention"]:
    try:
        C.phase_kernels(torch, [tuple(case)])
    except RuntimeError as e:
        print(json.dumps({"phase": "kernel_failed", "case": case[1],
                          "error": str(e)[:300]}), flush=True)
for case in cases["ssm"]:
    C.SSM_CASES = [tuple(case)]
    try:
        C.phase_ssm_kernel(torch)
    except RuntimeError as e:
        print(json.dumps({"phase": "kernel_failed", "case": case[0],
                          "error": str(e)[:300]}), flush=True)
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import ssm_scan as S
for case in cases["wide"]:
    C.WIDE_SSM_CASES = [tuple(case)]
    try:
        C.phase_wide_ssm_kernel(torch)
    except RuntimeError as e:
        print(json.dumps({"phase": "kernel_failed", "case": case[0],
                          "error": str(e)[:300]}), flush=True)
        continue
    name, dtype, b, s, decay = case
    gen = torch.Generator(device="cuda").manual_seed(7)
    args = C.ssm_inputs(torch, getattr(torch, dtype), b, s, 1, decay, gen,
                        p=S.WIDE[0], n=S.WIDE[1])
    S.ssm_scan(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            S.ssm_scan(*args)
        torch.cuda.synchronize()
    split = {}
    for k in ("ssm_wide_scores", "ssm_wide_walk"):
        evs = [e for e in prof.key_averages() if k in e.key
               and e.self_device_time_total > 0]
        n = sum(e.count for e in evs)
        split[k + "_ms"] = (sum(e.self_device_time_total for e in evs)
                            / 1e3 / n if n else None)
    print(json.dumps({"phase": "wide_split", "case": name, **split}),
          flush=True)
"""


def main(argv: list[str]) -> int:
    wide_only = argv[:1] == ["--wide"]
    argv = argv[wide_only:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"A": Path(argv[0]).resolve(), "B": Path(argv[1]).resolve()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"nvidia_smi": smi.splitlines()[0],
                      "A": str(dirs["A"]), "B": str(dirs["B"])}), flush=True)
    cases = json.loads(subprocess.run(
        [sys.executable, "-c", CASES], cwd=dirs["B"], capture_output=True,
        text=True, check=True, timeout=300).stdout)
    cases["ssm"] += SSM_EXTRA
    if wide_only:
        cases.update(attention=[], ssm=[])
    cases = json.dumps(cases)
    for turn, tag in enumerate("ABBA"):
        run = subprocess.run([sys.executable, "-c", TURN, cases],
                             cwd=dirs[tag], capture_output=True, text=True,
                             timeout=1200)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        for line in run.stdout.splitlines():
            if line.startswith(('{"phase": "kernel',
                                '{"phase": "wide_split')):
                print(json.dumps({"checkout": tag, "turn": turn,
                                  **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
