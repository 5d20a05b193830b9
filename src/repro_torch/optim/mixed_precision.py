"""Mixed-precision policies (port of ``repro.optim.mixed_precision``).

``Policy`` sets three dtypes (params / compute / output).  Two HiFT
variants from the paper:

- ``mixed``    : bf16 compute, fp32 master weights for ALL params resident;
- ``mixed_hi`` : bf16 params resident, an fp32 master copy only for the
                 active HiFT group, riding in its optimizer bundle (the
                 paper's "adapted mixed precision", the Mixed^Hi rows).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str = "fp32"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    master_fp32: bool = False          # keep fp32 master weights
    master_active_group_only: bool = False  # Mixed^Hi


FP32 = Policy("fp32")
MIXED = Policy("mixed", param_dtype=torch.bfloat16,
               compute_dtype=torch.bfloat16, output_dtype=torch.float32,
               master_fp32=True)
MIXED_HI = Policy("mixed_hi", param_dtype=torch.bfloat16,
                  compute_dtype=torch.bfloat16, output_dtype=torch.float32,
                  master_fp32=True, master_active_group_only=True)
BF16 = Policy("bf16", param_dtype=torch.bfloat16,
              compute_dtype=torch.bfloat16, output_dtype=torch.float32)

POLICIES = {p.name: p for p in (FP32, MIXED, MIXED_HI, BF16)}


def get_policy(name: str) -> Policy:
    return POLICIES[name]
