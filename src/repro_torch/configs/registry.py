"""Architecture registry: ``--arch <id>`` resolution for the ported archs.

Mirrors ``repro.configs.registry.get_config``; only the architectures whose
config module has been copied into this package resolve, any other id
raises a clear "not ported yet" error.  The five paper models
(``PAPER_IDS``) are all ported, and every assigned arch (the xlstm
one for serving only).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchConfig

# the paper's own models (Tables 1, 5, 8-12)
PAPER_IDS = ["llama2_7b", "roberta_base", "roberta_large", "gpt2_large",
             "gpt_neo_2_7b"]
PORTED_IDS = PAPER_IDS + ["qwen2_0_5b", "zamba2_2_7b", "deepseek_7b",
                          "internlm2_1_8b", "smollm_360m", "internvl2_26b",
                          "deepseek_moe_16b", "arctic_480b",
                          "seamless_m4t_large_v2", "xlstm_1_3b"]


def normalize(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, smoke: bool = False,
               optimized: bool = False) -> ArchConfig:
    """The published config of ``arch_id`` (or its reduced SMOKE twin).

    ``optimized=True`` applies the reference's beyond-paper settings at
    full size only (a no-op with ``smoke=True``): the balanced causal
    attention schedule everywhere, and for deepseek-7b gradient
    accumulation in place of layer remat."""
    name = normalize(arch_id)
    if name not in PORTED_IDS:
        raise ValueError(f"arch {arch_id!r} is not ported yet; ported: "
                         f"{', '.join(PORTED_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if optimized and not smoke:
        cfg = dataclasses.replace(cfg, attention_balanced=True)
        if name == "deepseek_7b":
            cfg = dataclasses.replace(cfg, remat="none", grad_accum=4)
    return cfg
