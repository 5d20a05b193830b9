"""Architecture registry: ``--arch <id>`` resolution for the ported archs.

Mirrors ``repro.configs.registry.get_config``; only the architectures whose
config module has been copied into this package resolve, any other id
raises a clear "not ported yet" error.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

PORTED_IDS = ["llama2_7b", "qwen2_0_5b", "roberta_base", "zamba2_2_7b"]


def normalize(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    """The published config of ``arch_id`` (or its reduced SMOKE twin)."""
    name = normalize(arch_id)
    if name not in PORTED_IDS:
        raise ValueError(f"arch {arch_id!r} is not ported yet; ported: "
                         f"{', '.join(PORTED_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE if smoke else mod.CONFIG
