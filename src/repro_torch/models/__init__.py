"""Model-family registry (port of ``repro.models.get_family``).

Only the dense family is ported so far; every other family raises.  (The
vlm family reuses the dense module in JAX but needs ``vision_tokens`` on
the serving path, which is not ported yet.)
"""
import importlib

_FAMILIES = {"dense": "repro_torch.models.transformer"}


def get_family(cfg):
    # imported on use: the kernels' plain versions import models.layers,
    # and the family modules import the kernels
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (dense only)")
    return importlib.import_module(_FAMILIES[cfg.family])
