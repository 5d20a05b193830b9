"""Model-family registry (port of ``repro.models.get_family``).

The dense family (serving and training) and the hybrid family (zamba2:
serving and training) are ported; every other family raises.  (The vlm
family reuses the dense module in JAX but needs ``vision_tokens`` on the
serving path, which is not ported yet.)  The family-dispatching
``unit_first_depth`` lives in ``models.base``.
"""
import importlib

_FAMILIES = {"dense": "repro_torch.models.transformer",
             "hybrid": "repro_torch.models.zamba2"}


def get_family(cfg):
    # imported on use: the kernels' plain versions import models.layers,
    # and the family modules import the kernels
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(_FAMILIES)})")
    return importlib.import_module(_FAMILIES[cfg.family])
