"""Model-family registry (port of ``repro.models.get_family``).

Ported, each for serving and training: the dense family and the vlm
family (its LM backbone, the same module, as in the reference), the
hybrid family (zamba2), the moe family (deepseek-moe-16b, arctic-480b),
the encdec family (seamless-m4t-large-v2) and the xlstm family
(xlstm-1.3b).  The family-dispatching ``unit_first_depth`` lives in
``models.base``.
"""
import importlib

_FAMILIES = {"dense": "repro_torch.models.transformer",
             "vlm": "repro_torch.models.transformer",
             "moe": "repro_torch.models.moe",
             "hybrid": "repro_torch.models.zamba2",
             "encdec": "repro_torch.models.encdec",
             "xlstm": "repro_torch.models.xlstm"}


def get_family(cfg):
    # imported on use: the kernels' plain versions import models.layers,
    # and the family modules import the kernels
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(_FAMILIES)})")
    return importlib.import_module(_FAMILIES[cfg.family])
