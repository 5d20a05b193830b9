"""HiFT core (port of ``repro.core``): grouping, the delayed LR schedule
and the Strategy API for the ``hift`` and ``fpft`` strategies, with
quantized resident state (``QuantConfig``)."""
from repro_torch.core.grouping import (Group, group_cut, make_groups,
                                       merge_params, order_groups,
                                       split_params)
from repro_torch.core.registry import (FUSED_OPTIMIZERS, make_runner,
                                       make_strategy, register_strategy,
                                       strategy_ids)
from repro_torch.core.scheduler import LRSchedule
from repro_torch.core.strategy import (FPFTStrategy, HiFTConfig,
                                       HiFTStrategy, QuantConfig, Runner,
                                       Strategy, TrainState, write_back)
