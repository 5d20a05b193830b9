"""HiFT core (port of ``repro.core``): grouping, the delayed LR schedule,
the bundle pipeline and chunk stream (``core.pipeline``), and the
Strategy API for every strategy of the reference (``hift``,
``hift_pipelined``, ``lisa``, ``fpft``, ``fpft_streamed``, ``mezo``,
``lomo``, ``adalomo``), with quantized resident state
(``QuantConfig``), the cross-pod reduce (``CrossPodConfig``) and sharded
steps (``mesh=``)."""
from repro_torch.core.grouping import (Group, group_cut, make_groups,
                                       merge_params, order_groups,
                                       split_params)
from repro_torch.core.registry import (FUSED_OPTIMIZERS, make_runner,
                                       make_strategy, register_strategy,
                                       strategy_ids)
from repro_torch.core.scheduler import LRSchedule
from repro_torch.core.strategy import (AdaLomoConfig, AdaLomoStrategy,
                                       CrossPodConfig, FPFTStrategy,
                                       HiFTConfig,
                                       HiFTStrategy, LiSAConfig, LOMOConfig,
                                       LOMOStrategy, MeZOConfig,
                                       MeZOStrategy, QuantConfig, Runner,
                                       StreamConfig, Strategy, TrainState,
                                       write_back)
