"""Expert-parallel communication layer (counterpart of the JAX package's
parallel/): Buffer, its strategies and the fused MoE layer, per rank, over
an EPGroup."""

from .buffer import Buffer  # noqa: F401
from .comm import EPGroup  # noqa: F401
from .config import Config  # noqa: F401
from .event import EventOverlap, FuseMode  # noqa: F401
from .layout import get_dispatch_layout  # noqa: F401
from .strategy import (  # noqa: F401
    get_low_latency_strategy,
    get_normal_strategy,
    low_latency_strategy_names,
    normal_strategy_names,
)
