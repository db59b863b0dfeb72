"""EP communication strategy ABCs + registries (counterpart of the JAX
package's parallel/strategy.py): abstract normal and low-latency strategies
with name registries and decorator-based registration, selected through
SKT_DEEP_USE_MODE ("normal_name,low_latency_name").

Strategy methods are per-rank functions: they take this rank's shard and an
`EPGroup` (parallel/comm.py) where the JAX package takes a mesh axis name.
"""

from __future__ import annotations

import abc
from typing import Dict, Type

_NORMAL_REGISTRY: Dict[str, Type["NormalEPCommStrategy"]] = {}
_LOW_LATENCY_REGISTRY: Dict[str, Type["LowLatencyEPCommStrategy"]] = {}


def register_normal_strategy(name: str):
    def deco(cls):
        _NORMAL_REGISTRY[name] = cls
        cls.strategy_name = name
        return cls

    return deco


def register_low_latency_strategy(name: str):
    def deco(cls):
        _LOW_LATENCY_REGISTRY[name] = cls
        cls.strategy_name = name
        return cls

    return deco


def get_normal_strategy(name: str) -> "NormalEPCommStrategy":
    return _NORMAL_REGISTRY[name]()


def get_low_latency_strategy(name: str) -> "LowLatencyEPCommStrategy":
    return _LOW_LATENCY_REGISTRY[name]()


def normal_strategy_names():
    return sorted(_NORMAL_REGISTRY)


def low_latency_strategy_names():
    return sorted(_LOW_LATENCY_REGISTRY)


class NormalEPCommStrategy(abc.ABC):
    """Prefill/training-path EP comm."""

    strategy_name = "?"

    @abc.abstractmethod
    def dispatch(self, x, topk_idx, topk_weights, *, group, num_experts,
                 quant_mode="bf16", capacity_factor=2.0, config=None):
        """-> a dispatch result."""

    @abc.abstractmethod
    def combine(self, x, handle, topk_weights, *, group, config=None):
        """-> (combined_x [T,H], combined_topk_weights [T,K])."""


class LowLatencyEPCommStrategy(abc.ABC):
    """Decode-path EP comm."""

    strategy_name = "?"

    @abc.abstractmethod
    def low_latency_dispatch(self, x, topk_idx, *, group, num_experts,
                             num_max_dispatch_tokens_per_rank,
                             quant_mode="bf16"):
        """-> LowLatencyDispatchResult (see strategies.low_latency)."""

    @abc.abstractmethod
    def low_latency_combine(self, x, topk_idx, topk_weights, handle, *, group):
        """-> combined_x [T, H]."""
