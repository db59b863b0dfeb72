"""Buffer — the EP communication facade (counterpart of the JAX package's
parallel/buffer.py).

The JAX Buffer wraps each strategy's per-shard function in a shard_map over
a mesh axis and takes and returns arrays sharded over it. The port's Buffer
is one rank's: it takes this rank's shard (x [T, H], topk_idx [T, K], the
local experts' weights [El, ...]) and returns this rank's results, with an
EPGroup (parallel/comm.py) as the communicator. `Buffer(None, E)` is one
rank, a loopback (bench.py --config moe's EP = 1); the card runs that form.

Strategies come from SKT_DEEP_USE_MODE ("normal,low_latency", default
"default,default") or the constructor. The normal-mode dispatch / combine
wait for the 4-card EP slice (ROADMAP Queue 1) and raise
NotImplementedError; notify_verify and the cost statistics wait with them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import env
from . import fused_moe as _fm
from .comm import EPGroup
from .config import Config
from .event import FuseMode
from .layout import get_dispatch_layout as _layout
from .strategies import low_latency as _ll
from .strategies import pallas_ll as _pll  # noqa: F401  (registers "pallas")
from .strategies.fused_moe_pallas import fused_deep_moe_pallas_shard
from .strategy import get_low_latency_strategy

_LATER = "comes with the 4-card EP slice (ROADMAP Queue 1)"


class Buffer:
    """EP communication of one rank.

    Args:
      group: an EPGroup, a torch.distributed process group, or None (one rank).
      num_experts: total experts, divisible by the rank count.
      num_max_dispatch_tokens_per_rank: the decode path's token bound.
    """

    def __init__(self, group, num_experts: int,
                 num_max_dispatch_tokens_per_rank: int = 128,
                 normal_strategy: Optional[str] = None,
                 low_latency_strategy: Optional[str] = None):
        self.group = group if isinstance(group, EPGroup) else EPGroup(group)
        self.num_ranks = self.group.num_ranks
        assert num_experts % self.num_ranks == 0
        self.num_experts = num_experts
        self.num_local_experts = num_experts // self.num_ranks
        self.num_max_dispatch_tokens_per_rank = num_max_dispatch_tokens_per_rank
        n_name, ll_name = env.deep_use_mode()
        self.normal_strategy_name = normal_strategy or n_name
        self._low_latency = get_low_latency_strategy(low_latency_strategy or ll_name)

    # ------------------------------------------------------------- layout

    def get_dispatch_layout(self, topk_idx):
        """(num_tokens_per_rank [R], num_tokens_per_expert [E],
        is_token_in_rank [T, R]) of this rank's topk_idx."""
        return _layout(topk_idx, self.num_experts, self.num_ranks)

    # ------------------------------------------------------------- config

    @staticmethod
    def get_dispatch_config(num_ranks: int) -> Config:
        return Config.get_dispatch_config(num_ranks)

    @staticmethod
    def get_combine_config(num_ranks: int) -> Config:
        return Config.get_combine_config(num_ranks)

    # ----------------------------------------------- for the 4-card slice

    def dispatch(self, *args, **kwargs):
        raise NotImplementedError(f"the normal-mode dispatch {_LATER}")

    def combine(self, *args, **kwargs):
        raise NotImplementedError(f"the normal-mode combine {_LATER}")

    # --------------------------------------------------------- low latency

    def low_latency_dispatch(self, x, topk_idx, quant_mode: str = "int8", elastic_info=None,
                             cumulative_local_expert_recv_stats=None):
        """Decode-path dispatch. Returns (recv_x [El, R*maxT, H], scales
        [El, R*maxT] or None, packed_recv_count [El], layout_range [R, El],
        handle) and, when cumulative_local_expert_recv_stats ([El] int32) is
        given, that plus packed_recv_count."""
        if env.bf16_dispatch():
            quant_mode = "bf16"
        res = self._low_latency.low_latency_dispatch(
            x, topk_idx, group=self.group, num_experts=self.num_experts,
            num_max_dispatch_tokens_per_rank=self.num_max_dispatch_tokens_per_rank,
            quant_mode=quant_mode, elastic_info=elastic_info,
            shared_expert_rank_num=env.shared_expert_rank_num())
        scales = res.recv_x_scales if quant_mode in _ll._QUANTISED else None
        base = (res.recv_x, scales, res.packed_recv_count, res.layout_range, res.handle)
        if cumulative_local_expert_recv_stats is not None:
            return base + (cumulative_local_expert_recv_stats + res.packed_recv_count,)
        return base

    def low_latency_combine(self, x, topk_idx, topk_weights, handle):
        """Decode-path combine of expert outputs x [El, R*maxT, H]."""
        return self._low_latency.low_latency_combine(x, topk_idx, topk_weights, handle,
                                                     group=self.group)

    def fused_deep_moe(self, x, topk_idx, topk_weights, w13_q, w13_scale, w2_q, w2_scale,
                       capacity_rows: Optional[int] = None, chunk_rounds: int = 1,
                       fuse_mode: FuseMode = FuseMode.FUSED_DEEP_MOE):
        """The fused MoE layer. x [T, H]; the local experts' w13_q [El, H, 2F]
        int8, w13_scale [El, 2F], w2_q [El, F, H] int8, w2_scale [El, H].
        Returns [T, H].

        The "pallas" strategy without capacity_rows runs the single-launch
        kernel (strategies/fused_moe_pallas.py, K11), where chunk_rounds does
        not apply; otherwise the composition of parallel/fused_moe.py.
        fuse_mode=DISPATCH_FFN_COMBINE goes to dispatch_ffn_combine."""
        if fuse_mode == FuseMode.DISPATCH_FFN_COMBINE:
            return self.dispatch_ffn_combine(x, topk_idx, topk_weights, w13_q, w13_scale,
                                             w2_q, w2_scale, capacity_rows=capacity_rows)
        kw = dict(group=self.group, num_experts=self.num_experts,
                  num_max_dispatch_tokens_per_rank=self.num_max_dispatch_tokens_per_rank)
        if self._low_latency.strategy_name == "pallas" and capacity_rows is None:
            return fused_deep_moe_pallas_shard(x, topk_idx, topk_weights, w13_q, w13_scale,
                                               w2_q, w2_scale, **kw)
        return _fm.fused_deep_moe_shard(x, topk_idx, topk_weights, w13_q, w13_scale, w2_q,
                                        w2_scale, strategy=self._low_latency,
                                        capacity_rows=capacity_rows,
                                        chunk_rounds=chunk_rounds, **kw)

    def dispatch_ffn_combine(self, x, topk_idx, topk_weights, w13_q, w13_scale_i64, w2_q,
                             w2_scale_i64, max_output_size: Optional[int] = None,
                             capacity_rows: Optional[int] = None):
        """The DispatchFFNCombine form (fused_moe.py::dispatch_ffn_combine_shard):
        int64 (or int32) bit-pattern scales, not converted here.
        max_output_size: tokens received in dispatch (max_bs * ranks * topk),
        by default from the constructor's bound. Returns (out [T, H],
        expert_token_nums [1, El] int32, this rank's row)."""
        ok = (torch.int64, torch.int32)
        assert w13_scale_i64.dtype in ok and w2_scale_i64.dtype in ok, (
            "DISPATCH_FFN_COMBINE takes int64 bit-pattern scales; use "
            "np.frombuffer(f32.tobytes(), np.int32).astype(np.int64)")
        k = int(topk_idx.shape[-1])
        recv_bound = max_output_size or (
            self.num_max_dispatch_tokens_per_rank * self.num_ranks * k)
        out, nums = _fm.dispatch_ffn_combine_shard(
            x, topk_idx, topk_weights, w13_q, w13_scale_i64, w2_q, w2_scale_i64,
            strategy=self._low_latency, group=self.group, num_experts=self.num_experts,
            num_max_dispatch_tokens_per_rank=recv_bound, capacity_rows=capacity_rows)
        return out, nums[None]
