"""Buffer — the EP communication facade (counterpart of the JAX package's
parallel/buffer.py).

The JAX Buffer wraps each strategy's per-shard function in a shard_map over
a mesh axis and takes and returns arrays sharded over it. The port's Buffer
is one rank's: it takes this rank's shard (x [T, H], topk_idx [T, K], the
local experts' weights [El, ...]) and returns this rank's results, with an
EPGroup (parallel/comm.py) as the communicator. `Buffer(None, E)` is one
rank, a loopback (bench.py --config moe's EP = 1); the card runs that form,
and the CPU tests run 1, 2 and 4 ranks over gloo.

Strategies come from SKT_DEEP_USE_MODE ("normal,low_latency", default
"default,default") or the constructor: the normal-mode dispatch / combine
("default", "alltoall", "layered"; strategies/normal.py, layered.py), the
low-latency ones ("default", "alltoall", "pallas", "layered") and the fused
MoE layer. The layered strategies take a pair of groups (dcn, ici) for
`group`. Nothing here syncs the host except dispatch's overflow check under
on_overflow="retry" or "error", which the JAX Buffer makes too.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import env
from ..utils.logging import get_logger
from . import fused_moe as _fm
from .comm import EPGroup
from .config import Config
from .event import EventOverlap, FuseMode
from .layout import get_dispatch_layout as _layout
from .strategies import layered as _layered  # noqa: F401  (registers "layered")
from .strategies import low_latency as _ll
from .strategies import normal as _normal
from .strategies import pallas_ll as _pll  # noqa: F401  (registers "pallas")
from .strategies.fused_moe_pallas import fused_deep_moe_pallas_shard
from .strategy import get_low_latency_strategy, get_normal_strategy


class Buffer:
    """EP communication of one rank.

    Args:
      group: an EPGroup, a torch.distributed process group, or None (one
        rank); for the layered strategies a pair (dcn, ici) of them.
      num_experts: total experts, divisible by the rank count.
      num_max_dispatch_tokens_per_rank: the decode path's token bound.
    """

    def __init__(self, group, num_experts: int,
                 num_max_dispatch_tokens_per_rank: int = 128,
                 normal_strategy: Optional[str] = None,
                 low_latency_strategy: Optional[str] = None):
        if isinstance(group, (tuple, list)):
            self.group = tuple(g if isinstance(g, EPGroup) else EPGroup(g) for g in group)
            self.num_ranks = self.group[0].num_ranks * self.group[1].num_ranks
        else:
            self.group = group if isinstance(group, EPGroup) else EPGroup(group)
            self.num_ranks = self.group.num_ranks
        assert num_experts % self.num_ranks == 0
        self.num_experts = num_experts
        self.num_local_experts = num_experts // self.num_ranks
        self.num_max_dispatch_tokens_per_rank = num_max_dispatch_tokens_per_rank
        self._last_notify_counts = None
        n_name, ll_name = env.deep_use_mode()
        self._normal = get_normal_strategy(normal_strategy or n_name)
        self._low_latency = get_low_latency_strategy(low_latency_strategy or ll_name)
        get_logger().info("Buffer: ep=%d experts=%d normal=%s low_latency=%s",
                          self.num_ranks, num_experts, self._normal.strategy_name,
                          self._low_latency.strategy_name)

    @property
    def _flat(self) -> EPGroup:
        """The group over all ranks (of a layered pair: the pair flattened)."""
        if isinstance(self.group, tuple):
            return _layered.flat_group(self.group)
        return self.group

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

    def notify_verify(self, topk_idx):
        """The count exchange alone (metadata of a dispatch): (recv_counts
        [R] rows from each rank, recv_offsets [R], expert_global_offset
        [El], total_recv [1], max_bs [1] (the most rows any rank sends),
        recv_tokens_per_expert [El] (every rank's copies of my experts))."""
        e, r = self.num_experts, self.num_ranks
        el = e // r
        g = self._flat
        _, nte, in_rank = _layout(topk_idx, e, r)
        m = g.all_gather(in_rank.sum(0, dtype=torch.int32))
        recv_counts = m[:, g.rank]
        mine = g.all_reduce_sum(nte)[g.rank * el:(g.rank + 1) * el]
        out = (recv_counts, _normal.excl_cumsum(recv_counts), _normal.excl_cumsum(mine),
               recv_counts.sum(dtype=torch.int32).reshape(1),
               m.sum(1, dtype=torch.int32).amax().reshape(1), mine)
        self._last_notify_counts = recv_counts
        return out

    # ----------------------------------------------- reference API parity

    @staticmethod
    def set_num_sms(new_num_sms: int) -> None:
        """Sets Config's default SM split (kept for call-site compatibility:
        the port's EP exchanges launch no kernel of their own)."""
        Config.default_num_sms = int(new_num_sms)

    @staticmethod
    def capture() -> EventOverlap:
        """An event recorded on the current stream (none without a card)."""
        if not torch.cuda.is_available():
            return EventOverlap()
        ev = torch.cuda.Event()
        ev.record()
        return EventOverlap(ev)

    @staticmethod
    def get_low_latency_rdma_size_hint(num_max_dispatch_tokens_per_rank: int, hidden: int,
                                       num_ranks: int, num_experts: int) -> int:
        """Bytes of the slotted receive buffer [El, R*maxT, H] (an int8 row
        and an f32 scale a token)."""
        el = num_experts // num_ranks
        return int(el * num_ranks * num_max_dispatch_tokens_per_rank * (hidden + 4))

    def clean_low_latency_buffer(self, *args, **kwargs) -> None:
        """Nothing persists between calls (every buffer is a fresh tensor)."""

    def get_notify_send_data(self):
        """The [R] row counts of the last notify_verify."""
        return self._last_notify_counts

    def internode_dispatch(self, *args, **kwargs):
        """dispatch(): one dispatch serves both fabrics (the layered strategy
        stages through the pair of groups)."""
        return self.dispatch(*args, **kwargs)

    def internode_combine(self, *args, **kwargs):
        return self.combine(*args, **kwargs)

    # ------------------------------------------------------------- normal

    def dispatch(self, x, topk_idx, topk_weights, quant_mode: str = "bf16",
                 capacity_factor: float = 2.0, config: Optional[Config] = None,
                 dispatch_wait_recv_cost_stats=None, on_overflow: str = "retry"):
        """Normal-mode dispatch of this rank's x [T, H]. Returns (recv_x
        [RBUF, H], scales [RBUF, 1] f32 (int8 and fp8) or None, recv_topk_idx
        [RBUF, K], recv_topk_weights [RBUF, K], recv_count [1],
        recv_tokens_per_expert [El], handle) and, where
        dispatch_wait_recv_cost_stats ([R, R] int) is given, that plus every
        rank's received rows (row j: what rank j received from each rank).

        on_overflow: with capacity_factor * T * min(K, R) receive rows a
        skewed routing can arrive past the buffer. "retry" (default) checks
        the flag of every rank (one host sync) and dispatches again at the
        worst case, R * T rows, so that no row is dropped; "error" raises
        instead; "flag" leaves the flag in handle.overflow (rows dropped)."""
        assert on_overflow in ("retry", "flag", "error"), on_overflow
        if env.bf16_dispatch():
            quant_mode = "bf16"
        config = config or Config.get_dispatch_config(self.num_ranks)
        res = self._normal.dispatch(x, topk_idx, topk_weights, group=self.group,
                                    num_experts=self.num_experts, quant_mode=quant_mode,
                                    capacity_factor=capacity_factor, config=config)
        overflow = torch.as_tensor(res.overflow, device=x.device).reshape(1)
        if on_overflow != "flag" and bool(self._flat.all_reduce_sum(overflow.int()) > 0):
            if on_overflow == "error":
                raise RuntimeError(
                    "normal dispatch overflow: skewed routing exceeded "
                    f"capacity_factor={capacity_factor} receive buffers (rows would be "
                    "dropped); retry with on_overflow='retry' or a larger capacity_factor")
            get_logger().warning("dispatch overflow at capacity_factor=%s; re-dispatching at "
                                 "worst-case capacity (R*T rows)", capacity_factor)
            return self.dispatch(
                x, topk_idx, topk_weights, quant_mode=quant_mode,
                capacity_factor=float(self.num_ranks * x.shape[0]), config=config,
                dispatch_wait_recv_cost_stats=dispatch_wait_recv_cost_stats,
                on_overflow="flag")
        hd = res.handle
        hd.overflow = overflow
        scales = None
        if quant_mode in ("int8", "fp8"):
            scales = res.recv_x_scales
            if scales is None:
                scales = torch.zeros((res.recv_x.shape[0], 1), dtype=torch.float32,
                                     device=x.device)
        out = (res.recv_x, scales, res.recv_topk_idx, res.recv_topk_weights,
               res.recv_count.reshape(1), res.recv_tokens_per_expert, hd)
        if dispatch_wait_recv_cost_stats is not None:
            stats = dispatch_wait_recv_cost_stats + self._flat.all_gather(
                hd.recv_sizes).to(dispatch_wait_recv_cost_stats.dtype)
            out = out + (stats,)
        return out

    def combine(self, x, handle, topk_weights, config: Optional[Config] = None,
                combine_send_cost_stats=None):
        """Normal-mode combine (the reverse of dispatch) of x [RBUF, H].
        Returns (combined_x [T, H], combined_topk_weights [T, K]) and, where
        combine_send_cost_stats ([R, R] int) is given, that plus every
        rank's rows sent back (row j: what rank j sends each rank)."""
        config = config or Config.get_combine_config(self.num_ranks)
        out = self._normal.combine(x, handle, topk_weights, group=self.group, config=config)
        if combine_send_cost_stats is not None:
            stats = combine_send_cost_stats + self._flat.all_gather(
                handle.recv_sizes).to(combine_send_cost_stats.dtype)
            return out + (stats,)
        return out

    # --------------------------------------------------------- low latency

    def low_latency_dispatch(self, x, topk_idx, quant_mode: str = "int8", elastic_info=None,
                             cumulative_local_expert_recv_stats=None):
        """Decode-path dispatch. Returns (recv_x [El, R*maxT, Hp], scales
        (strategies/low_latency.py) or None, packed_recv_count [El], layout_range [R, El],
        handle) and, when cumulative_local_expert_recv_stats ([El] int32) is
        given, that plus packed_recv_count."""
        if env.bf16_dispatch():
            quant_mode = "bf16"
        res = self._low_latency.low_latency_dispatch(
            x, topk_idx, group=self.group, num_experts=self.num_experts,
            num_max_dispatch_tokens_per_rank=self.num_max_dispatch_tokens_per_rank,
            quant_mode=quant_mode, elastic_info=elastic_info,
            shared_expert_rank_num=env.shared_expert_rank_num())
        scales = None
        if quant_mode in _ll._QUANTISED:
            scales = res.recv_x_scales
            if scales is None:      # the oracle's fp8 mode sends bf16 rows
                scales = torch.zeros(res.recv_x.shape[:2], dtype=torch.float32,
                                     device=x.device)
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
