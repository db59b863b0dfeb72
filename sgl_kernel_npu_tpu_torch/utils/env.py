"""Runtime env-var flags read by the port (the SKT_* table of the JAX
package's utils/env.py, limited to the flags this package reads).

  SKT_IMPL    "auto" | "ref" | "pallas"   kernel impl selection. In the port
              "ref" asks a wrapper to run its plain PyTorch version even on a
              CUDA tensor; "auto" and "pallas" launch the kernel there.
  SKT_GEMM_BN int, default 512: panel width of the pretiled weight banks
              (models/llama.py::pretile_big_weights).
  SKT_DEEP_USE_MODE           EP strategy names "normal,low_latency"
                              (default "default,default")
  SKT_SHARED_EXPERT_RANK_NUM  int, shared-expert ranks of the EP dispatch
  SKT_BF16_DISPATCH           bool: skip the int8 quant of the EP dispatch
  SKT_NORMAL_LONG_SEQ_ROUND   int in [1, 256], default 1: rounds of the
                              multi-round normal dispatch (long_seq_config)
  SKT_NORMAL_PER_ROUND_TOKENS int in [1, 8192], default 8192: tokens a round
  SKT_LOG_LEVEL, SKT_LOG_DIR  the package logger (utils/logging.py)
  SKT_DECODE_ATTN   "v6" | "v3", default v6: the deferred attention of the
                    head-major ("hm") Llama decode (decode_v6 or decode_v3)
  SKT_DECODE_FLAT   bool, default on: the hm decode addresses the pages of
                    all layers as one [L*P] pool (off: per-layer slices, which
                    also turns the deferred write off)
  SKT_DECODE_DEFER  bool, default on: the hm decode attends the cache
                    read-only and writes every layer's new rows after the
                    loop (off: each layer writes, then attends with v3)
  SKT_DECODE_UNROLL bool, default off: in the JAX package, the unrolled layer
                    loop of the non-deferred branches; the port's loop is
                    always a Python loop, so the flag is read by nothing
  SKT_KV_LAYOUT     "tm" | "tm2" | "hm": the KV layout of the bench decode
                    path (bench.py:157-158); unset means tm2 when
                    models/llama.py::tm_layout_ok holds, else hm
"""

from __future__ import annotations

import os
from typing import Optional

_TRUE = ("1", "true", "yes", "on")

# the long-sequence normal dispatch's limits (the JAX package's utils/env.py)
MAX_LONG_SEQ_ROUNDS = 256
MAX_PER_ROUND_TOKENS = 8192
MAX_LONG_SEQ_TOKENS = 131072


def env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in _TRUE


def env_int(name: str, default: int, lo: Optional[int] = None, hi: Optional[int] = None) -> int:
    v = os.environ.get(name)
    if v is None:
        out = default
    else:
        try:
            out = int(v)
        except ValueError:
            out = default
    if lo is not None:
        out = max(lo, out)
    if hi is not None:
        out = min(hi, out)
    return out


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def impl_mode() -> str:
    """Kernel implementation selection: auto, or forced 'ref' / 'pallas'."""
    mode = env_str("SKT_IMPL", "auto").lower()
    if mode not in ("auto", "ref", "pallas"):
        mode = "auto"
    return mode


def deep_use_mode() -> tuple:
    """EP strategy pair selection (normal_name, low_latency_name)."""
    raw = env_str("SKT_DEEP_USE_MODE", "default,default")
    parts = [p.strip() or "default" for p in raw.split(",")]
    while len(parts) < 2:
        parts.append("default")
    return parts[0], parts[1]


def long_seq_config() -> tuple:
    """(rounds, per_round_tokens) of the multi-round normal dispatch: rounds
    <= 256, tokens a round <= 8192, their product <= 131072 (rounds cut to
    fit)."""
    rounds = env_int("SKT_NORMAL_LONG_SEQ_ROUND", 1, lo=1, hi=MAX_LONG_SEQ_ROUNDS)
    per_round = env_int("SKT_NORMAL_PER_ROUND_TOKENS", MAX_PER_ROUND_TOKENS, lo=1,
                        hi=MAX_PER_ROUND_TOKENS)
    if rounds * per_round > MAX_LONG_SEQ_TOKENS:
        rounds = max(1, MAX_LONG_SEQ_TOKENS // per_round)
    return rounds, per_round


def shared_expert_rank_num() -> int:
    return env_int("SKT_SHARED_EXPERT_RANK_NUM", 0, lo=0)


def bf16_dispatch() -> bool:
    return env_bool("SKT_BF16_DISPATCH", False)


def decode_attn() -> str:
    """SKT_DECODE_ATTN: the hm deferred decode attention, v6 or v3."""
    which = env_str("SKT_DECODE_ATTN", "v6")
    if which not in ("v6", "v3"):
        raise ValueError(f"SKT_DECODE_ATTN={which!r}: v6 or v3")
    return which


def decode_flat() -> bool:
    return env_bool("SKT_DECODE_FLAT", True)


def decode_defer() -> bool:
    return env_bool("SKT_DECODE_DEFER", True)


def kv_layout(default: str) -> str:
    """SKT_KV_LAYOUT, else `default`."""
    return env_str("SKT_KV_LAYOUT", default)
