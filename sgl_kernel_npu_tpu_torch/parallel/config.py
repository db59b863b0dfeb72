"""Per-call EP communication config (counterpart of the JAX package's
parallel/config.py): the reference's per-EP-size presets of chunk sizes."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    # pipeline chunk (tokens) for comm/compute overlap in fused paths
    chunk_tokens: int = 256
    # Buffer.set_num_sms's value, kept for call-site compatibility
    default_num_sms = 24

    @staticmethod
    def get_dispatch_config(num_ranks: int) -> "Config":
        if num_ranks <= 8:
            return Config(chunk_tokens=512)
        if num_ranks <= 32:
            return Config(chunk_tokens=256)
        return Config(chunk_tokens=128)

    @staticmethod
    def get_combine_config(num_ranks: int) -> "Config":
        if num_ranks <= 8:
            return Config(chunk_tokens=512)
        if num_ranks <= 32:
            return Config(chunk_tokens=256)
        return Config(chunk_tokens=128)
