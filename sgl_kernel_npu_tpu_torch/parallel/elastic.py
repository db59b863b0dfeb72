"""Elastic EP scale-down (counterpart of the JAX package's
parallel/elastic.py): the scale-down flag, the new world size, the shared
expert ranks, the expert count and a logical -> physical rank remap, read by
the dispatch's routing. Shapes stay fixed; the elastic info is data."""

from __future__ import annotations

from typing import NamedTuple

import torch


class ElasticInfo(NamedTuple):
    """flag + remap, in the reference's int32 block layout."""

    flag: torch.Tensor                    # [] int32, 1 = scale-down active
    new_world_size: torch.Tensor          # [] int32
    shared_expert_rank_num: torch.Tensor  # [] int32
    moe_expert_num: torch.Tensor          # [] int32
    rank_remap: torch.Tensor              # [R] int32: logical rank -> physical (or -1)

    @staticmethod
    def identity(num_ranks: int, device="cuda"):
        i32 = dict(dtype=torch.int32, device=device)
        return ElasticInfo(
            flag=torch.tensor(0, **i32),
            new_world_size=torch.tensor(num_ranks, **i32),
            shared_expert_rank_num=torch.tensor(0, **i32),
            moe_expert_num=torch.tensor(0, **i32),
            rank_remap=torch.arange(num_ranks, **i32),
        )

    def pack(self):
        return torch.cat([
            torch.stack([self.flag, self.new_world_size,
                         self.shared_expert_rank_num, self.moe_expert_num]),
            self.rank_remap,
        ])

    @staticmethod
    def unpack(arr, num_ranks: int):
        return ElasticInfo(arr[0], arr[1], arr[2], arr[3], arr[4:4 + num_ranks])


def remap_dst_rank(dst, elastic: "ElasticInfo | None", num_ranks: int):
    """Physical ranks for the logical owner ranks `dst`: a dead rank's
    tokens go to its remap target; a remap of -1 drops them (num_ranks)."""
    if elastic is None:
        return dst
    remapped = elastic.rank_remap[dst.clamp(0, num_ranks - 1).long()]
    remapped = torch.where(remapped < 0, num_ranks, remapped)
    return torch.where(elastic.flag > 0, remapped, dst)
