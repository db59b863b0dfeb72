"""The ranks of tests/test_torch_tp.py: spawned processes import this
module (torch and the port only, no JAX) to run decode_step_tp."""

import datetime
import os

import torch
import torch.distributed as dist

from sgl_kernel_npu_tpu_torch.models import llama as tl

PAGES = 16


def layout_caches(cfg, layout, tp, stacked):
    """tp per-shard caches of shard_cfg_tp(cfg, tp), stacked on a leading
    axis (stacked), or the one unsharded cache (tp 1, not stacked)."""
    cfg_s = tl.shard_cfg_tp(cfg, tp)

    def one():
        return tl.init_kv_cache(cfg_s, PAGES, layout=layout, device="cpu")
    if not stacked:
        return one()
    caches = [one() for _ in range(tp)]
    if isinstance(caches[0], tuple):
        return tuple(torch.stack(xs) for xs in zip(*caches))
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def rank_main(rank, world, init_file, out_dir, cases):
    """One rank: for each (layout, numpy params, steps) of `cases`,
    decode_step_tp over the steps on this rank's shard; the logits go to
    out_dir/<layout>_rank<rank>.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        for layout, npp, steps in cases:
            cfg = tl.tiny_config(int8_kv=layout == "tm")
            params_tp = tl.shard_params_tp(tl.params_from_jax(npp, "cpu"), cfg, world)
            kv_tp = layout_caches(cfg, layout, world, True)
            logits = []
            for args in steps:
                lg, kv_tp = tl.decode_step_tp(params_tp, cfg, kv_tp,
                                              *(torch.from_numpy(a) for a in args))
                logits.append(lg)
            torch.save(torch.stack(logits), os.path.join(out_dir, f"{layout}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
