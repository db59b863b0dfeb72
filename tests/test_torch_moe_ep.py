"""The port's EP layer across ranks on the CPU: 2 and 4 processes joined by a
gloo group (torch.multiprocessing, init_method="file://...", so that
parallel test workers never meet on a port), each running the port's plain
path for its rank: Buffer.low_latency_dispatch / low_latency_combine under
the "default" and "pallas" strategies and Buffer.fused_deep_moe under
"pallas" (K11's plain version, whose scatters move chunks through the
group). Each rank's results are held in the parent against the JAX Buffer
under shard_map on as many of the 8 CPU devices (SKT_IMPL=pallas, the
Pallas kernels interpreted with real cross-device remote DMAs). This holds
the multi-rank wiring, dst_off = e*R*maxT + me*maxT and the reverse
offsets of the combines, which one rank cannot show.

Sizes as tests/test_torch_moe.py: H 256, F 128, T 16 per rank, K 2, E 2R.
Tolerances as there: dispatch outputs, counts and handles exact; combines
within one bf16 ulp (plus 1e-6 of max|ref|); the fused layer within
calc_diff 1e-5 and rtol = atol = 0.05.
"""

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sgl_kernel_npu_tpu_torch.parallel import Buffer, EPGroup

T, K, MAXT = 16, 2, 32
FIELDS = ("copy_slot", "send_counts", "input_offsets", "recv_counts")


def _rank_main(rank, world, init_file, out_dir, data):
    """One rank: this rank's shard of `data` through the port's Buffer; the
    results go to out_dir/rank<rank>.pt."""
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        group = EPGroup(dist.group.WORLD)
        e = data["w13q"].shape[0]
        el = e // world
        tok, ex = slice(rank * T, (rank + 1) * T), slice(rank * el, (rank + 1) * el)
        x = torch.from_numpy(data["x"][tok]).to(torch.bfloat16)
        idx = torch.from_numpy(data["idx"][tok])
        w = torch.from_numpy(data["w"][tok])
        res = {}
        for strategy in ("default", "pallas"):
            buf = Buffer(group, e, num_max_dispatch_tokens_per_rank=MAXT,
                         low_latency_strategy=strategy)
            recv, sc, packed, lr, hd = buf.low_latency_dispatch(x, idx, quant_mode="int8")
            deq = (recv.float() * sc[..., None]).to(torch.bfloat16)
            res[strategy] = dict(recv=recv, scales=sc, packed=packed, layout_range=lr,
                                 combine=buf.low_latency_combine(deq, idx, w, hd),
                                 **{f: getattr(hd, f) for f in FIELDS})
        weights = [torch.from_numpy(data[k][ex]) for k in ("w13q", "w13s", "w2q", "w2s")]
        res["fused"] = Buffer(group, e, num_max_dispatch_tokens_per_rank=MAXT,
                              low_latency_strategy="pallas").fused_deep_moe(x, idx, w, *weights)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_side(data, r):
    """The JAX Buffer on r CPU devices: per strategy the global dispatch /
    combine outputs, and the pallas fused layer."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from sgl_kernel_npu_tpu.parallel import Buffer as JBuffer

    mesh = Mesh(np.array(jax.devices()[:r]), ("ep",))
    shard = NamedSharding(mesh, P("ep"))
    e = data["w13q"].shape[0]
    x = jax.device_put(jnp.asarray(data["x"], jnp.bfloat16), shard)
    idx, w = jnp.asarray(data["idx"]), jnp.asarray(data["w"])
    out = {}
    for strategy in ("default", "pallas"):
        buf = JBuffer(mesh, e, num_max_dispatch_tokens_per_rank=MAXT,
                      low_latency_strategy=strategy)
        recv, sc, packed, lr, hd = buf.low_latency_dispatch(x, idx, quant_mode="int8")
        deq = np.asarray(recv, np.float32) * np.asarray(sc)[..., None]
        comb = buf.low_latency_combine(jnp.asarray(deq, jnp.bfloat16), idx, w, hd)
        out[strategy] = dict(recv=np.asarray(recv), scales=np.asarray(sc),
                             packed=np.asarray(packed), layout_range=np.asarray(lr),
                             combine=np.asarray(comb, np.float32),
                             **{f: np.asarray(getattr(hd, f)) for f in FIELDS})
    buf = JBuffer(mesh, e, num_max_dispatch_tokens_per_rank=MAXT, low_latency_strategy="pallas")
    out["fused"] = np.asarray(buf.fused_deep_moe(
        x, idx, w, *(jnp.asarray(data[k]) for k in ("w13q", "w13s", "w2q", "w2s"))), np.float32)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda r: f"R{r}")
def ranks(request, tmp_path_factory):
    """(R, the port's per-rank results, the JAX package's global results)
    for one seeded layer of R ranks."""
    from .test_torch_moe import make_layer
    r = request.param
    os.environ["SKT_IMPL"] = "pallas"
    try:
        data = make_layer(np.random.default_rng(40 + r), ranks=r)
        data["x"] = np.asarray(data["x"], np.float32)
        tmp = tmp_path_factory.mktemp(f"ep{r}")
        mp.start_processes(_rank_main, args=(r, str(tmp / "init"), str(tmp), data), nprocs=r,
                           join=True, start_method="spawn")
        port = [torch.load(tmp / f"rank{i}.pt") for i in range(r)]
        jax_out = _jax_side(data, r)
    finally:
        del os.environ["SKT_IMPL"]
    return r, port, jax_out


def _block(a, rank, r):
    """Rank `rank`'s shard of a JAX array sharded over r ranks on dim 0."""
    n = a.shape[0] // r
    return a[rank * n:(rank + 1) * n]


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("strategy", ["default", "pallas"])
def test_dispatch_across_ranks_exact(ranks, strategy):
    """Every rank's recv (padding rows and all), scales, counts and handle
    equal its shard of the JAX Buffer's."""
    r, port, want = ranks
    for rank in range(r):
        got = port[rank][strategy]
        for key in ("recv", "scales", "packed", "layout_range", *FIELDS):
            assert np.array_equal(_np(got[key]), _block(want[strategy][key], rank, r)), \
                (strategy, rank, key)


@pytest.mark.parametrize("strategy", ["default", "pallas"])
def test_combine_across_ranks(ranks, strategy):
    """Every rank's combine within one bf16 ulp of its JAX shard."""
    from .test_torch_moe import assert_bf16_sum_close
    r, port, want = ranks
    for rank in range(r):
        assert_bf16_sum_close(_np(port[rank][strategy]["combine"]),
                              _block(want[strategy]["combine"], rank, r), f"{strategy} {rank}")


def test_fused_layer_across_ranks(ranks):
    """Buffer.fused_deep_moe under "pallas" (K11's plain version, the chunks
    moving through the gloo group) within the layer bound of the JAX
    fused kernel on every rank."""
    from .test_torch_moe import assert_layer_close
    r, port, want = ranks
    for rank in range(r):
        assert_layer_close(_np(port[rank]["fused"]), _block(want["fused"], rank, r),
                           f"rank {rank}")
