"""The port's normal-mode EP layer against the JAX package's, on the CPU:
Buffer.dispatch / combine under the "default" and "alltoall" strategies
(bf16 and int8), notify_verify, the cost statistics, the multi-round
long-sequence dispatch, the "retry" / "flag" / "error" overflow contracts
on a skewed routing, and the layered strategies (normal and low-latency).

R = 1 runs in this process; R = 2 and 4 in spawned processes joined by a
gloo group (one world a rank count, every case run in it), R = 4 also as a
2 x 2 (dcn, ici) grid of sub-groups for the layered strategies. The JAX
side runs the JAX Buffer (or the strategies under shard_map) on as many of
the 8 CPU devices, the layered ones on a (2, 2) mesh.

Sizes as tests/test_ep_dispatch_combine.py (E 32, T 16 a rank, K 4, H 64;
10% of the slots dropped) and tests/test_layered.py (E 16, T 8, K 2, H 32)
for the layered strategies; x rounded to bf16 on both sides. Tolerances:
dispatch outputs, counts, handles, notify_verify and the statistics exact;
combines within one bf16 ulp plus 1e-6 of max|ref|; the layered buffers
bit-identical to the flat strategy's.
"""

import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sgl_kernel_npu_tpu_torch.parallel import Buffer, EPGroup
from sgl_kernel_npu_tpu_torch.parallel.strategies import normal as tnormal
from sgl_kernel_npu_tpu_torch.parallel.strategy import get_normal_strategy

E, T, K, H = 32, 16, 4, 64
LE, LT, LK, LH = 16, 8, 2, 32          # the layered cases
STRATEGIES = ("default", "alltoall")
QUANTS = ("bf16", "int8")
HANDLE = ("send_slot_token", "send_valid", "send_counts", "input_offsets", "output_offsets",
          "recv_sizes", "recv_offsets")
DISPATCH = ("recv_x", "scales", "recv_idx", "recv_w", "recv_count", "per_expert")


def make_data(rng, r):
    n = r * T
    x = np.asarray(jnp.asarray(rng.standard_normal((n, H)), jnp.bfloat16).astype(jnp.float32))
    idx = np.stack([rng.choice(E, K, replace=False) for _ in range(n)]).astype(np.int32)
    idx = np.where(rng.random((n, K)) < 0.1, -1, idx).astype(np.int32)
    w = rng.random((n, K)).astype(np.float32)
    # one copy a token, every one to rank 0's experts: with K < R rank 0
    # receives past capacity_factor 1.0
    skew = (np.arange(n) % (E // r)).astype(np.int32)[:, None]
    lx = np.asarray(jnp.asarray(rng.standard_normal((4 * LT, LH)), jnp.bfloat16)
                    .astype(jnp.float32))
    lidx = np.stack([rng.choice(LE, LK, replace=False) for _ in range(4 * LT)]).astype(np.int32)
    lw = rng.random((4 * LT, LK)).astype(np.float32)
    return dict(x=x, idx=idx, w=w, skew=skew, skew_w=w[:, :1].copy(), lx=lx, lidx=lidx, lw=lw)


def _record(out):
    """The dispatch tuple of Buffer.dispatch as a dict."""
    rec = dict(zip(DISPATCH, out[:6]))
    rec.update({f: getattr(out[6], f) for f in HANDLE})
    rec["overflow"] = out[6].overflow
    return rec


def _comb_in(rec, quant):
    return rec["recv_x"] if quant == "bf16" else rec["recv_x"].float() * rec["scales"]


def port_cases(group, rank, r, data, pair=None):
    """Every case of one rank through the port; a dict of results."""
    sl = slice(rank * T, (rank + 1) * T)
    x = torch.from_numpy(data["x"][sl]).to(torch.bfloat16)
    idx, w = torch.from_numpy(data["idx"][sl]), torch.from_numpy(data["w"][sl])
    out = {}
    for strat in STRATEGIES:
        buf = Buffer(group, E, normal_strategy=strat)
        for quant in QUANTS:
            res = buf.dispatch(x, idx, w, quant_mode=quant, capacity_factor=float(r))
            rec = _record(res)
            rec["combine"] = buf.combine(_comb_in(rec, quant), res[6], res[3])
            out[f"{strat}/{quant}"] = rec
    buf = Buffer(group, E)
    out["notify"] = buf.notify_verify(idx)
    zeros = torch.zeros((r, r), dtype=torch.int32)
    res = buf.dispatch(x, idx, w, capacity_factor=float(r), dispatch_wait_recv_cost_stats=zeros)
    comb = buf.combine(res[0], res[6], res[3], combine_send_cost_stats=zeros + 1)
    out["stats"] = (res[7], comb[2])
    strat = get_normal_strategy("default")
    rounds = tnormal.dispatch_long_seq(strat, x, idx, w, rounds=4, group=buf.group,
                                       num_experts=E, capacity_factor=float(r))
    out["long"] = tnormal.combine_long_seq(strat, [q.recv_x for q in rounds],
                                           [q.handle for q in rounds],
                                           [q.recv_topk_weights for q in rounds], group=buf.group)
    sidx, sw = torch.from_numpy(data["skew"][sl]), torch.from_numpy(data["skew_w"][sl])
    for mode in ("retry", "flag"):
        out[f"skew/{mode}"] = _record(buf.dispatch(x, sidx, sw, capacity_factor=1.0,
                                                   on_overflow=mode))
    try:
        buf.dispatch(x, sidx, sw, capacity_factor=1.0, on_overflow="error")
        out["skew/error"] = False
    except RuntimeError:
        out["skew/error"] = True
    if pair is not None:
        out["layered"] = layered_cases(group, pair, rank, data)
    return out


def layered_cases(world, pair, rank, data):
    """The layered strategies over the (dcn, ici) pair and the flat ones over
    the world, on the layered sizes."""
    sl = slice(rank * LT, (rank + 1) * LT)
    x = torch.from_numpy(data["lx"][sl]).to(torch.bfloat16)
    idx, w = torch.from_numpy(data["lidx"][sl]), torch.from_numpy(data["lw"][sl])
    out = {}
    for name, g, ns in (("layered", pair, "layered"), ("flat", world, "default")):
        buf = Buffer(g, LE, num_max_dispatch_tokens_per_rank=LT, normal_strategy=ns,
                     low_latency_strategy=ns)
        for quant in QUANTS:
            res = buf.dispatch(x, idx, w, quant_mode=quant, capacity_factor=4.0)
            rec = _record(res)
            rec["combine"] = buf.combine(_comb_in(rec, quant), res[6], res[3])
            ll = buf.low_latency_dispatch(x, idx, quant_mode=quant)
            rec["ll"] = dict(recv=ll[0], scales=ll[1], packed=ll[2], layout=ll[3],
                             combine=buf.low_latency_combine(
                                 ll[0] if quant == "bf16" else
                                 (ll[0].float() * ll[1][..., None]).to(torch.bfloat16),
                                 idx, w, ll[4]))
            out[f"{name}/{quant}"] = rec
    return out


def _rank_main(rank, world, init_file, out_dir, data):
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        pair = None
        if world == 4:
            ici = [dist.new_group([d * 2 + i for i in range(2)]) for d in range(2)]
            dcn = [dist.new_group([d * 2 + i for d in range(2)]) for i in range(2)]
            pair = (EPGroup(dcn[rank % 2]), EPGroup(ici[rank // 2]))
        out = port_cases(EPGroup(dist.group.WORLD), rank, world, data, pair)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ the JAX side

def _np(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def jax_cases(data, r):
    from sgl_kernel_npu_tpu.parallel import Buffer as JBuffer
    from sgl_kernel_npu_tpu.parallel.strategies import normal as jnormal
    from sgl_kernel_npu_tpu.parallel.strategy import get_normal_strategy as jget

    mesh = Mesh(np.array(jax.devices()[:r]), ("ep",))
    shard = NamedSharding(mesh, P("ep"))
    x = jax.device_put(jnp.asarray(data["x"], jnp.bfloat16), shard)
    idx, w = jnp.asarray(data["idx"]), jnp.asarray(data["w"])

    def record(o):
        rec = {k: _np(v) for k, v in zip(DISPATCH, o[:6])}
        rec.update({f: _np(getattr(o[6], f)) for f in HANDLE})
        rec["overflow"] = _np(o[6].overflow)
        return rec, o[6]

    out = {}
    bufs = {strat: JBuffer(mesh, E, normal_strategy=strat) for strat in STRATEGIES}
    for strat, buf in bufs.items():
        for quant in QUANTS:
            o = buf.dispatch(x, idx, w, quant_mode=quant, capacity_factor=float(r))
            rec, hd = record(o)
            comb_in = o[0] if quant == "bf16" else jnp.asarray(
                np.asarray(o[0], np.float32) * np.asarray(o[1]))
            rec["combine"] = tuple(_np(a) for a in buf.combine(comb_in, hd, o[3]))
            out[f"{strat}/{quant}"] = rec
    buf = bufs["default"]            # its compiled dispatch and combine serve again
    out["notify"] = [_np(a) for a in buf.notify_verify(idx)]
    zeros = jnp.zeros((r, r), jnp.int32)
    o = buf.dispatch(x, idx, w, capacity_factor=float(r), dispatch_wait_recv_cost_stats=zeros)
    comb = buf.combine(o[0], o[6], o[3], combine_send_cost_stats=zeros + 1)
    out["stats"] = (_np(o[7]), _np(comb[2]))
    strat = jget("default")

    def long_fn(xx, ii, ww):
        res = jnormal.dispatch_long_seq(strat, xx, ii, ww, rounds=4, axis_name="ep",
                                        num_experts=E, num_ranks=r,
                                        capacity_factor=float(r))
        return jnormal.combine_long_seq(strat, [q.recv_x for q in res], [q.handle for q in res],
                                        [q.recv_topk_weights for q in res], axis_name="ep")

    out["long"] = tuple(_np(a) for a in jax.jit(jax.shard_map(
        long_fn, mesh=mesh, in_specs=(P("ep"),) * 3, out_specs=(P("ep"),) * 2,
        check_vma=False))(x, idx, w))
    sidx, sw = jnp.asarray(data["skew"]), jnp.asarray(data["skew_w"])
    for mode in ("retry", "flag"):
        out[f"skew/{mode}"] = record(buf.dispatch(x, sidx, sw, capacity_factor=1.0,
                                                  on_overflow=mode))[0]
    try:
        buf.dispatch(x, sidx, sw, capacity_factor=1.0, on_overflow="error")
        out["skew/error"] = False
    except RuntimeError:
        out["skew/error"] = True
    return out


def jax_layered(data):
    """The JAX layered and flat strategies on a (2, 2) mesh: per name and
    quant the dispatch, the combine and the low-latency round trip."""
    from sgl_kernel_npu_tpu.parallel.strategy import get_low_latency_strategy as jll
    from sgl_kernel_npu_tpu.parallel.strategy import get_normal_strategy as jget

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
    spec = P(("dcn", "ici"))
    x = jax.device_put(jnp.asarray(data["lx"], jnp.bfloat16), NamedSharding(mesh, spec))
    idx, w = jnp.asarray(data["lidx"]), jnp.asarray(data["lw"])
    out = {}
    for name, sname in (("layered", "layered"), ("flat", "default")):
        strat, ll = jget(sname), jll(sname)
        for quant in QUANTS:
            def fn(xx, ii, ww):
                res = strat.dispatch(xx, ii, ww, axis_name=("dcn", "ici"), num_experts=LE,
                                     num_ranks=4, quant_mode=quant, capacity_factor=4.0)
                sc = res.recv_x_scales
                cin = res.recv_x if quant == "bf16" else res.recv_x.astype(jnp.float32) * sc
                comb, cw = strat.combine(cin, res.handle, res.recv_topk_weights,
                                         axis_name=("dcn", "ici"))
                lr = ll.low_latency_dispatch(xx, ii, axis_name=("dcn", "ici"), num_experts=LE,
                                             num_ranks=4, num_max_dispatch_tokens_per_rank=LT,
                                             quant_mode=quant)
                lin = lr.recv_x if quant == "bf16" else (
                    lr.recv_x.astype(jnp.float32) * lr.recv_x_scales[..., None]
                ).astype(jnp.bfloat16)
                lcomb = ll.low_latency_combine(lin, ii, ww, lr.handle, axis_name=("dcn", "ici"))
                return (res.recv_x, res.recv_topk_idx, res.recv_topk_weights,
                        res.recv_count[None], res.recv_tokens_per_expert, comb, cw,
                        lr.recv_x, lr.layout_range, lr.packed_recv_count, lcomb)
            o = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                                      out_specs=(spec,) * 11, check_vma=False))(x, idx, w)
            o = [_np(a) for a in o]
            out[f"{name}/{quant}"] = dict(
                recv_x=o[0], recv_idx=o[1], recv_w=o[2], recv_count=o[3], per_expert=o[4],
                combine=(o[5], o[6]), ll=dict(recv=o[7], layout=o[8], packed=o[9],
                                              combine=o[10]))
    return out


# ------------------------------------------------------------------ the worlds

def _spawn(r, data, tmp):
    mp.start_processes(_rank_main, args=(r, str(tmp / "init"), str(tmp), data), nprocs=r,
                       join=True, start_method="spawn")
    return [torch.load(tmp / f"rank{i}.pt") for i in range(r)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """R -> (data, the port's per-rank results, the JAX package's), for R =
    1, 2 and 4; the 4-rank world also runs the layered cases."""
    out = {}
    for r in (1, 2, 4):
        data = make_data(np.random.default_rng(60 + r), r)
        if r == 1:
            port = [port_cases(EPGroup(None), 0, 1, data)]
        else:
            port = _spawn(r, data, tmp_path_factory.mktemp(f"normal{r}"))
        want = jax_cases(data, r)
        if r == 4:
            want["layered"] = jax_layered(data)
        out[r] = (r, data, port, want)
    return out


@pytest.fixture(params=[1, 2, 4], ids=lambda r: f"R{r}")
def world(request, worlds):
    return worlds[request.param]


def _block(a, rank, r):
    n = a.shape[0] // r
    return a[rank * n:(rank + 1) * n]


def _exact(got, want, name):
    got = _np(got)
    assert got.shape == want.shape and np.array_equal(got, want), name


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("quant", QUANTS)
def test_dispatch_exact(world, strategy, quant):
    """Every rank's receive buffer (padding rows and all), scales, masked ids
    and weights, counts and handle equal its shard of the JAX Buffer's."""
    r, _, port, want = world
    key = f"{strategy}/{quant}"
    for rank in range(r):
        for f in DISPATCH + HANDLE:
            if f == "scales" and quant == "bf16":
                assert port[rank][key][f] is None and want[key][f] is None
                continue
            _exact(port[rank][key][f], _block(want[key][f], rank, r), (key, rank, f))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("quant", QUANTS)
def test_combine_close(world, strategy, quant):
    """combine (x and weights) within one bf16 ulp of the JAX combine, and
    the round trip x * sum(w) within the JAX test's bar (bf16: two bf16
    roundings)."""
    from .test_torch_moe import assert_bf16_sum_close
    r, data, port, want = world
    key = f"{strategy}/{quant}"
    golden = data["x"] * np.where(data["idx"] >= 0, data["w"], 0.0).sum(-1, keepdims=True)
    # int8: the JAX test's bar; bf16: two bf16 roundings (the weighted rows
    # and the sum) where the JAX test's f32 rows take none
    rtol, atol = {"bf16": (2.0 ** -7, 1e-3), "int8": (0.06, 0.06)}[quant]
    for rank in range(r):
        for i in range(2):
            assert_bf16_sum_close(_np(port[rank][key]["combine"][i]),
                                  _block(want[key]["combine"][i], rank, r), (key, rank, i))
        np.testing.assert_allclose(_np(port[rank][key]["combine"][0]),
                                   _block(golden, rank, r), rtol=rtol, atol=atol)


def test_notify_verify_exact(world):
    """notify_verify's six outputs equal the JAX Buffer's shards, and its
    counts equal the dispatch's."""
    r, _, port, want = world
    for rank in range(r):
        for i, (got, jx) in enumerate(zip(port[rank]["notify"], want["notify"])):
            _exact(got, _block(jx, rank, r), (rank, i))
        _exact(port[rank]["notify"][0], port[rank]["default/bf16"]["recv_sizes"], rank)


def test_cost_stats_exact(world):
    """The dispatch and combine statistics ([R, R], the same on every rank)
    equal the JAX Buffer's."""
    r, _, port, want = world
    for rank in range(r):
        _exact(port[rank]["stats"][0], want["stats"][0], ("dispatch", rank))
        _exact(port[rank]["stats"][1], want["stats"][1], ("combine", rank))


def test_long_seq_rounds(world):
    """dispatch_long_seq -> combine_long_seq (4 rounds) within one bf16 ulp
    of the JAX rounds."""
    from .test_torch_moe import assert_bf16_sum_close
    r, _, port, want = world
    for rank in range(r):
        for i in range(2):
            assert_bf16_sum_close(_np(port[rank]["long"][i]), _block(want["long"][i], rank, r),
                                  (rank, i))


@pytest.mark.parametrize("mode", ["retry", "flag"])
def test_overflow_contracts(world, mode):
    """On the skewed routing at capacity_factor 1: "retry" re-dispatches at
    R * T rows (no row dropped), "flag" keeps the capped buffers with the
    flag set on rank 0 (from R = 2); both equal the JAX Buffer's, flag and
    all."""
    r, _, port, want = world
    key = f"skew/{mode}"
    for rank in range(r):
        for f in ("recv_x", "recv_idx", "recv_w", "recv_count", "per_expert") + HANDLE:
            _exact(port[rank][key][f], _block(want[key][f], rank, r), (key, rank, f))
        _exact(port[rank][key]["overflow"], _block(want[key]["overflow"], rank, r),
               (key, rank))
    flags = [bool(port[rank][key]["overflow"].any()) for rank in range(r)]
    assert flags[0] == (mode == "flag" and r > 1) and not any(flags[1:]), flags


def test_overflow_error(world):
    """on_overflow="error" raises on every rank where the JAX Buffer does
    (from R = 2)."""
    r, _, port, want = world
    assert want["skew/error"] == (r > 1)
    assert all(port[rank]["skew/error"] == want["skew/error"] for rank in range(r))


@pytest.mark.parametrize("quant", QUANTS)
def test_layered_normal_matches_flat_and_jax(worlds, quant):
    """The layered normal dispatch over 2 x 2 gloo ranks gives the flat
    strategy's buffers bit for bit and the JAX layered strategy's; its
    combine within one bf16 ulp of the JAX one."""
    from .test_torch_moe import assert_bf16_sum_close
    r, _, port, want = worlds[4]
    key = f"layered/{quant}"
    for rank in range(r):
        got, flat = port[rank]["layered"][key], port[rank]["layered"][f"flat/{quant}"]
        jx = want["layered"][key]
        for f in ("recv_x", "recv_idx", "recv_w", "recv_count", "per_expert"):
            _exact(got[f], _np(flat[f]), (rank, f, "flat"))
            _exact(got[f], _block(jx[f], rank, r), (rank, f, "jax"))
        for f in HANDLE:
            _exact(got[f], _np(flat[f]), (rank, f, "flat handle"))
            assert got[f].dtype == flat[f].dtype, (rank, f)
        for i in range(2):
            assert_bf16_sum_close(_np(got["combine"][i]), _block(jx["combine"][i], rank, r),
                                  (rank, i))


@pytest.mark.parametrize("quant", QUANTS)
def test_layered_low_latency_matches_flat_and_jax(worlds, quant):
    """The layered low-latency dispatch over 2 x 2 gloo ranks: the slotted
    buffer, layout and counts equal the flat strategy's and the JAX layered
    strategy's; its combine within one bf16 ulp of the JAX one."""
    from .test_torch_moe import assert_bf16_sum_close
    r, _, port, want = worlds[4]
    for rank in range(r):
        got = port[rank]["layered"][f"layered/{quant}"]["ll"]
        flat = port[rank]["layered"][f"flat/{quant}"]["ll"]
        jx = want["layered"][f"layered/{quant}"]["ll"]
        for f in ("recv", "layout", "packed"):
            _exact(got[f], _np(flat[f]), (rank, f, "flat"))
            _exact(got[f], _block(jx[f], rank, r), (rank, f, "jax"))
            assert got[f].dtype == flat[f].dtype, (rank, f)
        if quant == "int8":
            _exact(got["scales"], _np(flat["scales"]), (rank, "scales"))
        assert_bf16_sum_close(_np(got["combine"]), _block(jx["combine"], rank, r), rank)


def test_combine_is_bit_stable_without_index_add(monkeypatch):
    """The normal combine gives the same bits in two calls, and its path
    takes no index_add_ (whose CUDA form adds with float atomics)."""
    rng = np.random.default_rng(7)
    data = make_data(rng, 1)
    x = torch.from_numpy(data["x"]).to(torch.bfloat16)
    idx, w = torch.from_numpy(data["idx"]), torch.from_numpy(data["w"])
    buf = Buffer(None, E)
    res = buf.dispatch(x, idx, w)

    def refuse(*a, **kw):
        raise AssertionError("index_add_ on the combine path")
    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    monkeypatch.setattr(torch.Tensor, "index_add", refuse)
    monkeypatch.setattr(torch, "index_add", refuse)
    a = buf.combine(res[0], res[6], res[3])
    b = buf.combine(res[0], res[6], res[3])
    assert all(torch.equal(u, v) for u, v in zip(a, b))
