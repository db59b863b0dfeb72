"""The port's MX codecs (ops/mxquant.py) and the low-latency dispatch's fp8,
mxfp8 and mxfp4 modes against the JAX package's, on the CPU.

The codecs are held bit for bit against the jitted JAX functions (what
the dispatch runs), on normal rows at several scales and on edge rows:
values at +-448, +-464 (the tie between 448 and the next e4m3 step, which
rounds to 448), past it (NaN), subnormals, a rounding tie of the e4m3
mantissa, the e2m1 grid and its midpoints, zeros, and block maxima a few
ulps around 448 * 2^k and 6 * 2^k, where XLA's log2 decides the scale.
The dispatch runs the JAX Buffer on 1 and 2 of the 8 CPU devices and the
port's Buffer in this process (R = 1) and in two spawned processes joined
by a gloo group (R = 2, one world, every case run in it): the received
bytes, scales, counts and handles exact, and the round trip through the
dequantised rows within the JAX tests' bars (fp8 0.1, mxfp8 0.12, mxfp4
0.4). Sizes as tests/test_ep_dispatch_combine.py (E 32, T 16 a rank, K 4,
H 64).
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

from sgl_kernel_npu_tpu.ops import mxquant as jmx
from sgl_kernel_npu_tpu_torch.ops import mxquant as tmx
from sgl_kernel_npu_tpu_torch.parallel import Buffer, EPGroup

E, T, K, H = 32, 16, 4, 64
MODES = ("fp8", "mxfp8", "mxfp4")
STRATEGIES = ("default", "alltoall")
BAR = {"fp8": 0.1, "mxfp8": 0.12, "mxfp4": 0.4}


def _bytes(a):
    """The bytes of a JAX / numpy / torch array, as a uint8 view."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def edge_rows():
    """Rows of 64 values that meet the codecs' edges (module docstring)."""
    e = [448, -448, 464, -464, 465, -470, 2.0 ** -9, -2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10,
         1.0625, 1.03125, 1.09375, 0.0, -0.0, 0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 6.0, -6.0]
    rows = [np.resize(np.array(e, np.float32), 64)]
    for k in (-12, -3, 0, 3, 9):
        for m in (448.0, 6.0):
            base = np.float32(np.float32(2.0 ** k) * np.float32(m))
            for d in range(-3, 4):
                v = base
                for _ in range(abs(d)):
                    v = np.nextafter(v, np.float32(np.inf if d > 0 else -np.inf))
                row = np.full(64, v / 3, np.float32)
                row[::32] = v                       # each block's maximum
                rows.append(row)
    return np.stack(rows)


def codec_inputs(kind):
    rng = np.random.default_rng({"normal": 0, "wide": 1, "tiny": 2}.get(kind, 3))
    if kind == "edges":
        return edge_rows()
    scale = {"normal": 1.0, "wide": 1e4, "tiny": 1e-6}[kind]
    x = rng.standard_normal((48, 256)).astype(np.float32) * scale
    if kind == "wide":
        x *= rng.choice([1e-4, 1.0, 30.0], (48, 1)).astype(np.float32)
    return x


@pytest.mark.parametrize("kind", ["normal", "wide", "tiny", "edges"])
@pytest.mark.parametrize("codec", ["mxfp8", "mxfp4"])
def test_codec_bits_match_jitted_jax(codec, kind):
    x = codec_inputs(kind)
    jq, js = jax.jit(getattr(jmx, f"quantize_{codec}"))(jnp.asarray(x))
    tq, ts = getattr(tmx, f"quantize_{codec}")(torch.from_numpy(x))
    assert np.array_equal(_bytes(tq), _bytes(jq)), codec
    assert np.array_equal(ts.numpy(), np.asarray(js)), codec
    jd = jax.jit(getattr(jmx, f"dequantize_{codec}"))(jq, js).astype(jnp.float32)
    td = getattr(tmx, f"dequantize_{codec}")(tq, ts).float()
    assert np.array_equal(td.numpy(), np.asarray(jd)), codec


@pytest.mark.parametrize("kind", ["normal", "wide", "edges"])
def test_fp8_per_token_matches_jitted_jax(kind):
    """The dispatch's per-token fp8 rows and scales (JAX low_latency.py's
    formula, jitted) bit for bit, from bf16 rows."""
    xb = jnp.asarray(codec_inputs(kind), jnp.bfloat16)

    def jf(x):
        x32 = x.astype(jnp.float32)
        xs8 = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True), 1e-7) / 448.0
        return (x32 / xs8).astype(jnp.float8_e4m3fn), xs8
    jq, js = jax.jit(jf)(xb)
    tq, ts = tmx.quantize_fp8_per_token(
        torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert np.array_equal(_bytes(tq), _bytes(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_e4m3_cast_edges_match_jax():
    """The f32 -> e4m3 cast at +-448, +-464 (to 448), past 464 and the
    infinities (NaN with the sign), subnormals and mantissa ties."""
    v = np.array([448, 464, 465, 479, 480, 1e6, -464, -465, np.inf, -np.inf, np.nan,
                  2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11, 1.0625, 1.03125, 1.09375, 1e-12, -0.0],
                 np.float32)
    want = np.asarray(jax.jit(lambda a: a.astype(jnp.float8_e4m3fn))(jnp.asarray(v)))
    assert np.array_equal(_bytes(tmx.to_e4m3(torch.from_numpy(v))), _bytes(want))


# ------------------------------------------------------------------ the dispatch

def make_data(rng, r):
    n = r * T
    x = np.asarray(jnp.asarray(rng.standard_normal((n, H)), jnp.bfloat16).astype(jnp.float32))
    idx = np.stack([rng.choice(E, K, replace=False) for _ in range(n)]).astype(np.int32)
    idx = np.where(rng.random((n, K)) < 0.1, -1, idx).astype(np.int32)
    return dict(x=x, idx=idx, w=rng.random((n, K)).astype(np.float32))


def _dequant(recv, scales, mode):
    """The received rows as f32 (recv [El, S, Hp])."""
    if mode == "fp8":
        if recv.dtype == torch.bfloat16:            # the oracle sends bf16
            return recv.float()
        return recv.float() * scales[..., None]
    fn = tmx.dequantize_mxfp8 if mode == "mxfp8" else tmx.dequantize_mxfp4
    return fn(recv, scales, out_dtype=torch.float32)


def port_cases(group, rank, data):
    sl = slice(rank * T, (rank + 1) * T)
    x = torch.from_numpy(data["x"][sl]).to(torch.bfloat16)
    idx, w = torch.from_numpy(data["idx"][sl]), torch.from_numpy(data["w"][sl])
    out = {}
    for strat in STRATEGIES:
        buf = Buffer(group, E, num_max_dispatch_tokens_per_rank=T, low_latency_strategy=strat)
        for mode in MODES:
            recv, sc, packed, lr, hd = buf.low_latency_dispatch(x, idx, quant_mode=mode)
            comb = buf.low_latency_combine(_dequant(recv, sc, mode), idx, w, hd)
            out[f"{strat}/{mode}"] = dict(recv=_bytes(recv), scales=sc.numpy(),
                                          packed=packed.numpy(), layout=lr.numpy(),
                                          copy_slot=hd.copy_slot.numpy(), combine=comb.numpy())
    return out


def _rank_main(rank, world, init_file, out_dir, data):
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(port_cases(EPGroup(dist.group.WORLD), rank, data),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def jax_cases(data, r):
    from sgl_kernel_npu_tpu.parallel import Buffer as JBuffer
    mesh = Mesh(np.array(jax.devices()[:r]), ("ep",))
    x = jax.device_put(jnp.asarray(data["x"], jnp.bfloat16), NamedSharding(mesh, P("ep")))
    idx = jnp.asarray(data["idx"])
    out = {}
    for strat in STRATEGIES:
        buf = JBuffer(mesh, E, num_max_dispatch_tokens_per_rank=T, low_latency_strategy=strat)
        for mode in MODES:
            recv, sc, packed, lr, hd = buf.low_latency_dispatch(x, idx, quant_mode=mode)
            out[f"{strat}/{mode}"] = dict(recv=_bytes(recv), scales=np.asarray(sc),
                                          packed=np.asarray(packed), layout=np.asarray(lr),
                                          copy_slot=np.asarray(hd.copy_slot))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """R -> (data, the port's per-rank results, the JAX package's), R = 1, 2."""
    out = {}
    for r in (1, 2):
        data = make_data(np.random.default_rng(80 + r), r)
        if r == 1:
            port = [port_cases(EPGroup(None), 0, data)]
        else:
            tmp = tmp_path_factory.mktemp("mx2")
            mp.start_processes(_rank_main, args=(r, str(tmp / "init"), str(tmp), data),
                               nprocs=r, join=True, start_method="spawn")
            port = [torch.load(tmp / f"rank{i}.pt", weights_only=False) for i in range(r)]
        out[r] = (data, port, jax_cases(data, r))
    return out


def _block(a, rank, r):
    n = a.shape[0] // r
    return a[rank * n:(rank + 1) * n]


@pytest.mark.parametrize("r", [1, 2], ids=lambda r: f"R{r}")
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mode", MODES)
def test_low_latency_dispatch_exact(worlds, r, strategy, mode):
    """Every rank's received bytes (padding and all), scales, counts, layout
    and copy slots equal its shard of the JAX Buffer's."""
    data, port, want = worlds[r]
    key = f"{strategy}/{mode}"
    for rank in range(r):
        for f in ("recv", "scales", "packed", "layout", "copy_slot"):
            got, jx = port[rank][key][f], _block(want[key][f], rank, r)
            assert got.shape == jx.shape and np.array_equal(got, jx, equal_nan=True), \
                (key, rank, f)


@pytest.mark.parametrize("r", [1, 2], ids=lambda r: f"R{r}")
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mode", MODES)
def test_low_latency_round_trip(worlds, r, strategy, mode):
    """The combine of the dequantised rows gives x * sum(w) within the JAX
    tests' bar for the mode."""
    data, port, _ = worlds[r]
    golden = data["x"] * np.where(data["idx"] >= 0, data["w"], 0.0).sum(-1, keepdims=True)
    for rank in range(r):
        np.testing.assert_allclose(port[rank][f"{strategy}/{mode}"]["combine"],
                                   _block(golden, rank, r), rtol=BAR[mode], atol=BAR[mode])
