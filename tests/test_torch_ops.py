"""Parity of the PyTorch port's ops with the JAX package on the CPU.

The same numpy inputs go to both packages. The JAX side runs its Pallas
kernels in interpret mode (SKT_IMPL=pallas) and its glue compiled, as the
model runs it; the port runs its plain PyTorch versions (CPU tensors). The
CUDA kernels themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.models import llama as jl
from sgl_kernel_npu_tpu.ops import matmul as jmm
from sgl_kernel_npu_tpu.ops import quant as jquant
from sgl_kernel_npu_tpu.ops import rope as jrope
from sgl_kernel_npu_tpu.ops.attention import decode_v8 as jv8
from sgl_kernel_npu_tpu_torch import runtime as truntime
from sgl_kernel_npu_tpu_torch.models import llama as tl
from sgl_kernel_npu_tpu_torch.ops import matmul as tmm
from sgl_kernel_npu_tpu_torch.ops import quant as tquant
from sgl_kernel_npu_tpu_torch.ops import rope as trope
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v8 as tv8
from sgl_kernel_npu_tpu_torch.utils import resolve_device, use_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.array(_np(a)))


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, _t(j).to(torch.bfloat16)


def _port_sources():
    pkg = os.path.join(ROOT, "sgl_kernel_npu_tpu_torch")
    for base, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "sgl_kernel_npu_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} {name}")
    assert not bad, bad


def test_wrappers_choose_by_tensor_device():
    assert not use_kernel(torch.zeros(1))
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            tl.init_kv_cache(tl.tiny_config(int8_kv=True), 4)


@pytest.mark.parametrize("shape", [(5, 64), (3, 7, 256)])
def test_per_token_quant_matches_jax(shape):
    """Bit-exact int8 values and scales against the compiled JAX quant."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 3
    jx, tx = _bf16(x)
    jq, js = jax.jit(jquant.per_token_quant_int8)(jx)
    tq, ts = tquant.per_token_quant_int8(tx)
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    d = 32
    cs = jrope.make_cos_sin_cache(64, d, 500000.0)
    tcs = trope.make_cos_sin_cache(64, d, 500000.0, device="cpu")
    assert np.abs(np.asarray(cs) - tcs.numpy()).max() < 1e-6
    pos = rng.integers(0, 64, 9)
    x = rng.standard_normal((9, 4, d)).astype(np.float32)
    jx, tx = _bf16(x)
    c = cs[pos]
    jo = jax.jit(jrope.apply_rope)(jx, c[:, None, : d // 2], c[:, None, d // 2:])
    tc = _t(c)
    to = trope.apply_rope(tx, tc[:, None, : d // 2], tc[:, None, d // 2:])
    assert to.dtype == torch.bfloat16
    assert np.array_equal(_np(jo), to.float().numpy())


@pytest.mark.parametrize("m", [3, 8, 64])
def test_quant_matmul_int8_stacked_matches_jax(monkeypatch, m):
    """Kernel A's contract: the JAX stacked GEMM (Pallas grouped kernel for
    m >= 8, its reference below) equals the port's plain version exactly —
    int32 accumulation is exact and the epilogue multiplies in one order."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(m)
    layers, k, n = 3, 256, 384
    w = rng.integers(-127, 128, (layers, k, n), dtype=np.int8)
    ws = (rng.random((layers, n)) * 1e-3).astype(np.float32)
    xq = rng.integers(-128, 128, (m, k), dtype=np.int8)
    xs = (rng.random((m, 1)) * 0.05).astype(np.float32)
    for li in (0, 2):
        ref = jmm.quant_matmul_int8_stacked(jnp.asarray(xq), jnp.asarray(w),
                                            jnp.int32(li), jnp.asarray(xs),
                                            jnp.asarray(ws))
        out = tmm.quant_matmul_int8_stacked(_t(xq), _t(w), li, _t(xs), _t(ws))
        assert out.dtype == torch.bfloat16 and out.shape == (m, n)
        assert np.array_equal(_np(ref), out.float().numpy()), li


def test_init_params_bit_identical_and_params_from_jax_round_trip():
    cfg = jl.tiny_config(int8_kv=True)
    jp = jl.init_params(cfg, 3)
    tp = tl.init_params(tl.tiny_config(int8_kv=True), 3, "cpu")
    jflat = jax.tree_util.tree_leaves_with_path(jp)
    tcarried = tl.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for path, leaf in jflat:
        keys = [p.key for p in path]
        t_own, t_carried = tp, tcarried
        for key in keys:
            t_own, t_carried = t_own[key], t_carried[key]
        assert tuple(t_own.shape) == leaf.shape, keys
        assert str(t_carried.dtype).split(".")[-1] == str(leaf.dtype), keys
        assert np.array_equal(t_carried.float().numpy(), _np(leaf).astype(np.float32)), keys
        if keys == ["cos_sin"]:
            assert np.abs(t_own.numpy() - _np(leaf)).max() < 1e-6
        else:       # int8 banks, scales, bf16 embed and norms: bit-identical
            assert t_own.dtype == t_carried.dtype, keys
            assert torch.equal(t_own, t_carried), keys


def test_quant_rows_int8_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 6, 4, 32)).astype(np.float32)
    y = np.random.default_rng(3).standard_normal((2, 6, 4, 32)).astype(np.float32)
    (jk, tk), (jv, tv) = _bf16(x), _bf16(y)
    jout = jax.jit(jv8.quant_rows_int8)(jk, jv)
    tout = tv8.quant_rows_int8(tk, tv)
    for a, b in zip(jout, tout):
        assert np.array_equal(np.asarray(a), b.numpy())


def _tm_cache(rng, layers, pages, rows, d):
    kc = rng.integers(-127, 128, (layers, pages, rows, d), dtype=np.int8)
    vc = rng.integers(-127, 128, (layers, pages, rows, d), dtype=np.int8)
    ks = rng.random((layers, pages, 1, rows)).astype(np.float32)
    vs = rng.random((layers, pages, 1, rows)).astype(np.float32)
    return kc, vc, ks, vs


def test_decode_append_and_scales_match_jax(monkeypatch):
    """Kernel D's contract plus the decode scale update: exact int8 pages and
    exact scales, with a dropped (slot -1 -> page sentinel P) row."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(4)
    layers, b, hkv, d, ps, pages = 2, 4, 4, 32, 16, 10
    kc, vc, ks, vs = _tm_cache(rng, layers, pages, ps * hkv, d)
    kq = rng.integers(-127, 128, (layers, b, hkv, d), dtype=np.int8)
    vq = rng.integers(-127, 128, (layers, b, hkv, d), dtype=np.int8)
    ksn = rng.random((layers * b, hkv)).astype(np.float32)
    vsn = rng.random((layers * b, hkv)).astype(np.float32)
    pages_b = np.array([3, pages, 0, 7], np.int32)      # row 1 is dropped
    offs_b = np.array([5, 0, ps - 1, 0], np.int32)

    jk, jv_ = jv8.append_tm_int8_pallas(*(jnp.asarray(a) for a in
                                          (kq, vq, kc, vc, pages_b, offs_b)))
    jks, jvs = jv8.scatter_scales_tm(*(jnp.asarray(a) for a in
                                       (ks, vs, ksn, vsn, pages_b, offs_b)))
    tk, tv_, tks, tvs = _t(kc), _t(vc), _t(ks), _t(vs)
    out = tv8.append_tm_int8(_t(kq), _t(vq), tk, tv_, _t(pages_b), _t(offs_b))
    assert out[0] is tk and out[1] is tv_          # in place
    tv8.scatter_scales_tm(tks, tvs, _t(ksn), _t(vsn), _t(pages_b), _t(offs_b))
    for a, b_ in ((jk, tk), (jv_, tv_), (jks, tks), (jvs, tvs)):
        assert np.array_equal(np.asarray(a), b_.numpy())
    assert not np.array_equal(kc, tk.numpy())


def test_prefill_scales_match_jax_and_pad_entries_claim_nothing():
    """The prefill scale update writes exactly the JAX version's slots: live
    chunk tokens only, so pad block-table entries (0, the id of a real page
    holding sequence 1's cached prefix) and an empty chunk change nothing."""
    rng = np.random.default_rng(5)
    layers, hkv, ps, pages, t = 2, 4, 16, 10, 20
    ks = rng.random((layers, pages, 1, ps * hkv)).astype(np.float32)
    vs = rng.random((layers, pages, 1, ps * hkv)).astype(np.float32)
    ksn = rng.random((layers, 3, t, hkv)).astype(np.float32)
    vsn = rng.random((layers, 3, t, hkv)).astype(np.float32)
    bts = np.array([[4, 8, 6, 0], [0, 5, 2, 0], [0, 1, 0, 0]], np.int32)
    plens = np.array([ps - 3, ps, 3], np.int32)
    vlens = np.array([t, 17, 0], np.int32)
    args = (ks, vs, ksn, vsn, bts, plens, vlens)
    jks, jvs = jv8.scatter_scales_prefill_tm(*(jnp.asarray(a) for a in args))
    tks, tvs = _t(ks), _t(vs)
    tv8.scatter_scales_prefill_tm(tks, tvs, *(_t(a) for a in args[2:]))
    assert np.array_equal(np.asarray(jks), tks.numpy())
    assert np.array_equal(np.asarray(jvs), tvs.numpy())
    assert np.array_equal(tks.numpy()[:, 0], ks[:, 0])      # page 0 untouched


def test_prefill_append_matches_jax(monkeypatch):
    """Kernel D at a prefill chunk: many rows per page, padded rows dropped."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(6)
    layers, hkv, d, ps, pages = 2, 4, 32, 16, 8
    kc, vc, _, _ = _tm_cache(rng, layers, pages, ps * hkv, d)
    slots = np.array([2 * ps + i for i in range(ps)] + [5 * ps, 5 * ps + 1]
                     + [-1] * 6, np.int32)
    n = slots.shape[0]
    kq = rng.integers(-127, 128, (layers, n, hkv, d), dtype=np.int8)
    vq = rng.integers(-127, 128, (layers, n, hkv, d), dtype=np.int8)
    pg = np.where(slots >= 0, slots // ps, pages).astype(np.int32)
    off = np.where(slots >= 0, slots % ps, 0).astype(np.int32)
    jk, jv_ = jv8.append_tm_int8_pallas(*(jnp.asarray(a) for a in
                                          (kq, vq, kc, vc, pg, off)))
    tk, tv_ = _t(kc), _t(vc)
    tv8.append_tm_int8(_t(kq), _t(vq), tk, tv_, _t(pg), _t(off))
    assert np.array_equal(np.asarray(jk), tk.numpy())
    assert np.array_equal(np.asarray(jv_), tv_.numpy())


@pytest.mark.parametrize("case", ["decode rows over page edges", "prefill chunk over a page edge"])
def test_append_over_page_edges_matches_jax(monkeypatch, case):
    """Kernel D's plain version at L 4 against the interpreted JAX kernel,
    exact: rows in the last and first slots of pages (decode), and a chunk
    whose consecutive slots run from one page into the next with padded rows
    between live ones (prefill)."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(7)
    layers, hkv, d, ps, pages = 4, 8, 16, 8, 12
    kc, vc, _, _ = _tm_cache(rng, layers, pages, ps * hkv, d)
    if case.startswith("decode"):
        pg = np.array([3, 4, pages, 9, 10], np.int32)
        off = np.array([ps - 1, 0, 0, ps - 1, 0], np.int32)
    else:
        slots = np.array([5 * ps + 5, 5 * ps + 6, 5 * ps + 7, -1, 2 * ps, 2 * ps + 1, -1,
                          2 * ps + 2, 11 * ps + ps - 1], np.int32)
        pg = np.where(slots >= 0, slots // ps, pages).astype(np.int32)
        off = np.where(slots >= 0, slots % ps, 0).astype(np.int32)
    n = pg.shape[0]
    kq = rng.integers(-127, 128, (layers, n, hkv, d), dtype=np.int8)
    vq = rng.integers(-127, 128, (layers, n, hkv, d), dtype=np.int8)
    jk, jv_ = jv8.append_tm_int8_pallas(*(jnp.asarray(a) for a in (kq, vq, kc, vc, pg, off)))
    tk, tv_ = _t(kc), _t(vc)
    tv8.append_tm_int8(_t(kq), _t(vq), tk, tv_, _t(pg), _t(off))
    assert np.array_equal(np.asarray(jk), tk.numpy())
    assert np.array_equal(np.asarray(jv_), tv_.numpy())
    live = pg < pages
    rows = tk.numpy().reshape(layers, pages, ps, hkv, d)[:, pg[live], off[live]]
    assert np.array_equal(rows, kq[:, live])


def test_native_scheduler_matches_python_twin():
    """The port's ctypes scheduler (csrc/runtime.cpp, built into
    build/torch_kernels/) against its pure-Python golden."""
    ps = 4
    scheds = [truntime.NativeScheduler(12, ps, token_budget=10),
              truntime.PyScheduler(12, ps, token_budget=10)]
    prompt = list(range(11))
    logs = []
    for s in scheds:
        log = []
        rids = [s.add_request(prompt, 3), s.add_request([7, 7, 7, 7, 7], 2)]
        pages = [s.alloc_pages(4), s.alloc_pages(2)]
        log.append((pages, s.free_pages()))
        for rid in rids:
            s.activate_request(rid)
        for _ in range(6):
            entries = s.schedule_step()
            log.append([(e["kind"], e["start"], e["len"]) for e in entries])
            for e in entries:
                s.commit_progress(e["req_id"], e["kind"], e["len"])
        s.insert_prefix(prompt[:8], pages[0][:2])
        log.append(s.match_prefix(prompt[:9]))
        for rid, pg in zip(rids, pages):
            s.finish_request(rid)
            s.release_pages(pg)
        log.append((s.free_pages(), s.num_requests(), s.alloc_pages(11)))
        logs.append(log)
    assert logs[0] == logs[1]
