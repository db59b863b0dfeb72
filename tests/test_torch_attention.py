"""Parity of the port's token-major attention with the JAX package on the CPU.

Kernel B's module (paged_prefill_tm) and kernel C's module (decode_v9): the
same numpy inputs go to the JAX Pallas kernels in interpret mode and to the
port's plain PyTorch versions. Tolerance atol 3e-2 (rtol 1e-2), that of
tests/test_decode_attention.py::test_decode_v9_chunked_matches_v8: outputs of
a few units in bf16, whose last place there is 2**-6..2**-5, and P.V summed
in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.ops.attention import decode_v9 as jv9
from sgl_kernel_npu_tpu.ops.attention import paged_prefill_tm as jpp
from sgl_kernel_npu_tpu_torch.ops.attention import decode_v9 as tv9
from sgl_kernel_npu_tpu_torch.ops.attention import paged_prefill_tm as tpp

from .utils import assert_close

ATOL = 3e-2


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.array(_np(a)))


def _bf16(rng, shape):
    j = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    return j, _t(j).to(torch.bfloat16)


def _tm_cache(rng, layers, pages, rows, d):
    kc = rng.integers(-127, 128, (layers, pages, rows, d), dtype=np.int8)
    vc = rng.integers(-127, 128, (layers, pages, rows, d), dtype=np.int8)
    ks = (rng.random((layers, pages, 1, rows)) * .05).astype(np.float32)
    vs = (rng.random((layers, pages, 1, rows)) * .05).astype(np.float32)
    return kc, vc, ks, vs


_BT16 = ((1, 2, 0, 0), (3, 4, 5, 0), (6, 7, 0, 0), (8, 9, 10, 11))


@pytest.mark.parametrize("hq,hkv,ps,plens,vlens,bts", [
    pytest.param(8, 4, 16, (0, 15, 16, 35), (20, 13, 1, 7), _BT16, id="8-4"),
    pytest.param(8, 2, 16, (0, 15, 16, 35), (20, 13, 1, 7), _BT16, id="8-2"),
    # the engine's GQA ratio (Llama-3-8B's 32 / 8) at its page sizes, prefixes
    # around kernel B's 64-key tile, and a chunk with no valid token; block
    # tables drawn from the seed
    pytest.param(8, 2, 64, (0, 63, 64, 200), (20, 13, 0, 7), None, id="g4-ps64"),
    pytest.param(8, 2, 128, (0, 63, 64, 200), (20, 0, 1, 20), None, id="g4-ps128"),
])
def test_prefill_tm_matches_jax(monkeypatch, hq, hkv, ps, plens, vlens, bts):
    """Kernel B's contract, all sequences in one batched call of the port
    against one JAX call per sequence: cached prefixes (0, ps-1, ps, 2ps+3 at
    ps 16) and ragged valid lengths (a full chunk, a partial one, one token,
    a short one, none), over layer 1 of a 2-layer cache."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    rng = np.random.default_rng(hq * 10 + hkv)
    d, layers, t, li = 32, 2, 20, 1
    mp = len(bts[0]) if bts else -(-(max(plens) + t) // ps)
    pages = 16 if bts else 4 * mp + 1
    kc, vc, ks, vs = _tm_cache(rng, layers, pages, ps * hkv, d)
    plens = np.array(plens, np.int32)
    vlens = np.array(vlens, np.int32)
    bts = (np.array(bts, np.int32) if bts else
           (rng.permutation(pages - 1)[: 4 * mp].reshape(4, mp) + 1).astype(np.int32))
    jq, tq = _bf16(rng, (4, t, hq, d))
    jk, tk = _bf16(rng, (4, t, hkv, d))
    jv, tv = _bf16(rng, (4, t, hkv, d))
    sm = 1.0 / np.sqrt(d)
    cache = [jnp.asarray(a) for a in (kc, vc, ks, vs)]
    want = np.stack([_np(jpp.paged_prefill_attention_tm(
        jq[s], jk[s], jv[s], *cache, jnp.asarray(bts[s]), jnp.int32(plens[s]),
        sm, ps, layer_idx=li, valid_len=jnp.int32(vlens[s]))) for s in range(4)])
    got = tpp.paged_prefill_attention_tm(
        tq, tk, tv, _t(kc), _t(vc), _t(ks), _t(vs), _t(bts), _t(plens),
        _t(vlens), sm, ps, layer_idx=li)
    assert got.dtype == torch.bfloat16 and got.shape == (4, t, hq, d)
    assert_close(got.float().numpy(), want, atol=ATOL, name="prefill_tm")


@pytest.mark.parametrize("hq,hkv,cp", [(16, 4, 2), (8, 2, 4)])
def test_decode_tm_matches_jax(monkeypatch, hq, hkv, cp):
    """Kernel C's contract at chunk-boundary cached lengths (0, 2 chunks of
    cp pages, a page past 4 plus 4, one short of 3 pages) for both layers."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    monkeypatch.setattr(tv9, "CHUNK_PAGES", cp)
    rng = np.random.default_rng(hq + cp)
    b, d, ps, mp, pages = 4, 32, 16, 5, 24
    kc, vc, ks, vs = _tm_cache(rng, 2, pages, ps * hkv, d)
    cached = np.array([0, 2 * ps, 4 * ps + 4, 3 * ps - 1], np.int32)
    bt = (rng.permutation(pages - 1)[: b * mp].reshape(b, mp) + 1).astype(np.int32)
    jq, tq = _bf16(rng, (b, hq, d))
    jk, tk = _bf16(rng, (b, hkv, d))
    jv, tv = _bf16(rng, (b, hkv, d))
    sm = 1.0 / np.sqrt(d)
    for li in (0, 1):
        want = jv9.decode_gqa_pallas_v9_int8_defer(
            jq, jk, jv, *(jnp.asarray(a) for a in (kc, vc, ks, vs, cached, bt)),
            sm, ps, layer_idx=li, chunk_pages=cp)
        got = tv9.decode_gqa_v9_int8_defer(
            tq, tk, tv, *(_t(a) for a in (kc, vc, ks, vs, cached, bt)), sm, ps,
            layer_idx=li)
        assert got.dtype == torch.bfloat16 and got.shape == (b, hq, d)
        assert_close(got.float().numpy(), _np(want), atol=ATOL, name=f"layer {li}")
