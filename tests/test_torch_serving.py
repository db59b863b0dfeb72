"""The rest of the port's Llama serving surface against the JAX package on
the CPU: the step functions (llama.decode_step, prefill_step,
prefill_chunk_step and prefill_chunk_step_kv on tm, bf16 hm and int8 hm
pages), ops/kvcache.py's remaining helpers and MlaEngine's share of the
engines' surface; LlamaEngine's sampling, grammar bitmasks, stop tokens,
multi-LoRA and pause / resume against the JAX engines are in
tests/test_torch_serving_llama.py.

As in tests/test_torch_llama.py, the JAX side runs its Pallas kernels
interpreted (SKT_IMPL=pallas) and is compiled with
`xla_allow_excess_precision` off; the port runs its plain versions
(device="cpu"). Tolerances: logits calc_diff < 8e-3 (the repo's bound);
bf16 caches bit-equal (prefill_step's: >= 90% bit-equal and calc_diff <
1e-5, as XLA's approximate f32 rsqrt puts a row's RMSNorm an ulp off now
and then, and the flip carries into later layers' rows); int8 caches >=
99.9% bit-equal with |diff| <= 1 (rounding-boundary flips); the allocator
helpers exact; the engines' tokens equal, each model call's live logits
within calc_diff 8e-3.
Sampling draws from the port's own generator, so a sampled engine is held
to itself: one seed repeats its tokens, and top_k 1 gives the greedy ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.models import deepseek_mla as jdm
from sgl_kernel_npu_tpu.models import llama as jl
from sgl_kernel_npu_tpu.ops import kvcache as jkvc
from sgl_kernel_npu_tpu_torch import serving as tserving
from sgl_kernel_npu_tpu_torch.models import deepseek_mla as tdm
from sgl_kernel_npu_tpu_torch.models import llama as tl
from sgl_kernel_npu_tpu_torch.ops import kvcache as tkvc

from .test_torch_hm_model import _cache_match, _seeded_cache, _t
from .test_torch_llama import NO_EXCESS, _jax_params, _prompts
from .test_torch_serving_llama import _even_mask, _run
from .utils import calc_diff

LOGITS_DIFF = 8e-3
PAGES = 12


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("SKT_IMPL", "pallas")


def _cache_eq(jkv, tkv):
    """bf16 caches bit-equal; int8 ones within rounding-boundary flips."""
    if isinstance(tkv, tuple):
        _cache_match(jkv, tkv)
        return
    for name in ("k", "v"):
        a = np.asarray(jkv[name]).astype(np.int32)
        b = tkv[name].numpy().astype(np.int32)
        assert (a == b).mean() >= 0.999 and np.abs(a - b).max() <= 1, name
    for name in ("ks", "vs"):
        assert (np.asarray(jkv[name]) == tkv[name].numpy()).mean() >= 0.999, name


# ------------------------------------------------------------ step functions


def test_decode_step_matches_jax():
    """Three decode_step calls (the bf16 tuple wrapper) on seeded hm pages,
    a batch of 4 with a padded row: logits within calc_diff 8e-3, caches
    bit-equal."""
    cfg = jl.tiny_config()
    jp, tp = _jax_params(cfg, 0)
    rng = np.random.default_rng(31)
    kv0 = _seeded_cache(cfg, rng)
    jk, jv = (jnp.asarray(a) for a in kv0)
    tk, tv = tl.kv_from_jax(kv0, "cpu")
    jdec = jax.jit(lambda p, kc, vc, *a: jl.decode_step(p, cfg, kc, vc, *a),
                   compiler_options=NO_EXCESS)
    ps, b = cfg.page_size, 4
    bt = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [0, 0, 0]], np.int32)
    pos = np.array([14, 15, 31, 0], np.int32)
    for _ in range(3):
        ids = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
        slots = (bt[np.arange(b), pos // ps] * ps + pos % ps).astype(np.int32)
        slots[3] = -1
        args = (ids, pos, pos + 1, bt, slots)
        jlg, jk, jv = jdec(jp, jk, jv, *(jnp.asarray(a) for a in args))
        tlg, tk2, tv2 = tl.decode_step(tp, cfg, tk, tv, *(_t(a) for a in args))
        assert tk2 is tk and tv2 is tv
        assert calc_diff(tlg[:3].numpy(), np.asarray(jlg)[:3]) < LOGITS_DIFF
        _cache_eq((jk, jv), (tk, tv))
        pos = pos + np.array([1, 1, 1, 0], np.int32)


@pytest.mark.parametrize("t", [1, 19, 40])
def test_prefill_step_matches_jax(t):
    """prefill_step: T tokens attending causally to each other only, each
    layer's rows written at their slots (crossing pages)."""
    cfg = jl.tiny_config()
    jp, tp = _jax_params(cfg, 0)
    rng = np.random.default_rng(t)
    kv0 = _seeded_cache(cfg, rng)
    ps = cfg.page_size
    bt = np.array([3, 7, 1, 9], np.int32)
    pos = np.arange(t, dtype=np.int32)
    slots = (bt[pos // ps] * ps + pos % ps).astype(np.int32)
    ids = rng.integers(0, cfg.vocab_size, t).astype(np.int32)
    args = (ids, pos, slots)
    jpre = jax.jit(lambda p, kc, vc, *a: jl.prefill_step(p, cfg, kc, vc, *a, jnp.int32(0)),
                   compiler_options=NO_EXCESS)
    jlg, jk, jv = jpre(jp, *(jnp.asarray(a) for a in kv0 + args))
    tk, tv = tl.kv_from_jax(kv0, "cpu")
    tlg, _, _ = tl.prefill_step(tp, cfg, tk, tv, *(_t(a) for a in args))
    assert tlg.shape == (t, cfg.vocab_size) and tlg.dtype == torch.float32
    assert calc_diff(tlg.numpy(), np.asarray(jlg)) < LOGITS_DIFF
    for j, c in ((jk, tk), (jv, tv)):
        a, b = np.asarray(j).astype(np.float32), c.float().numpy()
        assert (a == b).mean() >= 0.9 and calc_diff(a, b) < 1e-5


@pytest.mark.parametrize("layout", ["tm", "hm_bf16", "hm_int8"])
@pytest.mark.parametrize("prefix,t", [(0, 21), (13, 20), (32, 16)])
def test_prefill_chunk_step_kv_matches_jax(layout, prefix, t):
    """prefill_chunk_step_kv: a chunk of T tokens after `prefix` cached ones
    (seeded rows; on and off a page edge), tm pages through the batched
    prefill, hm pages through K15's plain version; bf16 hm also through the
    prefill_chunk_step tuple wrapper."""
    int8 = layout != "hm_bf16"
    cfg = jl.tiny_config(int8_kv=int8)
    jp, tp = _jax_params(cfg, 0)
    rng = np.random.default_rng(prefix + t)
    if layout == "tm":
        kv0 = jax.tree.map(np.asarray, jl.init_kv_cache(cfg, PAGES, layout="tm"))
        kv0 = {k: (rng.integers(-127, 128, a.shape, dtype=np.int8) if a.dtype == np.int8
                   else rng.random(a.shape, dtype=np.float32) * 0.02 + 0.005)
               for k, a in kv0.items()}
    else:
        kv0 = _seeded_cache(cfg, rng)
    ps = cfg.page_size
    bt = np.array([2, 5, 1, 8, 0], np.int32)
    pos = prefix + np.arange(t, dtype=np.int32)
    slots = (bt[pos // ps] * ps + pos % ps).astype(np.int32)
    ids = rng.integers(0, cfg.vocab_size, t).astype(np.int32)
    args = (ids, pos, slots, bt)
    jfn = jax.jit(lambda p, kv, *a: jl.prefill_chunk_step_kv(p, cfg, kv, *a),
                  compiler_options=NO_EXCESS)
    jlg, jkv = jfn(jp, jax.tree.map(jnp.asarray, kv0), *(jnp.asarray(a) for a in args),
                   jnp.int32(prefix))
    tkv = tl.kv_from_jax(kv0, "cpu")
    if layout == "hm_bf16":
        tlg, tk, tv = tl.prefill_chunk_step(tp, cfg, *tkv, *(_t(a) for a in args), prefix)
        assert tk is tkv[0] and tv is tkv[1]
    else:
        tlg, tkv2 = tl.prefill_chunk_step_kv(tp, cfg, tkv, *(_t(a) for a in args),
                                             torch.tensor(prefix, dtype=torch.int32))
        assert tkv2 is tkv
    assert tlg.shape == (t, cfg.vocab_size)
    assert calc_diff(tlg.numpy(), np.asarray(jlg)) < LOGITS_DIFF
    _cache_eq(jkv, tkv)


# ------------------------------------------------------------ kvcache helpers


@pytest.mark.parametrize("case", range(4))
def test_alloc_extend_matches_jax(case):
    rng = np.random.default_rng(case)
    ps, bs = [4, 16, 128, 8][case], [1, 3, 5, 4][case]
    pre = rng.integers(0, 3 * ps, bs).astype(np.int32)
    seq = (pre + rng.integers(0, 3 * ps, bs)).astype(np.int32)
    pages_used = -(-pre // ps)
    last_loc = np.array([rng.integers(0, 50) * ps + (p - 1) % ps if p else -1
                         for p in pre], np.int32)
    free = rng.permutation(np.arange(60, 200)).astype(np.int32)
    out = int(seq.sum() - pre.sum()) + 5
    j = jkvc.alloc_extend(*(jnp.asarray(a) for a in (pre, seq, last_loc, free)), ps, out)
    t = tkvc.alloc_extend(*(torch.from_numpy(a) for a in (pre, seq, last_loc, free)), ps, out)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    assert int(t[1]) == int(j[1]) and pages_used.size == bs


@pytest.mark.parametrize("case", range(3))
def test_cache_loc_assign_and_assign_cache_op_match_jax(case):
    rng = np.random.default_rng(10 + case)
    pool = rng.integers(0, 1000, (6, 40)).astype(np.int32)
    req = np.array([[4, 0, 2], [1, 5], [3]][case], np.int32)
    start = rng.integers(0, 20, req.size).astype(np.int32)
    end = (start + rng.integers(0, 15, req.size)).astype(np.int32)
    n = int((end - start).sum()) + 3
    loc = rng.integers(0, 10 ** 6, n).astype(np.int32)
    for name in ("cache_loc_assign", "cache_loc_update"):
        j = getattr(jkvc, name)(*(jnp.asarray(a) for a in (req, pool, start, end, loc)))
        t = getattr(tkvc, name)(*(torch.from_numpy(a.copy()) for a in (req, pool, start, end,
                                                                         loc)))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    dst = rng.standard_normal((30, 5)).astype(np.float32)
    src = rng.standard_normal((25, 5)).astype(np.float32)
    bounds = [(3, 11, 7, 15), (20, 30, 0, 10), (26, 34, 2, 10), (5, 5, 0, 0)][case:case + 2]
    for b in bounds:
        j = jkvc.assign_cache_op(jnp.asarray(dst), jnp.asarray(src), *(jnp.int32(v) for v in b))
        t = tkvc.assign_cache_op(torch.from_numpy(dst.copy()), torch.from_numpy(src), *b)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_transfer_kv_round_trip_matches_jax():
    """transfer_kv_to_host swaps the layer and page dims as the JAX function
    does; transfer_kv_to_device restores the cache bit for bit."""
    a = np.asarray(jnp.asarray(np.random.default_rng(2).standard_normal((3, 5, 4, 8, 16)),
                               jnp.bfloat16))
    host = tkvc.transfer_kv_to_host(_t(a))
    assert host.device.type == "cpu" and host.shape == (5, 3, 4, 8, 16)
    np.testing.assert_array_equal(host.float().numpy(),
                                  np.asarray(jkvc.transfer_kv_to_host(jnp.asarray(a)))
                                  .astype(np.float32))
    back = tkvc.transfer_kv_to_device(host, like=_t(a))
    assert torch.equal(back, _t(a))
    assert torch.equal(tkvc.transfer_kv_to_device(host, device="cpu"), _t(a))


def test_reshape_and_cache_gqa_int8_matches_jax():
    """The int8 head-major scatter (slots across pages, one -1) against the
    compiled JAX function: int8 rows and f32 scales bit-equal."""
    rng = np.random.default_rng(4)
    hkv, pages, ps, d, t = 4, 6, 8, 32, 11
    k = np.asarray(jnp.asarray(rng.standard_normal((t, hkv, d)), jnp.bfloat16))
    v = np.asarray(jnp.asarray(rng.standard_normal((t, hkv, d)) * 3, jnp.bfloat16))
    caches = (rng.integers(-127, 128, (hkv, pages, ps, d), dtype=np.int8),
              rng.integers(-127, 128, (hkv, pages, ps, d), dtype=np.int8),
              rng.random((hkv, pages, 1, ps), dtype=np.float32),
              rng.random((hkv, pages, 1, ps), dtype=np.float32))
    slots = rng.permutation(pages * ps)[:t].astype(np.int32)
    slots[4] = -1
    j = jax.jit(jkvc.reshape_and_cache_gqa_int8)(
        *(jnp.asarray(a) for a in (k, v) + caches + (slots,)))
    tc = tuple(torch.from_numpy(a.copy()) for a in caches)
    out = tkvc.reshape_and_cache_gqa_int8(_t(k), _t(v), *tc, torch.from_numpy(slots))
    for o, c, jj in zip(out, tc, j):
        assert o is c
        np.testing.assert_array_equal(c.numpy(), np.asarray(jj))


def test_mla_engine_pause_resume_bitmask_and_lora_ids():
    """MlaEngine inherits pause / resume, the bitmask and sampling, and
    drops adapter ids as the JAX MlaEngine does: a paused and resumed
    request equals the uninterrupted run; a masked request picks even ids;
    a lora_id changes nothing."""
    cfg = jdm.tiny_config()
    tp = tdm.params_from_jax(jax.tree.map(np.asarray, jdm.init_params(cfg, 0)), "cpu")
    first, late = _prompts(cfg)
    kw = dict(num_pages=16, decode_batch=2, token_budget=32)

    def engine():
        return tserving.MlaEngine(cfg, params=tp, device="cpu", **kw)

    plain = engine().generate([first[1]], max_new_tokens=6)[0]
    eng = engine()
    rid = eng.add_request(first[1], 6)
    while len(eng.reqs[rid]["out"]) < 2:
        eng.step()
    eng.pause_request(rid)
    eng.add_request(late, 3)
    new = eng.resume_request(rid)
    while eng.step():
        pass
    assert eng.reqs[new]["out"] == plain
    masked, tagged = _run(engine(), [(first[1], dict(max_new_tokens=6,
                                                     token_bitmask=_even_mask(cfg.vocab_size))),
                                     (first[1], dict(max_new_tokens=6, lora_id=1))])[0]
    assert all(tok % 2 == 0 for tok in masked)
    assert tagged == plain
