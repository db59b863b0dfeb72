"""The port's serving slice against the JAX package on the CPU: the int8
Llama model on token-major pages (prefill, decode, caches) and LlamaEngine.

The JAX side runs its Pallas kernels in interpret mode (SKT_IMPL=pallas) and
is compiled with XLA's `xla_allow_excess_precision` off, so that it rounds to
bf16 wherever its code casts, as the port does in eager PyTorch. (With XLA's
default, fused bf16 intermediates stay in f32; the logits still agree within
the bound below, but about 40% of the written layer-1 int8 cache entries
then differ by up to 3.)
The port runs its plain PyTorch versions (device="cpu").
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sgl_kernel_npu_tpu import serving as jserving
from sgl_kernel_npu_tpu.models import llama as jl
from sgl_kernel_npu_tpu_torch import serving as tserving
from sgl_kernel_npu_tpu_torch.models import llama as tl
from sgl_kernel_npu_tpu_torch.runtime import NativeScheduler

from .utils import calc_diff

NO_EXCESS = {"xla_allow_excess_precision": False}
LOGITS_DIFF = 8e-3      # calc_diff bound of test_llama_model.py:376-377
# Greedy picks must clear, with room, the largest logit difference that the
# JAX package's default compile (excess precision on) shows against the port
# in the prefill/decode test's setting: 0.0122.
LOGIT_TOL = 0.02


def _jax_params(cfg, seed):
    jp = jl.init_params(cfg, seed)
    return jp, tl.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cache_match(jkv, tkv):
    """Rounding-boundary flips of 1 are the only allowed difference."""
    for name in ("k", "v"):
        a = np.asarray(jkv[name]).astype(np.int32)
        b = tkv[name].numpy().astype(np.int32)
        assert (a == b).mean() >= 0.999, (name, (a == b).mean())
        assert np.abs(a - b).max() <= 1, name
    for name in ("ks", "vs"):
        a, b = np.asarray(jkv[name]), tkv[name].numpy()
        assert (a == b).mean() >= 0.999, (name, (a == b).mean())


def test_prefill_then_decode_matches_jax(monkeypatch):
    """prefill_batch_step_kv (2 ragged chunks, one crossing a page) then two
    decode_step_kv steps on a padded batch of 4, each package on its own
    caches: logits within calc_diff 8e-3, int8 caches >= 99.9% exact with
    |diff| <= 1 (rounding-boundary flips only)."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    cfg = jl.tiny_config(int8_kv=True)
    jp, tp = _jax_params(cfg, 0)
    jpre = jax.jit(lambda p, kv, *a: jl.prefill_batch_step_kv(p, cfg, kv, *a),
                   compiler_options=NO_EXCESS)
    jdec = jax.jit(lambda p, kv, *a: jl.decode_step_kv(p, cfg, kv, *a),
                   compiler_options=NO_EXCESS)
    rng = np.random.default_rng(5)
    ps, pages, lens, s, t = cfg.page_size, 12, [21, 9], 2, 32
    bts = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    ids = np.zeros((s, t), np.int32)
    slp = np.full((s, t), -1, np.int32)
    pos = np.zeros((s, t), np.int32)
    for si, n in enumerate(lens):
        ids[si, :n] = rng.integers(0, cfg.vocab_size, n)
        pos[si, :n] = np.arange(n)
        slp[si, :n] = bts[si, np.arange(n) // ps] * ps + np.arange(n) % ps
    args = (ids, np.array(lens, np.int32), pos, slp, bts, np.zeros(s, np.int32))
    jkv = jl.init_kv_cache(cfg, pages, layout="tm")
    jlg, jkv = jpre(jp, jkv, *(jnp.asarray(a) for a in args))
    tkv = tl.init_kv_cache(cfg, pages, device="cpu")
    tlg, tkv2 = tl.prefill_batch_step_kv(tp, cfg, tkv, *(_t(a) for a in args))
    assert tkv2 is tkv and tlg.shape == (s, t, cfg.vocab_size)
    for si, n in enumerate(lens):
        assert calc_diff(tlg[si, :n].numpy(), np.asarray(jlg)[si, :n]) < LOGITS_DIFF
    _cache_match(jkv, tkv)

    b, cur = 4, list(lens)
    for _ in range(2):
        ids_d = np.zeros(b, np.int32)
        ids_d[:2] = rng.integers(0, cfg.vocab_size, 2)
        pos_d = np.array(cur + [0, 0], np.int32)
        seq = pos_d + np.array([1, 1, 1, 1], np.int32)
        bt = np.zeros((b, 4), np.int32)
        bt[:2] = bts
        sl = np.full(b, -1, np.int32)
        sl[:2] = [bts[i, c // ps] * ps + c % ps for i, c in enumerate(cur)]
        dargs = (ids_d, pos_d, seq, bt, sl)
        jlg, jkv = jdec(jp, jkv, *(jnp.asarray(a) for a in dargs))
        tlg, tkv = tl.decode_step_kv(tp, cfg, tkv, *(_t(a) for a in dargs))
        assert tlg.shape == (b, cfg.vocab_size) and tlg.dtype == torch.float32
        assert calc_diff(tlg[:2].numpy(), np.asarray(jlg)[:2]) < LOGITS_DIFF
        _cache_match(jkv, tkv)
        cur = [c + 1 for c in cur]


def _prompts(cfg):
    """Seed 17 of np.random.default_rng: chosen because none of its greedy
    picks below is a near-tie (every top-2 logit margin >= LOGIT_TOL; the
    bf16 logits of the tiny random model tie often)."""
    rng = np.random.default_rng(17)
    first = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (37, 21)]
    shared = first[0][:32] + rng.integers(0, cfg.vocab_size, 5).tolist()
    return first, shared


def _serve(engine, first, late, new_tokens):
    """Serve `first`; add `late` once first[0] is prefilled, so its 32-token
    prefix (2 pages) comes from the radix cache."""
    rids = [engine.add_request(p, new_tokens) for p in first]
    while not engine.reqs[rids[0]]["out"]:
        engine.step()
    rids.append(engine.add_request(late, new_tokens))
    while engine.step():
        pass
    return [engine.reqs[r]["out"] for r in rids], engine.reqs[rids[-1]]["cached"]


def test_engine_matches_jax_token_major_engine(monkeypatch):
    """LlamaEngine's greedy tokens equal the JAX token-major engine's, with
    chunked prefill (token budget 64), radix prefix reuse and a padded decode
    batch; batched serving equals serving each prompt alone, as
    tests/test_serving.py::test_engine_token_major_self_consistent asks of
    the JAX engine."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    cfg = jl.tiny_config(int8_kv=True)
    jp, tp = _jax_params(cfg, 0)
    first, late = _prompts(cfg)
    kw = dict(num_pages=64, decode_batch=4, token_budget=64)

    je = jserving.LlamaEngine(cfg, params=jp, **kw)
    assert je.kv["k"].ndim == 4, "the JAX int8 engine must pick tm pages"
    je._decode = jax.jit(lambda p, kv, i, po, sl, bt, sm, lid: jl.decode_step_kv(
        p, cfg, kv, i, po, sl, bt, sm), compiler_options=NO_EXCESS)
    je._prefill_batch = jax.jit(
        lambda p, kv, i, vl, po, sm, bts, pl, lid: jl.prefill_batch_step_kv(
            p, cfg, kv, i, vl, po, sm, bts, pl), compiler_options=NO_EXCESS)
    want, jreused = _serve(je, first, late, 6)

    te = tserving.LlamaEngine(cfg, params=tp, device="cpu", **kw)
    assert isinstance(te.sched, NativeScheduler)
    margins = []
    inner_pre, inner_dec = te._prefill_batch, te._decode

    def prefill(*a):
        logits, kv = inner_pre(*a)
        for si in range(int((a[1] > 0).sum())):
            top = logits[si, int(a[1][si]) - 1].topk(2).values
            margins.append(float(top[0] - top[1]))
        return logits, kv

    def decode(*a):
        logits, kv = inner_dec(*a)
        for i in range(int((a[4] >= 0).sum())):
            top = logits[i].topk(2).values
            margins.append(float(top[0] - top[1]))
        return logits, kv

    te._prefill_batch, te._decode = prefill, decode
    got, reused = _serve(te, first, late, 6)
    assert reused == jreused == 32
    assert all(len(o) == 6 for o in got)
    assert min(margins) >= LOGIT_TOL, min(margins)
    assert got == want

    for p, out in zip(first + [late], got):
        solo = tserving.LlamaEngine(cfg, params=tp, device="cpu", **kw)
        assert solo.generate([p], max_new_tokens=6)[0] == out
