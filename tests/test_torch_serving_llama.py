"""The port's LlamaEngine serving surface against the JAX engines on the CPU,
on tm and hm pages: multi-LoRA, grammar bitmasks and stop tokens, pause /
resume and seeded sampling (moved from tests/test_torch_serving.py, which
keeps the step functions, ops/kvcache.py's helpers and MlaEngine's share, so
that `--dist loadfile` spreads the two files over workers).

As in tests/test_torch_llama.py, the JAX side runs its Pallas kernels
interpreted (SKT_IMPL=pallas) and is compiled with
`xla_allow_excess_precision` off; the port runs its plain versions
(device="cpu"). Tolerances: the engines' tokens equal, each model call's
live logits within calc_diff 8e-3. Sampling draws from the port's own
generator, so a sampled engine is held to itself: one seed repeats its
tokens, and top_k 1 gives the greedy ones.
"""

import jax
import numpy as np
import pytest

from sgl_kernel_npu_tpu import serving as jserving
from sgl_kernel_npu_tpu.models import llama as jl
from sgl_kernel_npu_tpu_torch import serving as tserving
from sgl_kernel_npu_tpu_torch.models import llama as tl

from .test_torch_hm_model import _recording
from .test_torch_llama import NO_EXCESS, _jax_params, _prompts
from .utils import calc_diff

LOGITS_DIFF = 8e-3


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("SKT_IMPL", "pallas")


# ------------------------------------------------------------- the engines


def _engines(cfg, jp, tp, layout, lora=False, **kw):
    """A JAX engine whose steps compile without excess precision (and pass
    the adapter ids where the params carry adapters) and the port's engine,
    both recording every model call's live logits."""
    kw = dict(num_pages=64, decode_batch=4, token_budget=64, kv_layout=layout, **kw)
    je = jserving.LlamaEngine(cfg, params=jp, **kw)
    te = tserving.LlamaEngine(cfg, params=tp, device="cpu", **kw)
    jcalls, tcalls = [], []
    je._decode = _recording(jax.jit(
        lambda p, kv, i, po, sl, bt, sm, lid: jl.decode_step_kv(
            p, cfg, kv, i, po, sl, bt, sm, lora_ids=lid if lora else None),
        compiler_options=NO_EXCESS), jcalls, "decode", 2)
    je._prefill_batch = _recording(jax.jit(
        lambda p, kv, i, vl, po, sm, bts, pl, lid: jl.prefill_batch_step_kv(
            p, cfg, kv, i, vl, po, sm, bts, pl, lora_ids=lid if lora else None),
        compiler_options=NO_EXCESS), jcalls, "prefill", 2)
    te._prefill_batch = _recording(te._prefill_batch, tcalls, "prefill")
    te._decode = _recording(te._decode, tcalls, "decode")
    return je, te, jcalls, tcalls


def _calls_match(jcalls, tcalls):
    assert [k for k, _ in tcalls] == [k for k, _ in jcalls]
    for (kind, a), (_, b) in zip(tcalls, jcalls):
        assert a.shape == b.shape and calc_diff(a, b) < LOGITS_DIFF, kind


def _run(eng, requests):
    """Add the requests (prompt, kwargs), serve them to the end; their
    outputs and cached prefix lengths."""
    rids = [eng.add_request(p, **kw) for p, kw in requests]
    while eng.step():
        pass
    return [eng.reqs[r]["out"] for r in rids], [eng.reqs[r]["cached"] for r in rids]


LAYOUTS = {"tm": (True, None), "hm": (False, None)}


def _even_mask(v):
    bm = np.zeros((v + 31) // 32, np.uint32)
    for tok in range(0, v, 2):
        bm[tok // 32] |= np.uint32(1) << np.uint32(tok % 32)
    return bm.astype(np.int32)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_lora_matches_jax(layout):
    """Adapters rank 4 (2 of them): a base request, the same prompt with
    adapter 0 added once the first is prefilled (so its 32-token prefix is
    in the radix cache, and a LoRA request must not take it), and another
    prompt with adapter 1: tokens equal the JAX engine's, every call's
    logits too; the base request equals an engine without adapters."""
    int8, kv_layout = LAYOUTS[layout]
    cfg = jl.tiny_config(int8_kv=int8)
    jp, tp = _jax_params(cfg, 0)
    jp = jl.add_lora_adapters(jp, cfg, num_adapters=2, rank=4, seed=3, scale=0.3)
    tp_l = tl.add_lora_adapters(tp, cfg, num_adapters=2, rank=4, seed=3, scale=0.3)
    first, _ = _prompts(cfg)
    outs = {}
    for name, eng_ in zip(("jax", "port"), _engines(cfg, jp, tp_l, kv_layout, lora=True)[:2]):
        r0 = eng_.add_request(first[0], 6)
        r2 = eng_.add_request(first[1], 6, lora_id=1)
        while not eng_.reqs[r0]["out"]:
            eng_.step()
        r1 = eng_.add_request(list(first[0]), 6, lora_id=0)
        while eng_.step():
            pass
        outs[name] = [(eng_.reqs[r]["out"], eng_.reqs[r]["cached"]) for r in (r0, r1, r2)]
    assert outs["port"] == outs["jax"]
    assert [c for _, c in outs["port"]] == [0, 0, 0]
    (base, _), (a0, _), _ = outs["port"]
    assert a0 != base, "the adapter changes the tokens"
    plain = tserving.LlamaEngine(cfg, params=tp, device="cpu", num_pages=64, decode_batch=4,
                                 token_budget=64, kv_layout=kv_layout)
    assert plain.generate([first[0]], max_new_tokens=6)[0] == base


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_bitmask_and_stop_tokens_match_jax(layout):
    """One request under the even-ids bitmask, one stopping on its third
    greedy token, one plain: tokens equal the JAX engine's and every call's
    logits too; every masked pick is even, the stop request ends on it."""
    int8, kv_layout = LAYOUTS[layout]
    cfg = jl.tiny_config(int8_kv=int8)
    jp, tp = _jax_params(cfg, 0)
    first, late = _prompts(cfg)
    greedy = tserving.LlamaEngine(cfg, params=tp, device="cpu", num_pages=64,
                                  decode_batch=4, token_budget=64, kv_layout=kv_layout)
    plain = greedy.generate([first[1]], max_new_tokens=6)[0]
    bm = _even_mask(cfg.vocab_size)
    reqs = [(first[0], dict(max_new_tokens=6, token_bitmask=bm)),
            (first[1], dict(max_new_tokens=6, stop_token_ids=[plain[2]])),
            (late, dict(max_new_tokens=6))]
    je, te, jcalls, tcalls = _engines(cfg, jp, tp, kv_layout)
    want, _ = _run(je, reqs)
    got, _ = _run(te, reqs)
    assert got == want
    _calls_match(jcalls, tcalls)
    assert all(tok % 2 == 0 for tok in got[0]) and len(got[0]) == 6
    assert got[1] == plain[:3]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_pause_resume_matches_uninterrupted(layout):
    """Pause a request after 3 decoded tokens (its pages offloaded and
    freed), let another request churn the pool, resume it into newly
    allocated pages: its tokens equal the uninterrupted run's, and the JAX
    engine's through the same pause and resume."""
    int8, kv_layout = LAYOUTS[layout]
    cfg = jl.tiny_config(int8_kv=int8)
    jp, tp = _jax_params(cfg, 0)
    first, late = _prompts(cfg)
    kw = dict(num_pages=10, decode_batch=2, token_budget=64, kv_layout=kv_layout)
    plain = tserving.LlamaEngine(cfg, params=tp, device="cpu", **kw).generate(
        [first[0]], max_new_tokens=8)[0]
    outs = {}
    for name, eng in (("jax", jserving.LlamaEngine(cfg, params=jp, **kw)),
                      ("port", tserving.LlamaEngine(cfg, params=tp, device="cpu", **kw))):
        if name == "jax":
            eng._decode = jax.jit(lambda p, kv, i, po, sl, bt, sm, lid: jl.decode_step_kv(
                p, cfg, kv, i, po, sl, bt, sm), compiler_options=NO_EXCESS)
            eng._prefill_batch = jax.jit(
                lambda p, kv, i, vl, po, sm, bts, pl, lid: jl.prefill_batch_step_kv(
                    p, cfg, kv, i, vl, po, sm, bts, pl), compiler_options=NO_EXCESS)
        rid = eng.add_request(first[0], 8)
        while len(eng.reqs[rid]["out"]) < 3:
            eng.step()
        free = eng.sched.free_pages()
        eng.pause_request(rid)
        # its decode page is freed (the radix cache holds the prompt's two)
        assert eng.sched.free_pages() > free and not eng.reqs[rid]["pages"]
        eng.add_request(late, 4)                          # churns the pool
        new = eng.resume_request(rid)
        while eng.step():
            pass
        outs[name] = eng.reqs[new]["out"]
    assert outs["port"] == plain
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_sampling_is_seeded_and_top_k_1_is_greedy(layout):
    """A sampled engine (temperature 0.8, top_k 8, top_p 0.95) repeats its
    tokens from one seed and gives other tokens from another; top_k 1
    gives the greedy engine's tokens."""
    int8, kv_layout = LAYOUTS[layout]
    cfg = tl.tiny_config(int8_kv=int8)
    tp = tl.init_params(cfg, 0, "cpu")
    prompts, _ = _prompts(cfg)
    kw = dict(num_pages=64, decode_batch=4, token_budget=64, kv_layout=kv_layout)

    def serve(**extra):
        return tserving.LlamaEngine(cfg, params=tp, device="cpu", **kw, **extra).generate(
            prompts, max_new_tokens=6)

    sampled = dict(temperature=0.8, top_k=8, top_p=0.95)
    a, b, c = serve(seed=7, **sampled), serve(seed=7, **sampled), serve(seed=8, **sampled)
    assert a == b and a != c
    assert all(0 <= tok < cfg.vocab_size for o in a for tok in o)
    assert serve(seed=5, temperature=0.8, top_k=1) == serve()
