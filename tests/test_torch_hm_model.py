"""The port's head-major ("hm") Llama slice against the JAX package on the
CPU: `decode_step_kv` on page-major caches (bf16 and int8; the deferred v6
and v3 attention, SKT_DECODE_DEFER=0 and SKT_DECODE_FLAT=0),
`prefill_batch_step_kv` on them, and LlamaEngine with int8_kv=False and with
kv_layout="hm".

The JAX side runs its Pallas kernels in interpret mode (SKT_IMPL=pallas) and
is compiled with `xla_allow_excess_precision` off, as in
tests/test_torch_llama.py; the port runs its plain PyTorch versions
(device="cpu"). Tolerances: logits calc_diff < 8e-3 (the repo's bound,
tests/test_llama_model.py:376-377); bf16 caches bit-equal (copies of the
same bf16 rows); int8 caches >= 99.9% bit-equal with |diff| <= 1 and scales
>= 99.9% bit-equal (rounding-boundary flips, the K2 flip rule of
tests/test_torch_llama.py); the engines' greedy tokens equal and each
model call's live logits within calc_diff 8e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu import serving as jserving
from sgl_kernel_npu_tpu.models import llama as jl
from sgl_kernel_npu_tpu_torch import serving as tserving
from sgl_kernel_npu_tpu_torch.models import llama as tl

from .test_torch_llama import NO_EXCESS, _jax_params, _prompts, _serve
from .utils import calc_diff

LOGITS_DIFF = 8e-3
PAGES = 12


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("SKT_IMPL", "pallas")


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _seeded_cache(cfg, rng):
    """A JAX hm cache of seeded rows (bf16 randn, or int8 with scales), as
    numpy, so that attention sees real numbers from the first step."""
    shape = (cfg.num_layers, PAGES, cfg.num_kv_heads, cfg.page_size, cfg.head_dim)
    if not cfg.int8_kv:
        return tuple(np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
                     for _ in range(2))
    sshape = shape[:3] + (1, cfg.page_size)
    return {"k": rng.integers(-127, 128, shape, dtype=np.int8),
            "v": rng.integers(-127, 128, shape, dtype=np.int8),
            "ks": (rng.random(sshape, dtype=np.float32) * 0.02 + 0.005),
            "vs": (rng.random(sshape, dtype=np.float32) * 0.02 + 0.005)}


def _cache_match(jkv, tkv):
    if isinstance(tkv, tuple):
        for a, b in zip(jkv, tkv):
            assert np.array_equal(np.asarray(a).astype(np.float32), b.float().numpy())
        return
    for name in ("k", "v"):
        a = np.asarray(jkv[name]).astype(np.int32)
        b = tkv[name].numpy().astype(np.int32)
        assert (a == b).mean() >= 0.999 and np.abs(a - b).max() <= 1, name
    for name in ("ks", "vs"):
        assert (np.asarray(jkv[name]) == tkv[name].numpy()).mean() >= 0.999, name


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("branch", ["v6", "v3", "no_defer", "no_flat"])
def test_decode_steps_match_jax(monkeypatch, int8, branch):
    """Three decode_step_kv steps on an hm cache of seeded rows, a padded
    batch of 4 (row 3: slot -1), rows crossing a page edge: each branch of
    the JAX package's decode (llama.py:443-651) against the port's."""
    env = {"v6": {}, "v3": {"SKT_DECODE_ATTN": "v3"},
           "no_defer": {"SKT_DECODE_DEFER": "0"}, "no_flat": {"SKT_DECODE_FLAT": "0"}}
    for k, v in env[branch].items():
        monkeypatch.setenv(k, v)
    cfg = jl.tiny_config(int8_kv=int8)
    jp, tp = _jax_params(cfg, 0)
    assert not tl.tm_layout_ok(cfg) or branch in ("v6", "v3")
    rng = np.random.default_rng(31)
    kv0 = _seeded_cache(cfg, rng)
    jkv = jax.tree.map(jnp.asarray, kv0)
    tkv = tl.kv_from_jax(kv0, "cpu")
    assert isinstance(tkv, tuple) != int8
    jdec = jax.jit(lambda p, kv, *a: jl.decode_step_kv(p, cfg, kv, *a),
                   compiler_options=NO_EXCESS)
    ps, b = cfg.page_size, 4
    bt = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [0, 0, 0]], np.int32)
    pos = np.array([14, 15, 31, 0], np.int32)
    for _ in range(3):
        ids = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
        seq = pos + 1
        seq[3] = 1
        slots = (bt[np.arange(b), pos // ps] * ps + pos % ps).astype(np.int32)
        slots[3] = -1
        args = (ids, pos, seq, bt, slots)
        jlg, jkv = jdec(jp, jkv, *(jnp.asarray(a) for a in args))
        tlg, tkv2 = tl.decode_step_kv(tp, cfg, tkv, *(_t(a) for a in args))
        assert tkv2 is tkv and tlg.dtype == torch.float32
        assert calc_diff(tlg[:3].numpy(), np.asarray(jlg)[:3]) < LOGITS_DIFF, branch
        _cache_match(jkv, tkv)
        pos = pos + np.array([1, 1, 1, 0], np.int32)


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_batch_matches_jax(int8):
    """prefill_batch_step_kv on an hm cache: 2 ragged chunks padded to 32,
    the second after a 20-token prefix already cached (seeded rows), each
    layer writing its chunk, then attending it through the paged prefill."""
    cfg = jl.tiny_config(int8_kv=int8)
    jp, tp = _jax_params(cfg, 0)
    rng = np.random.default_rng(41)
    kv0 = _seeded_cache(cfg, rng)
    jkv = jax.tree.map(jnp.asarray, kv0)
    tkv = tl.kv_from_jax(kv0, "cpu")
    ps, s, t = cfg.page_size, 2, 32
    lens, plens = [21, 9], [0, 20]
    bts = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    ids = np.zeros((s, t), np.int32)
    slp = np.full((s, t), -1, np.int32)
    pos = np.zeros((s, t), np.int32)
    for si, (n, p0) in enumerate(zip(lens, plens)):
        p = p0 + np.arange(n)
        ids[si, :n] = rng.integers(0, cfg.vocab_size, n)
        pos[si, :n] = p
        slp[si, :n] = bts[si, p // ps] * ps + p % ps
    args = (ids, np.array(lens, np.int32), pos, slp, bts, np.array(plens, np.int32))
    jpre = jax.jit(lambda p, kv, *a: jl.prefill_batch_step_kv(p, cfg, kv, *a),
                   compiler_options=NO_EXCESS)
    jlg, jkv = jpre(jp, jkv, *(jnp.asarray(a) for a in args))
    tlg, tkv2 = tl.prefill_batch_step_kv(tp, cfg, tkv, *(_t(a) for a in args))
    assert tkv2 is tkv and tlg.shape == (s, t, cfg.vocab_size)
    for si, n in enumerate(lens):
        assert calc_diff(tlg[si, :n].numpy(), np.asarray(jlg)[si, :n]) < LOGITS_DIFF
    _cache_match(jkv, tkv)


def _recording(step, calls, kind, lead=0):
    """Wrap an engine's step function: record the logits of its live rows
    (prefill: each chunk's valid positions; decode: rows with a slot). The
    JAX engine passes params and cache first (lead=2)."""
    def wrapped(*a):
        logits, kv = step(*a)
        lg = np.asarray(logits.float() if isinstance(logits, torch.Tensor) else logits)
        if kind == "prefill":
            vl = np.asarray(a[lead + 1])
            calls.append((kind, np.concatenate([lg[si, :n] for si, n in enumerate(vl) if n])))
        else:
            calls.append((kind, lg[np.asarray(a[lead + 4]) >= 0]))
        return logits, kv
    return wrapped


@pytest.mark.parametrize("int8", [False, True])
def test_hm_engine_matches_jax_engine(int8):
    """LlamaEngine on hm pages (int8_kv=False picks them; with int8_kv,
    kv_layout="hm") gives the JAX hm engine's greedy tokens, with chunked
    prefill (token budget 64), radix prefix reuse of 32 tokens and a padded
    decode batch, and every model call's live logits within calc_diff 8e-3
    of the JAX engine's call. (No prompt seed of 17..119 keeps every greedy
    pick of this tiny model's bf16 logits a fixed margin from its runner-up,
    as tests/test_torch_llama.py's tm engine test asks; here the logits of
    each call are held to the JAX ones instead.) Serving the late prompt
    alone gives its tokens again."""
    cfg = jl.tiny_config(int8_kv=int8)
    jp, tp = _jax_params(cfg, 0)
    first, late = _prompts(cfg)
    layout = "hm" if int8 else None
    kw = dict(num_pages=64, decode_batch=4, token_budget=64, kv_layout=layout)

    je = jserving.LlamaEngine(cfg, params=jp, **kw)
    assert je.kv["k"].ndim == 5 if int8 else isinstance(je.kv, tuple)
    jcalls, tcalls = [], []
    je._decode = _recording(jax.jit(lambda p, kv, i, po, sl, bt, sm, lid: jl.decode_step_kv(
        p, cfg, kv, i, po, sl, bt, sm), compiler_options=NO_EXCESS), jcalls, "decode", 2)
    je._prefill_batch = _recording(jax.jit(
        lambda p, kv, i, vl, po, sm, bts, pl, lid: jl.prefill_batch_step_kv(
            p, cfg, kv, i, vl, po, sm, bts, pl), compiler_options=NO_EXCESS), jcalls, "prefill",
        2)
    want, jreused = _serve(je, first, late, 6)

    te = tserving.LlamaEngine(cfg, params=tp, device="cpu", **kw)
    assert isinstance(te.kv, tuple) != int8
    te._prefill_batch = _recording(te._prefill_batch, tcalls, "prefill")
    te._decode = _recording(te._decode, tcalls, "decode")
    got, reused = _serve(te, first, late, 6)
    assert reused == jreused == 32
    assert all(len(o) == 6 for o in got)
    assert got == want
    assert [k for k, _ in tcalls] == [k for k, _ in jcalls]
    for (kind, a), (_, b) in zip(tcalls, jcalls):
        assert a.shape == b.shape and calc_diff(a, b) < LOGITS_DIFF, kind

    solo = tserving.LlamaEngine(cfg, params=tp, device="cpu", **kw)
    assert solo.generate([late], max_new_tokens=6)[0] == got[-1]


def test_layouts_and_refusals():
    """init_kv_cache's hm caches (a bf16 tuple; an int8 dict with scales
    [L, P, hkv, 1, ps]); tm and tm2 stay int8-only; tm2 serves no prefill;
    the int8 engine still picks tm by default."""
    cfg = tl.tiny_config()
    kv = tl.init_kv_cache(cfg, 5, layout="hm", device="cpu")
    assert isinstance(kv, tuple) and kv[0].shape == (2, 5, 4, 16, 32)
    assert kv[0].dtype == torch.bfloat16 and not kv[0].any()
    cfg8 = tl.tiny_config(int8_kv=True)
    kv8 = tl.init_kv_cache(cfg8, 5, layout="hm", device="cpu")
    assert kv8["k"].dtype == torch.int8 and kv8["ks"].shape == (2, 5, 4, 1, 16)
    for layout in ("tm", "tm2"):
        with pytest.raises(ValueError, match="int8 only"):
            tl.init_kv_cache(cfg, 5, layout=layout, device="cpu")
    tm2 = tl.init_kv_cache(cfg8, 5, layout="tm2", device="cpu")
    params = tl.init_params(cfg8, 0, "cpu")
    z = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="decode-only"):
        tl.prefill_batch_step_kv(params, cfg8, tm2, z, torch.ones(1, dtype=torch.int32), z, z,
                                 z, torch.zeros(1, dtype=torch.int32))
    eng = tserving.LlamaEngine(cfg8, params=params, num_pages=8, device="cpu")
    assert eng.kv["k"].dim() == 4
