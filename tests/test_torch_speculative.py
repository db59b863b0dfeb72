"""The port's speculative decoding against the JAX package on the CPU: the
tree ops (ops/speculative.py) on the reference's vectors
(tests/test_speculative.py) and on random trees, bit for bit;
llama.decode_verify_step's logits (calc_diff < 8e-3) and written caches
(bf16, bit-equal); and serving.speculative_generate's tokens and accept
counts, equal.

The JAX model runs its Pallas kernels interpreted (SKT_IMPL=pallas), so
its draft steps round as the port's plain v6 does, and is compiled with
`xla_allow_excess_precision` off (tests/test_torch_llama.py): for
speculative_generate, whose jits and eager prefill the JAX package makes
itself, `jax.jit` and its `prefill_chunk_step` are patched for the test to
compile with that option.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu import serving as jserving
from sgl_kernel_npu_tpu.models import llama as jl
from sgl_kernel_npu_tpu.ops import speculative as jspec
from sgl_kernel_npu_tpu_torch import serving as tserving
from sgl_kernel_npu_tpu_torch.models import llama as tl
from sgl_kernel_npu_tpu_torch.ops import speculative as tspec

from .test_speculative import _preprocess, _reference_vectors, _verify_native
from .test_torch_llama import NO_EXCESS, _jax_params
from .utils import calc_diff

LOGITS_DIFF = 8e-3
MODES = [jspec.TreeMaskMode.FULL_MASK, jspec.TreeMaskMode.QLEN_ONLY,
         jspec.TreeMaskMode.QLEN_ONLY_BITPACKING]


def _equal(jouts, touts):
    for j, t in zip(jouts, touts):
        j = np.asarray(j)
        assert t.dtype == (torch.bool if j.dtype == bool else torch.int32)
        np.testing.assert_array_equal(t.numpy(), j)


# the JAX ops jitted once a shape (their small loops are slow op by op)
_jbuild = jax.jit(jspec.build_tree_efficient, static_argnums=(3, 4, 5))
_jverify = jax.jit(jspec.verify_tree_greedy)


def _build(parent_list, selected_index, seq_lens, topk, dt, mode):
    j = _jbuild(jnp.asarray(parent_list, jnp.int32), jnp.asarray(selected_index, jnp.int32),
                jnp.asarray(seq_lens, jnp.int32), topk, dt, mode)
    t = tspec.build_tree_efficient(torch.from_numpy(np.asarray(parent_list, np.int32)),
                                   torch.from_numpy(np.asarray(selected_index, np.int32)),
                                   torch.from_numpy(np.asarray(seq_lens, np.int32)), topk, dt,
                                   mode)
    return j, t


@pytest.mark.parametrize("mode", MODES)
def test_build_tree_reference_vectors(mode):
    score_list, parents_list, seq_lens = _reference_vectors()
    parent_list, selected_index = _preprocess(score_list, parents_list, 8)
    j, t = _build(parent_list, selected_index, seq_lens, 4, 8, mode)
    _equal(j, t)
    assert t[0].tolist() == [5, 6, 6, 7, 7, 8, 8, 9, 10, 11, 12, 12, 12, 12, 13, 14]
    assert t[2].tolist() == [[1, 3, 4, 5, 6, 7, -1, -1], [1, 2, -1, 6, -1, -1, 7, -1]]


def _random_tree(seed, bs, topk, dt):
    rng = np.random.default_rng(seed)
    parent_list = rng.integers(0, topk * 2, (bs, dt * 2))
    selected_index = np.stack([rng.permutation(topk * 4)[:dt - 1] for _ in range(bs)])
    seq_lens = rng.integers(4, 30, bs)
    return parent_list, selected_index, seq_lens


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed,topk,dt", [(0, 4, 6), (1, 2, 5), (2, 8, 12), (3, 4, 9),
                                          (4, 16, 34)])
def test_build_tree_random_trees(seed, topk, dt, mode):
    """Random parent lists (some parents unresolved, so invalid nodes) and
    selections; dt 34 packs each mask row into two words."""
    j, t = _build(*_random_tree(seed, 3, topk, dt), topk, dt, mode)
    _equal(j, t)


@pytest.mark.parametrize("shape", [(3, 6, 6), (2, 5, 40), (1, 64), (4, 33)])
def test_pack_unpack_tree_mask(shape):
    m = np.random.default_rng(len(shape)).random(shape) < 0.5
    jp = jspec.pack_tree_mask(jnp.asarray(m))
    tp = tspec.pack_tree_mask(torch.from_numpy(m))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tspec.unpack_tree_mask(tp, shape[-1]).numpy(), m)
    np.testing.assert_array_equal(
        tspec.unpack_tree_mask(tp, shape[-1]).numpy(),
        np.asarray(jspec.unpack_tree_mask(jp, shape[-1])))


@pytest.mark.parametrize("seed", range(6))
def test_verify_tree_greedy_matches_jax(seed):
    """Trees from build_tree_efficient, candidates and targets over 3 ids
    (so some paths match deep and some fail at once): equal to the JAX op
    and to the reference's native walk (tests/test_speculative.py)."""
    bs, topk, dt = 4, 4, 7
    _, t = _build(*_random_tree(seed, bs, topk, dt), topk, dt, jspec.TreeMaskMode.QLEN_ONLY)
    ridx, ntok, nsib = (a.numpy() for a in t[1:4])
    rng = np.random.default_rng(100 + seed)
    cand = rng.integers(0, 3, (bs, dt)).astype(np.int32)
    target = rng.integers(0, 3, (bs, dt)).astype(np.int32)
    args = (cand, ridx, ntok, nsib, target)
    j = _jverify(*(jnp.asarray(a) for a in args))
    got = tspec.verify_tree_greedy(*(torch.from_numpy(a) for a in args))
    _equal(j, got)
    for g, n in zip(got, _verify_native(*args)):
        np.testing.assert_array_equal(g.numpy(), n)


def _bf16_cache(cfg, pages, rng):
    shape = (cfg.num_layers, pages, cfg.num_kv_heads, cfg.page_size, cfg.head_dim)
    return tuple(np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
                 for _ in range(2))


@pytest.mark.parametrize("tree", ["chain", "random"])
def test_decode_verify_step_matches_jax(monkeypatch, tree):
    """Two requests of 5 drafts after 20 and 7 cached tokens (seeded rows),
    a causal chain or a build_tree mask: logits within calc_diff 8e-3, the
    bf16 caches (the drafts' rows written) bit-equal."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    cfg = jl.tiny_config()
    jp, tp = _jax_params(cfg, 0)
    rng = np.random.default_rng(9)
    kv0 = _bf16_cache(cfg, 10, rng)
    b, dt, ps = 2, 5, cfg.page_size
    bt = np.array([[1, 2, 3], [5, 6, 0]], np.int32)
    seq = np.array([20, 7], np.int32)
    pos = (seq[:, None] + np.arange(dt)[None]).astype(np.int32)
    slots = (np.take_along_axis(bt, pos // ps, 1) * ps + pos % ps).astype(np.int32)
    ids = rng.integers(0, cfg.vocab_size, (b, dt)).astype(np.int32)
    if tree == "chain":
        mask = np.broadcast_to(np.tril(np.ones((dt, dt), bool)), (b, dt, dt)).copy()
    else:
        _, t = _build(*_random_tree(5, b, 2, dt), 2, dt, jspec.TreeMaskMode.QLEN_ONLY)
        mask = t[4].numpy()
    args = (ids, pos, mask, seq, bt, slots)
    jver = jax.jit(lambda p, kc, vc, *a: jl.decode_verify_step(p, cfg, kc, vc, *a),
                   compiler_options=NO_EXCESS)
    jlg, jk, jv = jver(jp, *(jnp.asarray(a) for a in kv0 + args))
    tk, tv = tl.kv_from_jax(kv0, "cpu")
    tlg, tk2, tv2 = tl.decode_verify_step(tp, cfg, tk, tv,
                                          *(torch.from_numpy(np.asarray(a)) for a in args))
    assert tk2 is tk and tlg.shape == (b, dt, cfg.vocab_size) and tlg.dtype == torch.float32
    assert calc_diff(tlg.numpy(), np.asarray(jlg)) < LOGITS_DIFF
    for j, t in ((jk, tk), (jv, tv)):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j).astype(np.float32))


@pytest.mark.parametrize("prompt_seed,draft_len", [(3, 3)])
def test_speculative_generate_matches_jax(monkeypatch, prompt_seed, draft_len):
    """A draft model of other weights (seed 1) and self-speculation: the
    port's tokens and accept counts equal the JAX function's. (Self-
    speculation need not accept every draft here: the draft steps' plain v6
    rounds p to bf16, the verify step's plain attention does not.)"""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    jit = jax.jit
    monkeypatch.setattr(jax, "jit", functools.partial(jit, compiler_options=NO_EXCESS))
    monkeypatch.setattr(jl, "prefill_chunk_step",
                        jit(jl.prefill_chunk_step, static_argnums=1,
                            compiler_options=NO_EXCESS))
    cfg = jl.tiny_config()
    jt, tt = _jax_params(cfg, 0)
    jd, td = _jax_params(cfg, 1)
    prompt = np.random.default_rng(prompt_seed).integers(0, cfg.vocab_size, 8).tolist()
    for jdraft, tdraft in ((jd, td), (jt, tt)):
        want = jserving.speculative_generate(jt, cfg, jdraft, cfg, prompt, 8, draft_len)
        got = tserving.speculative_generate(tt, cfg, tdraft, cfg, prompt, 8, draft_len,
                                            device="cpu")
        assert got == want
        assert len(got[0]) == 8 and all(0 <= a < draft_len for a in got[1])


def test_speculative_generate_refuses_int8_caches():
    cfg = tl.tiny_config(int8_kv=True)
    params = tl.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="bf16"):
        tserving.speculative_generate(params, cfg, params, cfg, [1, 2, 3], 4, device="cpu")
