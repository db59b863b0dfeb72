"""The port's Llama tensor parallelism (models/llama.py: shard_cfg_tp,
shard_params_tp, decode_step_tp and decode_step_kv's tp_group) against the
JAX package on the CPU.

shard_cfg_tp and shard_params_tp are held bit-identical to the JAX
functions. decode_step_tp runs in 2 and 4 processes joined by a gloo group
(torch.multiprocessing, init_method="file://...", as tests/test_torch_moe_ep.py
does), on int8 token-major ("tm") pages and on bf16 page-major ("hm") pages,
three steps of 4 sequences; each rank's logits are held in the parent
against JAX decode_step_tp under shard_map on as many of the 8 CPU devices
(SKT_IMPL=pallas, compiled with `xla_allow_excess_precision` off, as
tests/test_torch_llama.py compiles the unsharded step) and against the
unsharded decode_step_kv. Bounds: at 2 ranks within calc_diff 1e-5 of JAX
(two shards sum exactly in either order); at 4 ranks, and against the
unsharded step, within tests/test_llama_model.py's calc_diff 5e-3 (four
shards may sum in another order than JAX's psum, and each shard quantises
its own activations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sgl_kernel_npu_tpu.models import llama as jl
from sgl_kernel_npu_tpu_torch.models import llama as tl

from .torch_hf import assert_trees_equal
from .torch_tp_ranks import PAGES, layout_caches, rank_main
from .utils import calc_diff

NO_EXCESS = {"xla_allow_excess_precision": False}
B, MP, STEPS = 4, 3, 3


def _cfg(layout):
    return jl.tiny_config(int8_kv=layout == "tm")


def _np_params(cfg, seed=4):
    return jax.tree.map(np.asarray, jl.init_params(cfg, seed))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_cfg_tp_matches_jax(tp):
    cfg = jl.tiny_config()
    tcfg = tl.tiny_config()
    assert dataclasses.asdict(jl.shard_cfg_tp(cfg, tp)) == dataclasses.asdict(
        tl.shard_cfg_tp(tcfg, tp))


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_tp_bit_identical(tp):
    """Every leaf of the [tp, ...]-stacked tree equal to the JAX package's;
    each shard's banks contiguous."""
    cfg = jl.tiny_config()
    npp = _np_params(cfg)
    jp = jl.shard_params_tp(jax.tree.map(jnp.asarray, npp), cfg, tp)
    tp_ = tl.shard_params_tp(tl.params_from_jax(npp, "cpu"), tl.tiny_config(), tp)
    assert_trees_equal(jp, tp_)
    assert all(tp_["layers"][n]["q"][tp - 1].is_contiguous() for n in ("wqkv", "wo", "w13", "w2"))


def test_shard_params_tp_refuses_pretiled_banks():
    """As in the JAX package: a pretiled 4-D bank would be sharded along its
    panel axis, so it is refused; so is a tp that does not divide the heads
    (the JAX package asserts both)."""
    cfg = tl.tiny_config()
    params = tl.pretile_big_weights(tl.params_from_jax(_np_params(jl.tiny_config()), "cpu"),
                                    128)
    with pytest.raises(ValueError, match="untiled"):
        tl.shard_params_tp(params, cfg, 2)
    with pytest.raises(ValueError, match="does not divide"):
        tl.shard_cfg_tp(cfg, 3)


def _steps(cfg, seed):
    """STEPS decode steps of B sequences: (ids, positions, seq_lens, block
    table, slots) each, positions crossing a page edge."""
    rng = np.random.default_rng(seed)
    ps = cfg.page_size
    bt = (rng.permutation(PAGES - 1)[: B * MP].reshape(B, MP) + 1).astype(np.int32)
    pos = np.array([0, ps - 2, 5, 2 * ps - 1], np.int32)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        slots = (bt[np.arange(B), pos // ps] * ps + pos % ps).astype(np.int32)
        out.append((ids, pos.copy(), pos + 1, bt, slots))
        pos = pos + 1
    return out


def _jax_tp(cfg, npp, layout, tp, steps):
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tp",))
    params_tp = jl.shard_params_tp(jax.tree.map(jnp.asarray, npp), cfg, tp)
    cfg_s = jl.shard_cfg_tp(cfg, tp)
    kv_tp = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[jl.init_kv_cache(cfg_s, PAGES, layout=layout) for _ in range(tp)])
    fn = jax.jit(lambda p, kv, *a: jl.decode_step_tp(p, cfg, kv, *a, mesh),
                 compiler_options=NO_EXCESS)
    out = []
    for args in steps:
        lg, kv_tp = fn(params_tp, kv_tp, *(jnp.asarray(a) for a in args))
        out.append(np.asarray(lg))
    return np.stack(out)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda r: f"tp{r}")
def ranks(request, tmp_path_factory):
    """(tp, {layout: (numpy params, steps, [each rank's logits])}): one gloo
    world of tp spawned ranks runs both layouts."""
    tp = request.param
    cases = []
    for layout in ("tm", "hm"):
        cfg = _cfg(layout)
        cases.append((layout, _np_params(cfg), _steps(cfg, 30 + tp)))
    tmp = tmp_path_factory.mktemp(f"tp{tp}")
    mp.start_processes(rank_main, args=(tp, str(tmp / "init"), str(tmp), cases), nprocs=tp,
                       join=True, start_method="spawn")
    return tp, {layout: (npp, steps, [torch.load(tmp / f"{layout}_rank{r}.pt").numpy()
                                      for r in range(tp)])
                for layout, npp, steps in cases}


@pytest.mark.parametrize("layout", ["tm", "hm"])
def test_decode_step_tp_matches_jax(ranks, monkeypatch, layout):
    """decode_step_tp on tp gloo ranks, three steps: every rank's logits the
    same, within the module's bound of JAX decode_step_tp on tp devices and
    within calc_diff 5e-3 of the port's unsharded decode_step_kv."""
    monkeypatch.setenv("SKT_IMPL", "pallas")
    tp, results = ranks
    npp, steps, port = results[layout]
    cfg = _cfg(layout)
    assert all(np.array_equal(port[0], p) for p in port[1:])
    want = _jax_tp(cfg, npp, layout, tp, steps)
    tcfg = tl.tiny_config(int8_kv=layout == "tm")
    params = tl.params_from_jax(npp, "cpu")
    kv = layout_caches(tcfg, layout, 1, False)
    bar = 1e-5 if tp == 2 else 5e-3
    for i, args in enumerate(steps):
        single, kv = tl.decode_step_kv(params, tcfg, kv, *(torch.from_numpy(a) for a in args))
        assert np.all(np.isfinite(port[0][i]))
        assert calc_diff(port[0][i], want[i]) < bar, (i, calc_diff(port[0][i], want[i]))
        assert calc_diff(port[0][i], single.numpy()) < 5e-3, i
