"""The port's two EP models, models/deepseek_v3.py (MLA + the EP-routed MoE)
and models/moe.py (GQA + the EP-routed MoE), against the JAX package's
decode steps from the same numpy parameters, on the CPU.

The JAX init_params' arrays go to the port through the tree walker
(models/llama.py::params_from_jax) and each rank takes its expert shard
(deepseek_v3.expert_shard). R = 1 runs the port's step in this process
against the JAX make_decode_step on one CPU device; R = 2 runs it in two
spawned processes joined by a gloo group (one world, both models) against
the JAX step on a 2-device mesh: tokens, caches (pages) and experts split
over the ranks, block tables rank-local. The port runs its CPU path, the
plain versions of its kernels (the aligned compaction and K8's tile
reference, decode_gqa_hm_ref at head dim 128); the JAX step takes its
references (SKT_IMPL unset off the TPU).

Tolerances: logits within calc_diff 1e-5 (the f32 products and sums in
another order; the int8 GEMMs are exact, and none of these seeds meets an
int8 rounding flip in mla_preprocess), the written cache rows within
calc_diff 1e-6 and 1e-4 of max|ref|; the init bit-identical to the JAX
package's but for moe's RoPE table (XLA's CPU cos / sin, within an f32 ulp:
tests/test_torch_qwen.py). The moe model also runs at head dim 128, where
its attention takes the K10 path; that path's plain version is held on f32
pages against the JAX kernel decode_gqa_pallas_v2 in interpret mode.
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
from jax.sharding import Mesh

from sgl_kernel_npu_tpu.models import deepseek_v3 as jds
from sgl_kernel_npu_tpu.models import moe as jmoe
from sgl_kernel_npu_tpu_torch.models import deepseek_v3 as tds
from sgl_kernel_npu_tpu_torch.models import moe as tmoe
from sgl_kernel_npu_tpu_torch.models.llama import params_from_jax
from sgl_kernel_npu_tpu_torch.ops.attention import decode as tdec

from .utils import calc_diff

B, PAGES, MP = 4, 16, 4           # tokens, pages and block-table width a rank
LOGITS_DIFF = 1e-5
CACHE_DIFF = 1e-6
MODELS = {"deepseek_v3": (jds, tds, jds.DeepSeekV3Config()),
          "moe": (jmoe, tmoe, jmoe.MoEConfig()),
          "moe_d128": (jmoe, tmoe, jmoe.MoEConfig(num_heads=4, num_kv_heads=2, head_dim=128))}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def make_inputs(name, r, seed):
    """numpy: the JAX params, the global caches (random f32, so that the
    attention reads real rows) and r ranks' tokens with rank-local pages."""
    jm, _, cfg = MODELS[name]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jm.init_params(cfg, seed))
    caches = [rng.standard_normal(np.shape(c)).astype(np.float32)
              for c in jm.init_kv_cache(cfg, PAGES * r)]
    seq = rng.integers(1, MP * cfg.page_size + 1, B * r).astype(np.int32)
    bt = np.stack([rng.permutation(PAGES)[:MP] for _ in range(B * r)]).astype(np.int32)
    last = seq - 1
    slots = (bt[np.arange(B * r), last // cfg.page_size] * cfg.page_size
             + last % cfg.page_size).astype(np.int32)
    ids = rng.integers(0, cfg.vocab_size, B * r).astype(np.int32)
    return dict(params=params, caches=caches, ids=ids, pos=last.astype(np.int32), seq=seq,
                bt=bt, slots=slots)


def port_step(name, group, rank, r, data):
    """This rank's decode step through the port: (logits, caches)."""
    _, tm, cfg = MODELS[name]
    params = tds.expert_shard(params_from_jax(data["params"], "cpu"), rank, r)
    page_dim = 1 if name == "deepseek_v3" else 2
    caches = [torch.from_numpy(np.ascontiguousarray(np.take(
        c, range(rank * PAGES, (rank + 1) * PAGES), axis=page_dim))) for c in data["caches"]]
    tok = slice(rank * B, (rank + 1) * B)
    step = tm.make_decode_step(group, cfg, max_tokens=B)
    logits, c1, c2 = step(params, *caches, *(torch.from_numpy(data[k][tok])
                                             for k in ("ids", "pos", "seq", "bt", "slots")))
    return logits.numpy(), c1.numpy(), c2.numpy()


def jax_step(name, r, data):
    jm, _, cfg = MODELS[name]
    mesh = Mesh(np.array(jax.devices()[:r]), ("ep",))
    step, _ = jm.make_decode_step(mesh, cfg, max_tokens=B)
    out = step(jax.tree.map(jnp.asarray, data["params"]),
               *(jnp.asarray(c) for c in data["caches"]),
               *(jnp.asarray(data[k]) for k in ("ids", "pos", "seq", "bt", "slots")))
    return [np.asarray(a) for a in out]


def _rank_main(rank, world, init_file, out_dir, inputs):
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        from sgl_kernel_npu_tpu_torch.parallel import EPGroup
        group = EPGroup(dist.group.WORLD)
        out = {name: port_step(name, group, rank, world, data) for name, data in inputs.items()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """R -> {model: (inputs, the port's per-rank outputs, the JAX outputs)}."""
    out = {}
    for r in (1, 2):
        inputs = {name: make_inputs(name, r, 90 + r) for name in MODELS}
        if r == 1:
            port = [{name: port_step(name, None, 0, 1, d) for name, d in inputs.items()}]
        else:
            tmp = tmp_path_factory.mktemp("models2")
            mp.start_processes(_rank_main, args=(r, str(tmp / "init"), str(tmp), inputs),
                               nprocs=r, join=True, start_method="spawn")
            port = [torch.load(tmp / f"rank{i}.pt", weights_only=False) for i in range(r)]
        out[r] = {name: (inputs[name], [p[name] for p in port], jax_step(name, r, inputs[name]))
                  for name in MODELS}
    return out


def _pages(a, rank, page_dim):
    return np.take(a, range(rank * PAGES, (rank + 1) * PAGES), axis=page_dim)


@pytest.mark.parametrize("r", [1, 2], ids=lambda r: f"R{r}")
@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_jax(runs, name, r):
    _, port, want = runs[r][name]
    for rank in range(r):
        got, jx = port[rank][0], want[0][rank * B:(rank + 1) * B]
        assert np.all(np.isfinite(got))
        assert calc_diff(got, jx) < LOGITS_DIFF, (name, rank, calc_diff(got, jx))


@pytest.mark.parametrize("r", [1, 2], ids=lambda r: f"R{r}")
@pytest.mark.parametrize("name", list(MODELS))
def test_written_caches_match_jax(runs, name, r):
    """Each rank's caches after the step: untouched rows equal, the written
    rows (the new token's) within the bar."""
    data, port, want = runs[r][name]
    page_dim = 1 if name == "deepseek_v3" else 2
    for rank in range(r):
        for i in (1, 2):
            got, jx = port[rank][i], _pages(want[i], rank, page_dim)
            before = _pages(data["caches"][i - 1], rank, page_dim)
            written = got != before
            assert np.array_equal(got[~(written | (jx != before))], jx[~(written | (jx != before))])
            diff = got - jx
            assert calc_diff(got[written | (jx != before)], jx[written | (jx != before)]) \
                < CACHE_DIFF, (name, rank, i)
            assert np.abs(diff).max() <= 1e-4 * np.abs(jx).max(), (name, rank, i)


@pytest.mark.parametrize("name", ["deepseek_v3", "moe"])
def test_init_params_bit_equal_to_jax(name):
    """The port's numpy init draws what the JAX init draws, leaf for leaf
    (moe's RoPE table aside: XLA's CPU cos / sin)."""
    jm, tm, cfg = MODELS[name]
    want = dict(_leaves(jax.tree.map(np.asarray, jm.init_params(cfg, 3))))
    for key, leaf in _leaves(tm.init_params(cfg, 3, device="cpu")):
        if key == "/cos_sin":
            np.testing.assert_allclose(leaf.numpy(), want[key], rtol=0, atol=2e-6)
            continue
        assert np.array_equal(leaf.numpy(), want[key]) and leaf.numpy().dtype == want[key].dtype, key


def test_expert_shard_cuts_the_expert_dim():
    params = tds.init_params(tds.DeepSeekV3Config(), 0, device="cpu")
    full = params["layers"]["w13"]["q"]
    for rank in range(4):
        part = tds.expert_shard(params, rank, 4)
        assert torch.equal(part["layers"]["w13"]["q"], full[:, rank * 4:(rank + 1) * 4])
        assert part["layers"]["router"] is params["layers"]["router"]


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("ps", [16, 32])
def test_k10_f32_plain_matches_jax_kernel(g, ps):
    """K10's plain version on f32 head-major pages against the JAX kernel
    decode_gqa_pallas_v2 (interpret mode) on the same pages: f32 sums in
    another order, within 1e-5 of max|ref|. Lengths 1, ps - 1, ps, ps + 1
    and several pages."""
    from sgl_kernel_npu_tpu.ops.attention.decode_v2 import decode_gqa_pallas_v2
    rng = np.random.default_rng(ps + g)
    hkv, pages, mp_ = 2, 24, 5
    lens = np.array([1, ps - 1, ps, ps + 1, 3 * ps + 5], np.int32)
    b = lens.shape[0]
    q = rng.standard_normal((b, hkv * g, 128)).astype(np.float32)
    kc = rng.standard_normal((hkv, pages, ps, 128)).astype(np.float32)
    vc = rng.standard_normal((hkv, pages, ps, 128)).astype(np.float32)
    bt = np.stack([rng.permutation(pages)[:mp_] for _ in range(b)]).astype(np.int32)
    want = np.asarray(decode_gqa_pallas_v2(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                           jnp.asarray(lens), jnp.asarray(bt), 0.0884, ps))
    got = tdec.decode_gqa_hm(*(torch.from_numpy(a) for a in (q, kc, vc, lens, bt)), 0.0884, ps)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
