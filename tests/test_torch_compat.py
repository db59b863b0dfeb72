"""The port's compat.py against the JAX package's (tests/test_compat.py's
audit, on the port): the five namespaces have exactly the JAX keys, every
value is callable, and each key maps to the port's counterpart of the JAX
function it names (the same function name, but where the port named it
otherwise, and sparse_block_estimate, which maps to the kernel tier). A few names run on the CPU against the JAX compat names on the
same numpy inputs; the names that reach a kernel are driven on the card by
chip_smoke.py phase 20 (f).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu import compat as jcompat
from sgl_kernel_npu_tpu_torch import compat

NAMESPACES = ("npu", "attentions", "sgl_kernel", "deep_ep", "torch_memory_saver")
# reference key -> the port's function name, where it differs from the JAX one's
RENAMED = {"decode_gqa_high_performance": "decode_gqa_v3"}
# Keys that map to another function than the JAX table's: the JAX
# sparse_block_estimate is its plain estimator, the port's the kernel tier
# (K18, any head dim and bf16, fp16 or f32 on the card; compat.py's
# docstring).
KERNEL_TIER = {"sparse_block_estimate": "sparse_block_estimate_fused"}


@pytest.mark.parametrize("ns", NAMESPACES)
def test_namespace_keys_are_the_jax_keys(ns):
    assert set(vars(getattr(compat, ns))) == set(vars(getattr(jcompat, ns)))


@pytest.mark.parametrize("ns", NAMESPACES)
def test_all_reference_names_resolve(ns):
    for name, fn in vars(getattr(compat, ns)).items():
        assert callable(fn), name
        assert fn.__module__.startswith("sgl_kernel_npu_tpu_torch."), (name, fn.__module__)


@pytest.mark.parametrize("ns", NAMESPACES)
def test_names_map_to_the_ports_counterparts(ns):
    """Each value is the port's function of the JAX value's name (or the
    renamed one, or the kernel tier), from the port's module of the JAX
    value's module."""
    for key, jfn in vars(getattr(jcompat, ns)).items():
        tfn = getattr(compat, ns).__dict__[key]
        assert key not in RENAMED or not hasattr(
            importlib.import_module(tfn.__module__), jfn.__name__), key
        assert tfn.__name__ == {**RENAMED, **KERNEL_TIER}.get(key, jfn.__name__), key
        assert tfn.__module__ == jfn.__module__.replace("sgl_kernel_npu_tpu.",
                                                        "sgl_kernel_npu_tpu_torch.", 1), key


def test_surface_counts():
    assert len(vars(compat.npu)) >= 25
    assert len(vars(compat.attentions)) == 5
    assert len(vars(compat.sgl_kernel)) >= 35


def test_event_overlap_and_fuse_mode():
    from sgl_kernel_npu_tpu_torch.compat import deep_ep

    assert int(deep_ep.FuseMode.FUSED_DEEP_MOE) == int(jcompat.deep_ep.FuseMode.FUSED_DEEP_MOE)
    x = torch.ones(4)
    with deep_ep.EventOverlap(extra_tensors=[x]) as ev:
        assert ev.extra_tensors[0] is x
    ev.current_stream_wait()


def test_batch_matmul_transpose_names_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3, 16)).astype(np.float32)
    w = rng.standard_normal((3, 16, 8)).astype(np.float32)
    for key in ("batch_matmul_transpose", "catlass_matmul_basic"):
        want = np.asarray(getattr(jcompat.npu, key)(jnp.asarray(x), jnp.asarray(w)))
        got = getattr(compat.npu, key)(torch.from_numpy(x), torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_layernorm_and_rmsnorm_bias_match_jax():
    """attentions.layernorm and sgl_kernel.rmsnorm_bias (the same plain
    RMSNorm + bias, f32 arithmetic) on the same inputs: within 1e-6 of
    max|out| (XLA's CPU rsqrt approximates)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    wt = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    for ns, key in (("attentions", "layernorm"), ("sgl_kernel", "rmsnorm_bias")):
        want = np.asarray(getattr(getattr(jcompat, ns), key)(
            jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), 1e-6))
        got = getattr(getattr(compat, ns), key)(
            torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias), 1e-6).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 256])
def test_sparse_block_estimate_any_head_dim(d, dtype):
    """attentions.sparse_block_estimate (the kernel tier: block sums, on the
    CPU K18's plain scores) at D 64 and 256 against the port's plain
    estimator (block means) and the JAX compat name (its plain estimator),
    [1, 2, 200, D] in blocks of 32, causal: the scores differ in f32
    rounding only, so the masks agree but where a mean score lies within
    1e-5 of its row's largest |score| from the row's threshold; counts are
    the masks' row sums."""
    from sgl_kernel_npu_tpu_torch.ops.attention import sparse as tsp

    rng = np.random.default_rng(d)
    q, k = (rng.standard_normal((1, 2, 200, d)).astype(np.float32) for _ in range(2))
    tq, tk = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k))
    mask, count = compat.attentions.sparse_block_estimate(tq, tk, 32, keep_ratio=0.25)
    ref_mask, ref_count = tsp.sparse_block_estimate(tq, tk, 32, keep_ratio=0.25)
    jmask, _ = jcompat.attentions.sparse_block_estimate(
        jnp.asarray(tq.float().numpy()), jnp.asarray(tk.float().numpy()), 32, keep_ratio=0.25)
    assert mask.shape == (1, 2, 7, 7) and mask.dtype == torch.bool
    assert torch.equal(count, mask.sum(-1, dtype=torch.int32))
    n = 7
    qm = torch.nn.functional.pad(tq.float(), (0, 0, 0, n * 32 - 200)).reshape(1, 2, n, 32, d)
    km = torch.nn.functional.pad(tk.float(), (0, 0, 0, n * 32 - 200)).reshape(1, 2, n, 32, d)
    scores = torch.einsum("bhqd,bhkd->bhqk", qm.mean(3), km.mean(3)).double()
    scores = scores.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), -1e30)
    thresh = scores.sort(-1).values[..., n - 1:n]
    top = scores.masked_fill(scores < -1e29, 0).abs().amax(-1, keepdim=True)
    near = (scores - thresh).abs() <= 1e-5 * top
    for other in (ref_mask, torch.from_numpy(np.asarray(jmask))):
        assert not bool(((mask != other) & ~near).any())
    assert torch.equal(ref_count, ref_mask.sum(-1, dtype=torch.int32))
