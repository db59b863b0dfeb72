"""The port's MemorySaver (memsaver/) on the CPU, beside the JAX package's:
the same seeded trees go through pause / resume in both, and what comes
back is bit-equal (a copy to host memory and back is exact). The card's
half (pinned staging, memory_allocated falling by the tracked bytes and
coming back, an engine decode after resume) is chip_smoke.py phase 20 (e).
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgl_kernel_npu_tpu.memsaver import MemorySaver as JaxSaver
from sgl_kernel_npu_tpu_torch.memsaver import MemorySaver, get_memory_saver


def _trees(seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    q = rng.integers(-127, 128, (8, 16), dtype=np.int8)
    jt = {"w": jnp.asarray(w), "b": jnp.asarray(b), "q": jnp.asarray(q)}
    tt = {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.copy()),
          "layers": [torch.from_numpy(q.copy()), (torch.ones(3, dtype=torch.bfloat16),)]}
    return jt, tt


def test_pause_resume_roundtrip_matches_jax():
    jt, tt = _trees(0)
    want = {k: v.clone() for k, v in tt.items() if k != "layers"}
    js, ts = JaxSaver(), MemorySaver()
    with js.region(tag="weights"):
        js.track(jt)
    with ts.region(tag="weights"):
        assert ts.track(tt) is tt
    js.pause("weights")
    ts.pause("weights")
    assert js.get("weights") is None and ts.get("weights") is None
    jr, tr = js.resume("weights"), ts.resume("weights")
    assert ts.get("weights") is tr
    for k in ("w", "b"):
        assert np.array_equal(tr[k].numpy(), np.asarray(jr[k]))
        assert torch.equal(tr[k], want[k]) and tr[k].dtype == want[k].dtype
    assert np.array_equal(tr["layers"][0].numpy(), np.asarray(jr["q"]))
    assert isinstance(tr["layers"], list) and isinstance(tr["layers"][1], tuple)
    assert tr["layers"][1][0].dtype == torch.bfloat16
    assert tr["w"].device == tt["w"].device


def test_pause_without_backup_requires_values():
    ts, js = MemorySaver(), JaxSaver()
    ts.track({"x": torch.ones(8)}, tag="kv")
    js.track({"x": jnp.ones((8,))}, tag="kv")
    ts.pause("kv", backup=False)
    js.pause("kv", backup=False)
    for saver in (ts, js):
        with pytest.raises(ValueError, match="values="):
            saver.resume("kv")
    tr = ts.resume("kv", values={"x": torch.full((8,), 2.0)})
    jr = js.resume("kv", values={"x": jnp.full((8,), 2.0)})
    assert np.array_equal(tr["x"].numpy(), np.asarray(jr["x"]))


def test_pause_releases_the_tensors():
    """Once the caller holds no other reference, a paused tensor is freed
    (with and without a backup); an untracked tag is left alone."""
    for backup in (True, False):
        ts = MemorySaver()
        t = torch.randn(1024)
        ref = weakref.ref(t)
        ts.track({"t": t}, tag="a")
        del t
        gc.collect()
        assert ref() is not None
        ts.pause("a", backup=backup)
        gc.collect()
        assert ref() is None
    ts.pause("untracked")
    assert ts.get("untracked") is None


def test_get_memory_saver_is_shared():
    assert get_memory_saver() is get_memory_saver()
    assert isinstance(get_memory_saver(), MemorySaver)
