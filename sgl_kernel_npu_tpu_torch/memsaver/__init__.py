"""Memory saver: pause / resume device memory by tag, for weight swaps in
RL loops (counterpart of the JAX package's memsaver/; the reference's
contrib/torch_memory_saver keeps virtual addresses and unmaps the physical
pages).

The port keeps the JAX package's contract: the tensors of a tree are
tracked under a tag; `pause(tag)` stages them to pinned host memory
(backup=True) or drops them (backup=False; `resume` then needs `values=`),
and drops the saver's reference, so that once the caller holds no other
reference the device memory is freed and released from PyTorch's cache
(torch.cuda.empty_cache); `resume(tag)` copies the tree back, each tensor
to the device it came from, and returns it. Addresses are not kept: resume
returns new tensors, which the caller rebinds, as the JAX caller rebinds its
arrays. A tree is a tensor, or a dict, list or tuple of trees.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of t in host memory, pinned where t lies on the card."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.device.type == "cuda")
    return host.copy_(t)


class MemorySaver:
    """Tag-scoped pause / resume of device tensors (the reference's
    entrypoint API: region, track, pause, resume, get)."""

    def __init__(self):
        self._regions: Dict[str, Any] = {}
        self._paused: Dict[str, Any] = {}
        self._devices: Dict[str, Any] = {}
        self._current_tag: Optional[str] = None

    @contextlib.contextmanager
    def region(self, tag: str = "default"):
        """Within the block, `track` without a tag files under `tag`."""
        self._current_tag = tag
        try:
            yield self
        finally:
            self._current_tag = None

    def track(self, tree, tag: Optional[str] = None):
        """Track a tree of tensors under a tag; returns it unchanged."""
        tag = tag or self._current_tag or "default"
        self._regions[tag] = tree
        self._devices[tag] = _tree_map(lambda t: t.device, tree)
        return tree

    def pause(self, tag: str = "default", backup: bool = True):
        """Release the tag's device memory. backup=True stages the tensors to
        pinned host memory first; False drops them (resume then needs
        values=). An untracked or already paused tag is left as it is."""
        tree = self._regions.get(tag)
        if tree is None:
            return
        self._paused[tag] = _tree_map(_to_host, tree) if backup else None
        self._regions[tag] = None
        del tree
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def resume(self, tag: str = "default", values=None):
        """Restore the tag's tensors, each on the device it was tracked on,
        from the host backup or from `values` (a tree of the same shape);
        returns the restored tree."""
        staged = values if values is not None else self._paused.get(tag)
        if staged is None:
            raise ValueError(f"tag {tag!r} was paused without backup; pass values=")
        restored = _tree_map(lambda t, dev: torch.as_tensor(t).to(dev), staged,
                             self._devices[tag])
        self._regions[tag] = restored
        self._paused[tag] = None
        return restored

    def get(self, tag: str = "default"):
        """The tag's tree while resident, None while paused."""
        return self._regions.get(tag)


_global_saver = MemorySaver()


def get_memory_saver() -> MemorySaver:
    """The process's shared saver, as in the reference."""
    return _global_saver
