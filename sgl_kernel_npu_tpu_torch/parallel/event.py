"""EventOverlap + FuseMode (counterpart of the JAX package's
parallel/event.py).

PyTorch orders work on one stream by issue order, so a consumer on the
stream that issued a dispatch needs no wait. EventOverlap holds an optional
CUDA event and the tensors whose production it stands for;
`current_stream_wait()` makes the current stream wait on the event (a
consumer on another stream), and does nothing without one.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence

import torch


class FuseMode(enum.IntEnum):
    """Fusion-mode selector for Buffer.fused_deep_moe."""
    NONE = 0
    FUSED_DEEP_MOE = 1
    DISPATCH_FFN_COMBINE = 2


class EventOverlap:
    """Completion token for overlapped comm."""

    def __init__(self, event: Optional[object] = None,
                 extra_tensors: Optional[Sequence[torch.Tensor]] = None):
        self.event = event
        self.extra_tensors = tuple(extra_tensors or ())

    def current_stream_wait(self) -> None:
        if self.event is not None:
            torch.cuda.current_stream().wait_event(self.event)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.current_stream_wait()
        return False
