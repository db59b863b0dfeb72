import torch

from . import env  # noqa: F401
from .device import (  # noqa: F401
    H100,
    DeviceProperties,
    get_device_properties,
    resolve_device,
    use_kernel,
)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def index_copy_kept_(dst, index, src, keep):
    """dst.index_copy_(0, index[keep], src[keep]) without a host sync: a row
    that is not kept rewrites the first kept row's target with that row's
    value (the same bytes, so the duplicate index is harmless) or, when no
    row is kept, dst[0] with its current value. index [T] long, src [T, ...],
    keep [T] bool. The first kept row is picked with index_select, never by
    indexing with a 0-d tensor, which would read it on the host."""
    first = torch.argmax(keep.int()).reshape(1)
    any_keep = keep.index_select(0, first)
    src_row = torch.where(keep, torch.arange(keep.shape[0], device=keep.device), first)
    tgt = torch.where(any_keep, torch.where(keep, index, index.index_select(0, first)), 0)
    lead = (-1,) + (1,) * (src.dim() - 1)
    vals = torch.where(any_keep.reshape(lead), src[src_row].to(dst.dtype), dst[tgt])
    dst.index_copy_(0, tgt, vals)
