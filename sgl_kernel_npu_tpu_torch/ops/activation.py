"""Activation fusions (counterpart of the JAX package's ops/activation.py):
`swiglu_quant`, the grouped-expert SwiGLU with per-row int8 quantisation,
and `swiglu_oai`, the interleaved clamped SwiGLU.

swiglu_quant: gate is the first half of x, up the second; with do_limit the
gate is min(silu(x1), limit) and up clip(x2, -limit, limit). Rows at or past
the total of group_list are zeroed. scale = absmax * f32(1/127) (the JAX
package divides by the constant 127, which XLA and the Pallas interpreter
both turn into that multiply), with no floor: a zero row has scale 0 and
divides by 1. q = floor(out / scale + 0.5), round half up, clipped to
[-128, 127]; this is not the half-to-even rint of ops/quant.py.

On a CUDA tensor `swiglu_quant` launches kernel K13 (csrc/swiglu_quant.cu);
on a CPU tensor it runs `swiglu_quant_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import use_kernel
from .quant import INV_INT8_MAX

# x, groups, n_groups, list_type, q, scale, S, N, x_f32, do_limit, limit, stream
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])


def total_rows_from_group_list(group_list, group_list_type: int):
    """The active row count, a 0-d int32 tensor: the last entry of a cumsum
    group list (type 0) or the sum of a count list (type 1)."""
    gl = group_list.to(torch.int32)
    return gl[-1] if group_list_type == 0 else gl.sum().to(torch.int32)


def _swiglu_core(x32, do_limit: bool, limit: float):
    half = x32.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    if do_limit:
        gate = torch.clamp(x1 * torch.sigmoid(x1), max=limit)
        up = torch.clamp(x2, -limit, limit)
        return gate * up
    return x1 * torch.sigmoid(x1) * x2


def swiglu_quant_ref(x, group_list, group_list_type=1, need_quant=True, do_limit=False,
                     limit=7.0):
    """Plain version of K13. x [S, 2N] -> (out [S, N] int8 (or x.dtype without
    need_quant), scale [S] f32); rows at or past the active total are 0."""
    s = x.shape[0]
    out = _swiglu_core(x.float(), do_limit, limit)
    total = total_rows_from_group_list(group_list, group_list_type)
    out = torch.where((torch.arange(s, device=x.device) < total)[:, None], out, 0.0)
    if not need_quant:
        return out.to(x.dtype), torch.zeros((s,), dtype=torch.float32, device=x.device)
    scale = out.abs().amax(dim=-1) * INV_INT8_MAX
    safe = torch.where(scale > 0, scale, 1.0)[:, None]
    q = torch.floor(out / safe + 0.5).clamp(-128, 127)
    return q.to(torch.int8), scale


def _swiglu_quant_cuda(x, group_list, do_limit: bool, limit: float, group_list_type: int = 1):
    """Launch K13 on x [S, 2N] bf16 or f32. `group_list` (on the card; type
    0: cumulative, any other: counts, so a one-element list of counts is the
    active row count itself, and an empty one is 0) is reduced by the
    kernel: no host sync, no launch of its own."""
    s, h2 = x.shape
    if h2 % 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"swiglu_quant: x {tuple(x.shape)} {x.dtype} needs an even width "
                         "and bf16 or f32")
    n = h2 // 2
    groups = group_list.reshape(-1).to(torch.int32).contiguous()
    cumulative = group_list_type == 0
    if cumulative and groups.numel() == 0:
        raise IndexError("swiglu_quant: a cumulative group list needs a last entry")
    q = torch.empty((s, n), dtype=torch.int8, device=x.device)
    scale = torch.empty((s,), dtype=torch.float32, device=x.device)
    if groups.device != x.device:
        raise ValueError(f"swiglu_quant: the group list is on {groups.device}, x on {x.device}")
    _build.check_operands("swiglu_quant", x.device, x, q, scale)
    if s == 0:
        return q, scale
    fn = _build.launcher("swiglu_quant", _ARGTYPES)
    code = fn(x.data_ptr(), groups.data_ptr(), groups.numel(), int(not cumulative),
              q.data_ptr(), scale.data_ptr(), s, n, int(x.dtype == torch.float32),
              int(do_limit), float(limit), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("swiglu_quant", code)
    _build.launches["swiglu_quant"] += 1
    return q, scale


def swiglu_quant(x, group_list, group_list_type=1, need_quant=True, do_limit=False,
                 limit=7.0):
    """SwiGLU + per-row int8 over the rows that group_list makes active
    (module docstring). Kernel K13 on the card when need_quant."""
    if need_quant and use_kernel(x):
        return _swiglu_quant_cuda(x.contiguous(), group_list, do_limit, limit, group_list_type)
    return swiglu_quant_ref(x, group_list, group_list_type, need_quant, do_limit, limit)


def swiglu_oai(hidden_states, alpha: float = 1.702, limit: float = 7.0):
    """Interleaved gate/up SwiGLU with clamp (gpt-oss style): gate =
    x[..., ::2] clamped above by limit, up = x[..., 1::2] clamped to
    +-limit, out = gate * sigmoid(gate * alpha) * (up + 1)."""
    x32 = hidden_states.float()
    gate = torch.clamp(x32[..., 0::2], max=limit)
    up = torch.clamp(x32[..., 1::2], -limit, limit)
    glu = gate * torch.sigmoid(gate * alpha)
    return ((up + 1.0) * glu).to(hidden_states.dtype)
