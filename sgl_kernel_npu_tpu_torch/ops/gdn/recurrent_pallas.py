"""The recurrent gated-delta-rule decode step (counterpart of the JAX
package's ops/gdn/recurrent_pallas.py): kernel K9 (csrc/gdn_recurrent.cu) on
the card, its plain version `delta_rule_step_ref` on the CPU. The state pool
(bf16 or f32, at K = V in WIDTHS) is updated in place, each touched state
read once and written once. The
gating stays in PyTorch (gating.py::fused_sigmoid_gating_delta_rule_update,
the JAX contract), as it stays in XLA there.

SKT_GDN_G and SKT_GDN_NBUF, the JAX kernel's loop shapes, have no
counterpart: K9 runs one block per (value head, sequence).
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...utils import index_copy_kept_, use_kernel
from .chunk import l2norm

# the head dims (K = V) and the pool dtypes K9 is instantiated for
WIDTHS = (32, 64, 128)
POOL_DTYPES = (torch.bfloat16, torch.float32)

# q, k, v, g, beta, pool, idx, out, B, H, HV, kd, vd, pool_rows, scale, l2norm,
# pool_f32, stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                            ctypes.c_int, ctypes.c_void_p])


def delta_rule_step_ref(q, k, v, g, beta, pool, indices, scale: float,
                        use_qk_l2norm: bool = True):
    """Plain version of kernel K9, in place on `pool`.

    q, k [B, H, K]; v [B, HV, V]; g, beta [B, HV] f32; pool [rows, HV, K, V]
    of any width and dtype; indices [B]. Row clamp(indices[b]) is read; it
    is written back only where indices[b] >= 0. Returns o [B, HV, V] f32,
    computed from the f32 state before it is cast to the pool's dtype."""
    bsz, h, kd = q.shape
    hv = v.shape[1]
    rep = hv // h
    qf, kf = q.float(), k.float()
    if use_qk_l2norm:
        qf, kf = l2norm(qf), l2norm(kf)
    heads = torch.arange(hv, device=q.device) // rep
    qf = (qf * scale)[:, heads]
    kf = kf[:, heads]
    vf = v.float()
    idx = indices.long()
    row = idx.clamp(0, pool.shape[0] - 1)
    s = pool[row].float() * torch.exp(g.float())[..., None, None]
    kv = torch.einsum("bhkv,bhk->bhv", s, kf)
    delta = (vf - kv) * beta.float()[..., None]
    s = s + kf[..., :, None] * delta[..., None, :]
    o = torch.einsum("bhkv,bhk->bhv", s, qf)
    index_copy_kept_(pool, row, s, idx >= 0)
    return o


def delta_rule_step(q, k, v, g, beta, pool, indices, scale: float, use_qk_l2norm: bool = True):
    """One gated-delta-rule step in place on `pool` (contract of
    delta_rule_step_ref): q, k [B, H, D]; v [B, HV, D]; g, beta [B, HV];
    pool [rows, HV, D, D] bf16 or f32, D in WIDTHS; indices [B] (< 0: read
    the clamped row, write nothing). Returns o [B, HV, D] f32. On the card:
    kernel K9, counted under "gdn_recurrent"."""
    if not use_kernel(q):
        return delta_rule_step_ref(q, k, v, g, beta, pool, indices, scale, use_qk_l2norm)
    bsz, h, kd = q.shape
    hv, vd = v.shape[1], v.shape[2]
    if (k.shape != q.shape or v.shape[0] != bsz or hv % h or kd != vd or kd not in WIDTHS
            or pool.shape[1:] != (hv, kd, vd)):
        raise ValueError(f"gdn_recurrent: q {tuple(q.shape)}, v {tuple(v.shape)}, pool "
                         f"{tuple(pool.shape)}: needs K = V in {WIDTHS} and HV a multiple "
                         f"of H")
    if pool.dtype not in POOL_DTYPES:
        raise TypeError(f"gdn_recurrent: the state pool must be bf16 or f32, not {pool.dtype}")
    dev = q.device
    qf, kf, vf = (t.float().contiguous() for t in (q, k, v))
    gf, bf = g.float().contiguous(), beta.float().contiguous()
    idx = indices.to(torch.int32).contiguous()
    _build.check_operands("gdn_recurrent", dev, qf, kf, vf, gf, bf, pool, idx)
    out = torch.empty((bsz, hv, vd), dtype=torch.float32, device=dev)
    fn = _build.launcher("gdn_recurrent", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), gf.data_ptr(), bf.data_ptr(),
              pool.data_ptr(), idx.data_ptr(), out.data_ptr(), bsz, h, hv, kd, vd,
              pool.shape[0], float(scale), int(use_qk_l2norm),
              int(pool.dtype == torch.float32), stream)
    _build.check("gdn_recurrent", code)
    _build.launches["gdn_recurrent"] += 1
    return out
