"""W8A8 INT8 GEMM out of a stacked per-layer weight bank (counterpart of the
JAX package's ops/matmul.py::quant_matmul_int8_stacked, whose 3-D bank branch
runs the TPU kernel grouped_matmul_int8_pallas).

On a CUDA tensor the wrapper launches kernel A (csrc/w8a8_gemm.cu); on a CPU
tensor it runs the plain version, `quant_matmul_int8_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import cdiv, use_kernel

_BK, _BN = 64, 128       # the kernel's K stage and N tile
# x, w, x_scale, w_scale, out, workspace, M, N, K, li, splits, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def quant_matmul_int8_ref(x_q, w_q, x_scale, w_scale, out_dtype=torch.bfloat16):
    """out = (x_q @ w_q) * x_scale * w_scale.

    x_q [M, K] int8, w_q [K, N] int8, x_scale [M, 1] f32, w_scale [N] f32.
    The product runs in float64: every partial sum is an integer below 2**53,
    so it is exact in any order (an int8 product would wrap, and CUDA has no
    int32 matmul); the f64 -> f32 step rounds as int32 -> f32 does."""
    acc = (x_q.double() @ w_q.double()).float()
    return (acc * x_scale.float() * w_scale.float()[None, :]).to(out_dtype)


def quant_matmul_int8_stacked(x_q, w_q_stacked, li: int, x_scale,
                              w_scale_stacked, out_dtype=torch.bfloat16):
    """Layer li of a stacked bank: x_q [M, K] int8, w_q_stacked [L, K, N] int8,
    x_scale [M, 1] f32, w_scale_stacked [L, N] f32 -> [M, N]."""
    if use_kernel(x_q):
        return _w8a8_gemm(x_q, w_q_stacked, li, x_scale, w_scale_stacked,
                          out_dtype)
    return quant_matmul_int8_ref(x_q, w_q_stacked[li], x_scale,
                                 w_scale_stacked[li], out_dtype)


def _splits(m: int, n: int, k: int, device) -> int:
    """Split K over blocks when the output has too few tiles to keep every
    SM streaming weights (decode); int32 partial sums stay exact."""
    if m > 64:
        return 1
    tiles = cdiv(n, _BN) * cdiv(m, 16 if m <= 16 else 64)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(cdiv(2 * sms, tiles), k // _BK))


def _w8a8_gemm(x_q, w, li, x_scale, w_scale, out_dtype):
    m, k = x_q.shape
    l, k2, n = w.shape
    dev = x_q.device
    if out_dtype != torch.bfloat16:
        raise ValueError(f"w8a8_gemm writes bf16, not {out_dtype}")
    if (x_q.dtype, w.dtype) != (torch.int8, torch.int8):
        raise TypeError(f"w8a8_gemm takes int8 operands, got {x_q.dtype}, {w.dtype}")
    if k2 != k or k % _BK or n % 16 or not 0 <= li < l:
        raise ValueError(f"w8a8_gemm: x {tuple(x_q.shape)}, bank {tuple(w.shape)}, "
                         f"li={li}: needs K % {_BK} == 0, N % 16 == 0")
    xs = x_scale.reshape(m).float().contiguous()
    ws = w_scale.float().contiguous()
    _build.check_operands("w8a8_gemm", dev, x_q, w, xs, ws)
    if ws.shape != (l, n):
        raise ValueError(f"w8a8_gemm: weight scales {tuple(ws.shape)} != {(l, n)}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return out
    splits = _splits(m, n, k, dev)
    work = (torch.empty((m, n), dtype=torch.int32, device=dev) if splits > 1
            else None)
    fn = _build.launcher("w8a8_gemm", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(x_q.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
              out.data_ptr(), work.data_ptr() if work is not None else None,
              m, n, k, li, splits, stream)
    _build.check("w8a8_gemm", code)
    _build.launches["w8a8_gemm"] += 1
    return out
