"""helloworld, the example op (counterpart of the JAX package's
ops/helloworld.py): a bf16 elementwise add, and the version stamp.

  helloworld_ref(x, y)  x + y
  helloworld(x, y)      on a CUDA tensor kernel K22 (csrc/helloworld.cu),
                        counted under "helloworld"; on a CPU tensor
                        helloworld_ref
  version_info()        "sgl_kernel_npu_tpu_torch <version> (<commit>)"

K22 adds in f32 and rounds once to bf16, as PyTorch's bf16 add does, so it
equals x + y bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import use_kernel
from ..version import __version__, git_commit

# x, y, out, n, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]


def helloworld_ref(x, y):
    return x + y


def helloworld(x, y):
    """x + y for bf16 x, y of one shape; the result in x's dtype."""
    if not use_kernel(x):
        return helloworld_ref(x, y)
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16 or x.shape != y.shape:
        raise ValueError(f"helloworld: bf16 operands of one shape expected, got "
                         f"{x.dtype} {tuple(x.shape)} and {y.dtype} {tuple(y.shape)}")
    _build.check_operands("helloworld", x.device, x, y)
    out = torch.empty_like(x)
    if x.numel():
        fn = _build.launcher("helloworld", _ARGTYPES)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check("helloworld", fn(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                                      x.numel(), stream))
        _build.launches["helloworld"] += 1
    return out


def version_info() -> str:
    return f"sgl_kernel_npu_tpu_torch {__version__} ({git_commit()})"
