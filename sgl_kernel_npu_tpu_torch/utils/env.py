"""Runtime env-var flags read by the port (the SKT_* table of the JAX
package's utils/env.py, limited to the flags this package reads).

  SKT_IMPL    "auto" | "ref" | "pallas"   kernel impl selection. In the port
              "ref" asks a wrapper to run its plain PyTorch version even on a
              CUDA tensor; "auto" and "pallas" launch the kernel there.
  SKT_GEMM_BN int, default 512: panel width of the pretiled weight banks
              (models/llama.py::pretile_big_weights).
"""

from __future__ import annotations

import os
from typing import Optional

_TRUE = ("1", "true", "yes", "on")


def env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in _TRUE


def env_int(name: str, default: int, lo: Optional[int] = None, hi: Optional[int] = None) -> int:
    v = os.environ.get(name)
    if v is None:
        out = default
    else:
        try:
            out = int(v)
        except ValueError:
            out = default
    if lo is not None:
        out = max(lo, out)
    if hi is not None:
        out = min(hi, out)
    return out


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def impl_mode() -> str:
    """Kernel implementation selection: auto, or forced 'ref' / 'pallas'."""
    mode = env_str("SKT_IMPL", "auto").lower()
    if mode not in ("auto", "ref", "pallas"):
        mode = "auto"
    return mode
