"""Runtime env-var flags read by the port (the SKT_* table of the JAX
package's utils/env.py, limited to the readers this package uses; the boolean
and integer readers come back with the first flag that needs them).

  SKT_IMPL    "auto" | "ref" | "pallas"   kernel impl selection. In the port
              "ref" asks a wrapper to run its plain PyTorch version even on a
              CUDA tensor; "auto" and "pallas" launch the kernel there.
"""

from __future__ import annotations

import os


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def impl_mode() -> str:
    """Kernel implementation selection: auto, or forced 'ref' / 'pallas'."""
    mode = env_str("SKT_IMPL", "auto").lower()
    if mode not in ("auto", "ref", "pallas"):
        mode = "auto"
    return mode
