"""Device selection, the kernel-or-plain rule, and H100 roofline numbers.

The rule every wrapper follows (`use_kernel`): a tensor on a CUDA device
launches the hand-written kernel, a tensor on the CPU runs the plain PyTorch
version. Nothing else chooses. `SKT_IMPL=ref` is the one explicit override:
a caller who sets it gets the plain version on the card too (parity with the
JAX package's `use_pallas`). No entry point moves work to the CPU by itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import env


@dataclass(frozen=True)
class DeviceProperties:
    name: str
    hbm_bytes: int
    hbm_bytes_per_s: float
    bf16_flops: float
    int8_ops: float
    f32_flops: float       # outside the tensor cores
    num_sms: int


# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
H100 = DeviceProperties(name="NVIDIA H100 SXM", hbm_bytes=80 * 10**9,
                        hbm_bytes_per_s=3.35e12, bf16_flops=989e12,
                        int8_ops=1979e12, f32_flops=67e12, num_sms=132)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Raises when CUDA is asked for and
    none is present; never substitutes the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return env.impl_mode() != "ref"
    raise ValueError(f"tensor on unsupported device {t.device}")
