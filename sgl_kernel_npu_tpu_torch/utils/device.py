"""Device selection, the kernel-or-plain rule, and H100 roofline numbers
(`H100`, and `get_device_properties` for the card a caller runs on).

The rule every wrapper follows (`use_kernel`): a tensor on a CUDA device
launches the hand-written kernel, a tensor on the CPU runs the plain PyTorch
version. Nothing else chooses. `SKT_IMPL=ref` is the one explicit override:
a caller who sets it gets the plain version on the card too (parity with the
JAX package's `use_pallas`). No entry point moves work to the CPU by itself.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, replace

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
    tf32_flops: float      # the tensor cores' TF32 products
    num_sms: int
    platform: str = "gpu"


# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
H100 = DeviceProperties(name="NVIDIA H100 SXM", hbm_bytes=80 * 10**9,
                        hbm_bytes_per_s=3.35e12, bf16_flops=989e12,
                        int8_ops=1979e12, f32_flops=67e12, tf32_flops=495e12, num_sms=132)


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


def _is_h100_sxm(name: str) -> bool:
    """True for the H100 SXM (reported as e.g. "NVIDIA H100 80GB HBM3"),
    the card whose data sheet `H100` holds; the PCIe and NVL parts run at
    other rates."""
    return "H100" in name and "PCIe" not in name and "NVL" not in name


def get_device_properties(device="cuda") -> DeviceProperties:
    """The device a caller runs on. On the card: its name, memory and SM
    count from torch.cuda.get_device_properties, with the H100 data-sheet
    rates of `H100` where the card is an H100 SXM and no rates (NaN) on any
    other card (no rate is measured here). device="cpu" describes the host:
    its memory and cores, and no rates, since a CPU run measures no device
    rate. Raises where CUDA is asked for and there is no card
    (resolve_device)."""
    nan = math.nan
    no_rates = dict(hbm_bytes_per_s=nan, bf16_flops=nan, int8_ops=nan, f32_flops=nan,
                    tf32_flops=nan)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return DeviceProperties(name="cpu", platform="cpu",
                                hbm_bytes=os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"),
                                num_sms=os.cpu_count() or 1, **no_rates)
    props = torch.cuda.get_device_properties(dev)
    card = replace(H100, name=props.name, hbm_bytes=props.total_memory,
                   num_sms=props.multi_processor_count)
    return card if _is_h100_sxm(props.name) else replace(card, **no_rates)


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return env.impl_mode() != "ref"
    raise ValueError(f"tensor on unsupported device {t.device}")
