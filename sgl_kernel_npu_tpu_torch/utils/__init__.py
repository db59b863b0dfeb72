from . import env  # noqa: F401
from .device import (  # noqa: F401
    H100,
    DeviceProperties,
    resolve_device,
    use_kernel,
)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
