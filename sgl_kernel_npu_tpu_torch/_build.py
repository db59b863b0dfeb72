"""Build and load the port's CUDA kernels.

Each source under csrc/ is compiled by nvcc, on first use, into a shared
library with a plain C interface under build/torch_kernels/ at the root of the
checkout, and loaded with ctypes. A library's file name carries a hash of its
source and flags, so an edit rebuilds it and an unchanged source is reused.
`build()` starts one nvcc per missing library, all at once.

The launch counts live here too: every wrapper adds one to its kernel's count
where it launches it, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

KERNELS = ("w8a8_gemm", "prefill_tm", "decode_tm", "append_tm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

launches: Dict[str, int] = {name: 0 for name in KERNELS}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME/bin, /usr/local/cuda/bin, "
                       "PATH): the CUDA kernels cannot be built")


def _so_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every library of `names` that is not built yet, one nvcc
    process each, all started together. Returns {name: seconds} for the
    libraries it built; raises with the compiler's output on a failure."""
    todo = [n for n in names if not os.path.exists(_so_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = _so_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    times, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                          + log.decode(errors="replace"))
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_so_path(name))
        err = getattr(lib, f"skt_{name}_error")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def launcher(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C launcher `skt_<name>` of kernel `name`; it returns a cudaError_t."""
    fn = getattr(library(name), f"skt_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def check_operands(name: str, device, *tensors) -> None:
    """Raise unless every tensor is contiguous, on `device`, and starts on a
    16-byte boundary: the kernels load and store 16 bytes at a time."""
    for t in tensors:
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"kernel {name}: operands must be contiguous, "
                             f"16-byte aligned and on {device}; got "
                             f"{tuple(t.shape)} on {t.device}")


def check(name: str, code: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if code != 0:
        msg = getattr(_libs[name], f"skt_{name}_error")(code)
        raise RuntimeError(f"kernel {name}: CUDA error {code}: "
                           f"{msg.decode(errors='replace')}")
