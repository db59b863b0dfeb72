"""Build and load the port's CUDA kernels.

Each source under csrc/ is compiled by nvcc, on first use, into a shared
library with a plain C interface under build/torch_kernels/ at the root of the
checkout, and loaded with ctypes. A library's file name carries a hash of its
source, of the shared headers (csrc/*.cuh) and of the flags, so an edit
rebuilds it and an unchanged source is reused. `build()` starts one nvcc per
missing library, all at once.

A source may export more than one kernel (`KERNELS` maps each kernel to its
source); every kernel has its own C launcher `skt_<kernel>`, and every
library its error-string function `skt_<source>_error`.

The launch counts live here too: every wrapper adds one to its kernel's count
where it launches it, and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

# kernel -> the csrc/<source>.cu that exports it
KERNELS = {
    "w8a8_gemm": "w8a8_gemm_tiled",    # A
    "prefill_tm": "prefill_tm",        # B
    "decode_tm": "decode_tm",          # C
    "append_tm": "append_mla",         # D, on K6's copy loop
    "w8a8_gemm_tiled": "w8a8_gemm_tiled",  # K1
    "rmsq_gemm": "rmsq_gemm",          # K2
    "decode_tm2": "decode_tm2",        # K3
    "append_tm2": "append_tm2",        # K4
    "decode_mla_c": "decode_mla_c",    # K5
    "append_mla": "append_mla",        # K6
    "decode_mla": "decode_mla",        # K7
    "w8a8_gemm_grouped": "w8a8_gemm",  # K8
    "gdn_recurrent": "gdn_recurrent",  # K9
    "decode_hm": "decode_hm",          # K10
    "decode_hm256": "decode_hm",       # K10 at head dim 256
    "decode_hm_f32": "decode_hm_f32",  # K10 on f32 pages
    "fused_moe": "fused_moe",          # K11
    "remote_scatter": "remote_scatter",  # K12
    "swiglu_quant": "swiglu_quant",    # K13
    "decode_v6_defer": "decode_v6",    # K14, bf16 pages
    "decode_v6_int8_defer": "decode_v6",  # K14, int8 pages
    "prefill_hm": "prefill_hm",        # K15
    "decode_v3": "decode_v3",          # K16, one counter per contract
    "decode_v3_int8": "decode_v3",
    "decode_v3_defer": "decode_v3",
    "decode_v3_int8_defer": "decode_v3",
    "decode_int8kv": "decode_v3",
    "laser_attention": "laser_attention",      # K17
    "laser_attention_general": "laser_attention_general",  # K17, split-TF32 route
    "sparse_estimate": "sparse_estimate",      # K18
    "topk_block_sparse": "topk_sparse",        # K19
    "add_rmsnorm_quant": "add_rmsnorm_quant",  # K20
    "wfp8a16_gemm": "wfp8a16_gemm",            # K21, dense
    "wfp8a16_gemm_grouped": "wfp8a16_gemm",    # K21, per-m-tile expert map
    "helloworld": "helloworld",                # K22
    "decode_v5_defer": "decode_v3",            # K23, one counter per contract
    "decode_v5_int8_defer": "decode_v3",
    "decode_v4b_int8": "decode_v3",
    "decode_fused_v4_int8": "decode_v3",
    "decode_fused_v4": "decode_v3",
    "decode_v7_int8": "decode_v7",             # K24
}
SOURCES = tuple(dict.fromkeys(KERNELS.values()))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# kernel A launched by quant_matmul_int8 on a plain [K, N] weight (the L = 1
# contract) counts apart from kernel A on a stacked bank, and K2 in its
# per_tensor mode apart from K2 in its per_token mode
launches: Dict[str, int] = {name: 0 for name in (*KERNELS, "w8a8_gemm_l1",
                                                 "rmsq_gemm_pt")}
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library (source name) of `names` that is not built yet,
    one nvcc process each, all started together. Returns {name: seconds} for
    the libraries it built; raises with the compiler's output on a failure."""
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


def library(source: str) -> ctypes.CDLL:
    """The loaded library of csrc/<source>.cu, built first if needed."""
    lib = _libs.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(_so_path(source))
        err = getattr(lib, f"skt_{source}_error")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _libs[source] = lib
    return lib


def launcher(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C launcher `skt_<name>` of kernel `name`; it returns a cudaError_t."""
    fn = getattr(library(KERNELS[name]), f"skt_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def query(name: str, what: str, *args: int) -> int:
    """The answer of kernel `name`'s C function `skt_<name>_<what>` on int
    arguments: a size of its launch on the current device, or minus a
    cudaError_t, which raises."""
    fn = getattr(library(KERNELS[name]), f"skt_{name}_{what}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args)
    n = fn(*args)
    if n < 0:
        check(name, -n)
    return n


def splits(name: str, *args: int) -> int:
    """How many blocks kernel `name` splits each row over on the current
    device (its C function `skt_<name>_splits`, which sizes them from the
    card's SM count)."""
    n = query(name, "splits", *args)
    if n == 0:
        check(name, 1)
    return n


# kernel name -> device index -> every counter buffer handed out (a CUDA
# graph may keep using any of them, so none is freed)
_arrivals: Dict[str, Dict[int, list]] = {}


def arrival_counters(name: str, device, n: int):
    """At least `n` int32 arrival counters of kernel `name` on `device`,
    zeroed once when they are made. A split kernel's last block to arrive
    at a row resets that row's counter to 0, so no call zeroes them again;
    the calls of one kernel on a device go in stream order."""
    import torch
    bufs = _arrivals.setdefault(name, {}).setdefault(device.index or 0, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32, device=device))
    return bufs[-1]


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
        source = KERNELS[name]
        msg = getattr(_libs[source], f"skt_{source}_error")(code)
        raise RuntimeError(f"kernel {name}: CUDA error {code}: "
                           f"{msg.decode(errors='replace')}")
