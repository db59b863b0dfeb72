#!/usr/bin/env python3
"""Compare the machine code of csrc/ sources between two checkouts.

  python3 scripts/compare_sass.py [--pair REGEX_A=REGEX_B ...] ROOT_A ROOT_B [SOURCE ...]

Compiles each source (default: the users of decode_tm_core.cuh) of both
roots to a cubin with the package's nvcc flags, disassembles every kernel
with cuobjdump -sass and prints, per kernel, whether the instruction
streams are equal (addresses and comments dropped), and ptxas's registers,
spills and shared memory for each root. --pair compares the one kernel of
A whose mangled name matches REGEX_A with the one of B that matches
REGEX_B, where a template made the names differ (for example K17's
laser_kernel and its laser_kernel<128, 128, bf16>). Exits 1 if a kernel
that both roots have, or a pair, differs. Needs nvcc and cuobjdump (the CUDA toolkit); about a
minute for the default sources.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

DEFAULT = ("decode_tm", "decode_tm2", "decode_v3", "decode_v6", "decode_v7", "decode_hm")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC")


def _cuda_bin(tool):
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", tool)


def _plain_name(mangled):
    """A kernel's mangled name without its anonymous namespace, whose tag
    hashes the source's path."""
    return re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_", "", mangled)


def compile_sass(root, source, out_dir):
    """{kernel name: [instructions]} and {kernel: ptxas line} of one source."""
    src = os.path.join(root, "sgl_kernel_npu_tpu_torch", "csrc", source + ".cu")
    tag = re.sub(r"\W", "_", os.path.abspath(root))
    cubin = os.path.join(out_dir, f"{tag}_{source}.cubin")
    p = subprocess.run([_cuda_bin("nvcc"), *FLAGS, "-cubin", "-Xptxas", "-v", "-o", cubin, src],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc {src} failed:\n{p.stderr[-4000:]}")
    usage, fn = {}, None
    for line in p.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = _plain_name(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = line.split("ptxas info    :")[-1].strip()
        if "spill stores" in line and fn:
            usage[fn + " spills"] = line.split(":")[-1].strip()
    dump = subprocess.run([_cuda_bin("cuobjdump"), "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    kernels, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _plain_name(m.group(1))
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
        if m and name:
            kernels[name].append(m.group(1).strip())
    return kernels, usage


def _pair(ka, kb, pair):
    """The names of the one kernel of ka matching pair's REGEX_A and the one
    of kb matching its REGEX_B, or None."""
    ra, rb = pair.split("=", 1)
    na = [k for k in ka if re.search(ra, k)]
    nb = [k for k in kb if re.search(rb, k)]
    return (na[0], nb[0]) if len(na) == 1 and len(nb) == 1 else None


def main() -> int:
    args = sys.argv[1:]
    pairs = []
    while args[:1] == ["--pair"]:
        pairs.append(args[1])
        args = args[2:]
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b, sources = args[0], args[1], args[2:] or DEFAULT
    differ = False
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as pool:
        jobs = {(r, s): pool.submit(compile_sass, r, s, tmp) for s in sources for r in (a, b)}
        for s in sources:
            (ka, ua), (kb, ub) = jobs[(a, s)].result(), jobs[(b, s)].result()
            for pair in pairs:
                names = _pair(ka, kb, pair)
                if names is None:
                    continue
                x, y = names
                same = ka[x] == kb[y]
                differ |= not same
                ndiff = sum(p != q for p, q in zip(ka[x], kb[y])) + abs(len(ka[x]) - len(kb[y]))
                print(f"{s}: pair {x} / {y}: "
                      f"{'SASS equal' if same else f'SASS differs ({ndiff} lines)'}, "
                      f"{len(ka[x])} / {len(kb[y])} instructions; A {ua.get(x, '?')} "
                      f"[{ua.get(x + ' spills', '')}]; B {ub.get(y, '?')} "
                      f"[{ub.get(y + ' spills', '')}]")
                for n in [n for n, (p, q) in enumerate(zip(ka[x], kb[y])) if p != q][:4]:
                    for m in range(max(0, n - 3), min(len(ka[x]), n + 4)):
                        mark = ">" if m == n else " "
                        print(f"   {mark} {m:5d} A: {ka[x][m]}")
                        if m == n:
                            print(f"   {mark} {m:5d} B: {kb[y][m]}")
            for k in sorted(set(ka) | set(kb)):
                if k not in ka or k not in kb:
                    u = ua if k in ka else ub
                    print(f"{s}: {k}: only in {'A' if k in ka else 'B'} ({u.get(k, '')}; "
                          f"{u.get(k + ' spills', '')})")
                    continue
                same = ka[k] == kb[k]
                differ |= not same
                ndiff = sum(x != y for x, y in zip(ka[k], kb[k])) + abs(len(ka[k]) - len(kb[k]))
                print(f"{s}: {k}: {'SASS equal' if same else f'SASS differs ({ndiff} lines)'}, "
                      f"{len(ka[k])} / {len(kb[k])} instructions; A {ua.get(k, '?')} "
                      f"[{ua.get(k + ' spills', '')}]; B {ub.get(k, '?')} "
                      f"[{ub.get(k + ' spills', '')}]")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
