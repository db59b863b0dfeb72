"""Native runtime bindings: paged-KV page pool, radix prefix cache and the
continuous-batching scheduler of csrc/runtime.cpp, through ctypes (the
port's own copy of the JAX package's runtime/__init__.py).

The C++ core is compiled by g++ on first use into build/torch_kernels/ at the
root of the checkout. A failed build raises: the serving engine never falls
back to `PyScheduler` by itself. `PyScheduler` is the pure-Python twin with
the same semantics, kept as the golden the native one is tested against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Optional, Tuple

from .._build import BUILD_DIR

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "csrc", "runtime.cpp")
_CXX = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_CXX).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"runtime-{digest[:12]}.so")


def build_native() -> ctypes.CDLL:
    """Compile (once) and load the native runtime; raises if g++ fails."""
    global _lib
    if _lib is not None:
        return _lib
    so = _so_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(_CXX + [_SRC, "-o", tmp], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ {_SRC} failed ({proc.returncode}):\n"
                               + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    i32p = ctypes.POINTER(ctypes.c_int32)
    sigs = {
        "skt_scheduler_create": (ctypes.c_void_p, [ctypes.c_int32] * 4),
        "skt_scheduler_destroy": (None, [ctypes.c_void_p]),
        "skt_free_pages": (ctypes.c_int32, [ctypes.c_void_p]),
        "skt_add_request": (ctypes.c_int64, [ctypes.c_void_p, i32p,
                                             ctypes.c_int32, ctypes.c_int32]),
        "skt_match_prefix": (ctypes.c_int32, [ctypes.c_void_p, i32p,
                                              ctypes.c_int32, i32p,
                                              ctypes.c_int32]),
        "skt_insert_prefix": (None, [ctypes.c_void_p, i32p, ctypes.c_int32,
                                     i32p, ctypes.c_int32]),
        "skt_alloc_pages": (ctypes.c_int32, [ctypes.c_void_p, ctypes.c_int32,
                                             i32p]),
        "skt_release_pages": (None, [ctypes.c_void_p, i32p, ctypes.c_int32]),
        "skt_evict_lru": (ctypes.c_int32, [ctypes.c_void_p, ctypes.c_int32]),
        "skt_retain_pages": (None, [ctypes.c_void_p, i32p, ctypes.c_int32]),
        "skt_schedule_step": (ctypes.c_int32, [ctypes.c_void_p, i32p,
                                               ctypes.c_int32]),
        "skt_commit_progress": (None, [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_int32]),
        "skt_finish_request": (None, [ctypes.c_void_p, ctypes.c_int64]),
        "skt_activate_request": (None, [ctypes.c_void_p, ctypes.c_int64]),
        "skt_num_requests": (ctypes.c_int32, [ctypes.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


def _arr(values):
    return (ctypes.c_int32 * len(values))(*[int(v) for v in values])


class NativeScheduler:
    """ctypes facade over the C++ scheduler."""

    def __init__(self, num_pages: int, page_size: int, max_batch: int = 256,
                 token_budget: int = 4096):
        self._lib = build_native()
        self._h = ctypes.c_void_p(self._lib.skt_scheduler_create(
            num_pages, page_size, max_batch, token_budget))
        self.page_size = page_size

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.skt_scheduler_destroy(self._h)

    def free_pages(self) -> int:
        return self._lib.skt_free_pages(self._h)

    def add_request(self, tokens: List[int], max_new_tokens: int) -> int:
        return self._lib.skt_add_request(self._h, _arr(tokens), len(tokens),
                                         max_new_tokens)

    def match_prefix(self, tokens: List[int]) -> Tuple[int, List[int]]:
        out = (ctypes.c_int32 * 1024)()
        n = self._lib.skt_match_prefix(self._h, _arr(tokens), len(tokens),
                                       out, 1024)
        return n, list(out[: n // self.page_size])

    def insert_prefix(self, tokens: List[int], pages: List[int]):
        self._lib.skt_insert_prefix(self._h, _arr(tokens), len(tokens),
                                    _arr(pages), len(pages))

    def alloc_pages(self, count: int) -> List[int]:
        out = (ctypes.c_int32 * count)()
        n = self._lib.skt_alloc_pages(self._h, count, out)
        return list(out[:n])

    def release_pages(self, pages: List[int]):
        self._lib.skt_release_pages(self._h, _arr(pages), len(pages))

    def retain_pages(self, pages: List[int]):
        self._lib.skt_retain_pages(self._h, _arr(pages), len(pages))

    def evict_lru(self, need: int) -> int:
        return self._lib.skt_evict_lru(self._h, need)

    def schedule_step(self, max_entries: int = 256):
        out = (ctypes.c_int32 * (max_entries * 5))()
        n = self._lib.skt_schedule_step(self._h, out, max_entries)
        entries = []
        for i in range(n):
            rid = (out[i * 5] & 0xFFFFFFFF) | (out[i * 5 + 1] << 32)
            entries.append({
                "req_id": rid,
                "kind": "prefill" if out[i * 5 + 2] == 0 else "decode",
                "start": out[i * 5 + 3],
                "len": out[i * 5 + 4],
            })
        return entries

    def commit_progress(self, req_id: int, kind: str, count: int):
        self._lib.skt_commit_progress(self._h, req_id,
                                      0 if kind == "prefill" else 1, count)

    def finish_request(self, req_id: int):
        self._lib.skt_finish_request(self._h, req_id)

    def activate_request(self, req_id: int):
        """Admit without prefill admission (the engine allocates pages up front)."""
        self._lib.skt_activate_request(self._h, req_id)

    def num_requests(self) -> int:
        return self._lib.skt_num_requests(self._h)


class PyScheduler:
    """Pure-Python twin with identical semantics (golden for the native one)."""

    def __init__(self, num_pages: int, page_size: int, max_batch: int = 256,
                 token_budget: int = 4096):
        self.page_size = page_size
        self.max_batch = max_batch
        self.token_budget = token_budget
        self._free = list(range(num_pages - 1, -1, -1))
        self._ref = [0] * num_pages
        self._reqs = {}
        self._next = 1
        self._cache = {}  # tuple(chunk path) -> page
        self._atime = {}  # tuple(chunk path) -> last access clock
        self._clock = 0

    def free_pages(self):
        return len(self._free)

    def add_request(self, tokens, max_new_tokens):
        rid = self._next
        self._next += 1
        self._reqs[rid] = {
            "tokens": list(tokens), "prefilled": 0, "decoded": 0,
            "max_new": max_new_tokens, "pages": [], "active": False,
        }
        return rid

    def match_prefix(self, tokens):
        ps = self.page_size
        matched, pages, path = 0, [], ()
        self._clock += 1
        for off in range(0, len(tokens) - ps + 1, ps):
            path = path + (tuple(tokens[off:off + ps]),)
            if path not in self._cache:
                break
            pages.append(self._cache[path])
            self._atime[path] = self._clock
            matched += ps
        return matched, pages

    def insert_prefix(self, tokens, pages):
        ps = self.page_size
        path = ()
        for i, off in enumerate(range(0, len(tokens) - ps + 1, ps)):
            if i >= len(pages):
                break
            path = path + (tuple(tokens[off:off + ps]),)
            if path not in self._cache:
                self._cache[path] = pages[i]
                self._ref[pages[i]] += 1
            self._clock += 1
            self._atime[path] = self._clock

    def evict_lru(self, need):
        freed = 0
        while freed < need:
            leaves = [p for p in self._cache
                      if not any(q[: len(p)] == p and len(q) > len(p)
                                 for q in self._cache)
                      and self._ref[self._cache[p]] == 1]
            if not leaves:
                break
            victim = min(leaves, key=lambda p: self._atime.get(p, 0))
            page = self._cache.pop(victim)
            self._atime.pop(victim, None)
            self._ref[page] -= 1
            if self._ref[page] == 0:
                self._free.append(page)
            freed += 1
        return freed

    def alloc_pages(self, count):
        out = []
        while len(out) < count:
            if not self._free and self.evict_lru(count - len(out)) == 0:
                break
            if not self._free:
                break
            p = self._free.pop()
            self._ref[p] = 1
            out.append(p)
        return out

    def release_pages(self, pages):
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)

    def retain_pages(self, pages):
        for p in pages:
            self._ref[p] += 1

    def schedule_step(self, max_entries: int = 256):
        entries = []
        budget = self.token_budget
        for rid in sorted(self._reqs):
            r = self._reqs[rid]
            if len(entries) >= min(max_entries, self.max_batch):
                break
            if not r["active"] or r["prefilled"] < len(r["tokens"]):
                continue
            if r["decoded"] >= r["max_new"]:
                continue
            entries.append({"req_id": rid, "kind": "decode",
                            "start": len(r["tokens"]) + r["decoded"], "len": 1})
            budget -= 1
        for rid in sorted(self._reqs):
            r = self._reqs[rid]
            if len(entries) >= min(max_entries, self.max_batch) or budget <= 0:
                break
            rem = len(r["tokens"]) - r["prefilled"]
            if rem <= 0:
                continue
            if not r["active"]:
                if len(self._free) < 1:
                    continue
                r["active"] = True
            chunk = min(rem, budget)
            entries.append({"req_id": rid, "kind": "prefill",
                            "start": r["prefilled"], "len": chunk})
            budget -= chunk
        return entries

    def commit_progress(self, rid, kind, count):
        r = self._reqs.get(rid)
        if not r:
            return
        r["prefilled" if kind == "prefill" else "decoded"] += count

    def activate_request(self, rid):
        if rid in self._reqs:
            self._reqs[rid]["active"] = True

    def finish_request(self, rid):
        r = self._reqs.pop(rid, None)
        if r:
            self.release_pages(r["pages"])

    def num_requests(self):
        return len(self._reqs)


# The reference package's name for building the scheduler. A failed native
# build raises (build_native); it is never swapped for PyScheduler.
make_scheduler = NativeScheduler
