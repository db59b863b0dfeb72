"""Continuous-batching serving engine: native scheduler + paged KV + model
steps (counterpart of the JAX package's serving.py: LlamaEngine on int8
token-major pages or page-major ("hm") pages, bf16 or int8, MlaEngine on
split bf16 latent pages).

The C++ scheduler (runtime/) assembles prefill and decode entries under a
token budget; the page pool and radix prefix cache manage the pages;
prefill chunks of a step run as ONE padded [S, T] batch (S and T rounded up
to powers of 2, as the JAX engine buckets its compiles) and decode runs one
padded batch of `decode_batch` rows. Greedy decoding only.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .models import deepseek_mla, llama
from .runtime import NativeScheduler
from .utils import resolve_device


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class LlamaEngine:
    def __init__(self, cfg: llama.LlamaConfig, params=None, num_pages: int = 256,
                 decode_batch: int = 8, token_budget: int = 256, seed: int = 0,
                 temperature: float = 0.0, max_pages: int | None = None,
                 kv_layout: str | None = None, device="cuda"):
        """kv_layout: the Llama KV layout, "tm" or "hm"; None picks tm iff
        llama.tm_layout_ok(cfg) (an int8 cache and the flat deferred decode),
        else hm, as the JAX engine does."""
        if temperature > 0.0:
            raise NotImplementedError(
                "sampling (temperature > 0) comes with ops/sampling.py in a "
                "later slice of the port; this engine is greedy")
        self.cfg = cfg
        self.kv_layout = kv_layout
        self.device = resolve_device(device)
        self.sched = NativeScheduler(num_pages, cfg.page_size,
                                     token_budget=token_budget)
        self.decode_batch = decode_batch
        self.reqs: Dict[int, dict] = {}
        # block tables are padded to max_pages; admission checks a request
        # fits (a truncated table would attend over wrong pages)
        self.max_pages = (max(1, num_pages // max(1, decode_batch))
                          if max_pages is None else max_pages)
        self._setup_model(cfg, params, num_pages, seed)

    def _setup_model(self, cfg, params, num_pages, seed):
        """Model hook: set self.params, self.kv and the two step functions
        `_decode(ids, pos, seq, bt, slots) -> (logits [B, V], kv)` and
        `_prefill_batch(ids, vl, pos, slots, bts, plens) -> (logits [S, T, V],
        kv)`, which update self.kv in place. Subclasses adapt other model
        families."""
        self.params = (params if params is not None
                       else llama.init_params(cfg, seed, self.device))
        layout = self.kv_layout or ("tm" if llama.tm_layout_ok(cfg) else "hm")
        self.kv = llama.init_kv_cache(cfg, num_pages, layout=layout,
                                      device=self.device)
        self._decode = lambda *a: llama.decode_step_kv(self.params, cfg,
                                                       self.kv, *a)
        self._prefill_batch = lambda *a: llama.prefill_batch_step_kv(
            self.params, cfg, self.kv, *a)

    def add_request(self, tokens: List[int], max_new_tokens: int = 16,
                    stop_token_ids=None, token_bitmask=None,
                    lora_id: int = -1) -> int:
        """stop_token_ids: generation ends early on any of these ids."""
        if token_bitmask is not None:
            raise NotImplementedError(
                "token_bitmask (grammar-constrained decoding) comes with "
                "ops/grammar.py in a later slice of the port")
        if lora_id >= 0:
            raise NotImplementedError(
                "multi-LoRA serving comes with ops/lora.py in a later slice "
                "of the port")
        ps = self.cfg.page_size
        rid = self.sched.add_request(tokens, max_new_tokens)
        # radix prefix cache: reuse cached pages of the shared prefix and skip
        # prefilling it (never the final, partially filled page)
        matched, cached_pages = self.sched.match_prefix(tokens)
        usable = min(matched, max(0, len(tokens) - 1) // ps * ps)
        cached_pages = cached_pages[: usable // ps]
        self.sched.retain_pages(cached_pages)
        total_pages = -(-(len(tokens) + max_new_tokens) // ps)
        if total_pages > self.max_pages:
            self.sched.release_pages(cached_pages)
            self.sched.finish_request(rid)
            raise ValueError(
                f"request needs {total_pages} pages > max_pages="
                f"{self.max_pages}; raise max_pages or shorten the request")
        need = total_pages - len(cached_pages)
        fresh = self.sched.alloc_pages(need)
        if len(fresh) < need:
            self.sched.release_pages(fresh + cached_pages)
            self.sched.finish_request(rid)
            raise RuntimeError(
                f"KV page pool exhausted: need {need} pages, got {len(fresh)}")
        # page allocation is admission: activate explicitly
        self.sched.activate_request(rid)
        self.reqs[rid] = {"tokens": list(tokens), "out": [],
                          "pages": cached_pages + fresh, "len": usable,
                          "max_new": max_new_tokens, "cached": usable,
                          "stop": set(stop_token_ids or ())}
        if usable:
            self.sched.commit_progress(rid, "prefill", usable)
        return rid

    def pause_request(self, rid: int):
        raise NotImplementedError(
            "pause/resume (host KV offload) comes in a later slice of the port")

    def resume_request(self, rid: int) -> int:
        raise NotImplementedError(
            "pause/resume (host KV offload) comes in a later slice of the port")

    def _slot(self, r, pos):
        ps = self.cfg.page_size
        return r["pages"][pos // ps] * ps + pos % ps

    def _tensor(self, a):
        return torch.from_numpy(a).to(self.device)

    def step(self) -> bool:
        """One scheduler tick. Returns True while work remains."""
        entries = self.sched.schedule_step()
        if not entries:
            return False
        ps = self.cfg.page_size

        pre = [e for e in entries if e["kind"] == "prefill"]
        if pre:
            sb = _bucket(len(pre))
            tb = _bucket(max(e["len"] for e in pre))
            ids = np.zeros((sb, tb), np.int32)
            vl = np.zeros(sb, np.int32)
            pos = np.zeros((sb, tb), np.int32)
            slp = np.full((sb, tb), -1, np.int32)
            bts = np.zeros((sb, self.max_pages), np.int32)
            plens = np.zeros(sb, np.int32)
            for si, e in enumerate(pre):
                r = self.reqs[e["req_id"]]
                lo, n = e["start"], e["len"]
                ids[si, :n] = r["tokens"][lo:lo + n]
                vl[si] = n
                pos[si, :n] = np.arange(lo, lo + n)
                slp[si, :n] = [self._slot(r, p) for p in range(lo, lo + n)]
                pages = r["pages"][: self.max_pages]
                bts[si, : len(pages)] = pages
                plens[si] = lo
            logits, self.kv = self._prefill_batch(
                self._tensor(ids), self._tensor(vl), self._tensor(pos),
                self._tensor(slp), self._tensor(bts), self._tensor(plens))
            # first generated token of every prompt whose last chunk ran
            last = [si for si, e in enumerate(pre)
                    if e["start"] + e["len"] == len(self.reqs[e["req_id"]]["tokens"])]
            picks = {}
            if last:
                rows = torch.tensor([pre[si]["len"] - 1 for si in last],
                                    device=logits.device)
                firsts = logits[torch.tensor(last, device=logits.device), rows]
                picks = dict(zip(last, firsts.argmax(-1).tolist()))
            for si, e in enumerate(pre):
                r = self.reqs[e["req_id"]]
                self.sched.commit_progress(e["req_id"], "prefill", e["len"])
                r["len"] = e["start"] + e["len"]
                if si in picks:
                    r["out"].append(int(picks[si]))
                    # publish this prompt's full pages into the radix cache
                    full = len(r["tokens"]) // ps
                    if full:
                        self.sched.insert_prefix(r["tokens"][: full * ps],
                                                 r["pages"][:full])

        dec = [e for e in entries if e["kind"] == "decode"][: self.decode_batch]
        if dec:
            b = self.decode_batch
            ids = np.zeros(b, np.int32)
            pos = np.zeros(b, np.int32)
            seq = np.ones(b, np.int32)
            bt = np.zeros((b, self.max_pages), np.int32)
            slots = np.full(b, -1, np.int32)
            for i, e in enumerate(dec):
                r = self.reqs[e["req_id"]]
                cur_len = len(r["tokens"]) + len(r["out"])
                ids[i] = r["out"][-1] if r["out"] else r["tokens"][-1]
                pos[i] = cur_len - 1
                seq[i] = cur_len
                pages = r["pages"][: self.max_pages]
                bt[i, : len(pages)] = pages
                slots[i] = self._slot(r, cur_len - 1)
            logits, self.kv = self._decode(
                self._tensor(ids), self._tensor(pos), self._tensor(seq),
                self._tensor(bt), self._tensor(slots))
            nxt = logits[: len(dec)].argmax(-1).tolist()
            for i, e in enumerate(dec):
                r = self.reqs[e["req_id"]]
                r["out"].append(int(nxt[i]))
                self.sched.commit_progress(e["req_id"], "decode", 1)
                if nxt[i] in r["stop"]:
                    r["stopped"] = True

        # retire finished requests (once)
        for rid, r in list(self.reqs.items()):
            if not r.get("done") and (r.get("stopped")
                                      or len(r["out"]) >= r["max_new"]):
                r["done"] = True
                self.sched.finish_request(rid)
                self.sched.release_pages(r["pages"])
        return True

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 8,
                 max_steps: int = 200):
        rids = [self.add_request(p, max_new_tokens) for p in prompts]
        for _ in range(max_steps):
            if not self.step():
                break
        return [self.reqs[r]["out"][:max_new_tokens] for r in rids]


class MlaEngine(LlamaEngine):
    """DeepSeek-MLA serving engine: the same scheduler and paged-KV machinery
    over the MLA model family, on split ckv / krope latent caches. Chunked
    prefill is decode_verify_step with a causal mask (a chunk is a fully
    accepted linear draft).

    Setup calls fuse_mla_weights, so that mla_preprocess runs its two
    RMSNormQuant->GEMM stages through K2 in its per_tensor mode on the card
    (the JAX package's own configuration for `bench.py --config mla` with
    SKT_MLA_FAST=0); on the CPU that is K2's plain version, the formula the
    JAX MlaEngine computes unfused."""

    def _setup_model(self, cfg, params, num_pages, seed):
        dm = deepseek_mla
        self.params = dm.fuse_mla_weights(
            params if params is not None else dm.init_params(cfg, seed, self.device))
        self.kv = dm.init_kv_cache(cfg, num_pages, device=self.device)

        def dec(ids, pos, seq, bt, slots):
            logits, _, _ = dm.decode_step(self.params, cfg, *self.kv, ids, pos, seq, bt,
                                          slots)
            return logits, self.kv

        def pre(ids, vl, pos, slots, bts, plens):
            s, t = ids.shape
            mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=ids.device))
            logits, _, _ = dm.decode_verify_step(
                self.params, cfg, *self.kv, ids, pos, mask.expand(s, t, t), plens, bts,
                slots)
            return logits, self.kv

        self._decode, self._prefill_batch = dec, pre
