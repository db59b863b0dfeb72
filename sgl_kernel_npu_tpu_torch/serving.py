"""Continuous-batching serving engine: native scheduler + paged KV + model
steps (counterpart of the JAX package's serving.py: LlamaEngine on int8
token-major pages or page-major ("hm") pages, bf16 or int8, MlaEngine on
split bf16 latent pages), and `speculative_generate`.

The C++ scheduler (runtime/) assembles prefill and decode entries under a
token budget; the page pool and radix prefix cache manage the pages;
prefill chunks of a step run as ONE padded [S, T] batch (S and T rounded up
to powers of 2, as the JAX engine buckets its compiles) and decode runs one
padded batch of `decode_batch` rows.

Each step reads its picks back to the host once: greedy (temperature 0) or
sampled (ops/sampling.py, from the engine's torch.Generator seeded
seed ^ 0x5EED), after each request's grammar bitmask (ops/grammar.py).
A request may carry an adapter id (multi-LoRA, llama.add_lora_adapters); it
then neither reuses nor publishes radix prefixes. pause_request offloads a
request's pages to the host (ops/kvcache.py's transfer functions) and frees
them; resume_request copies them into freshly allocated pages.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .models import deepseek_mla, llama
from .ops import kvcache, sampling
from .ops.grammar import apply_token_bitmask
from .runtime import NativeScheduler
from .utils import resolve_device


def _leaves(kv):
    """The cache arrays of a KV pytree (a tuple or a dict), in a fixed
    order; each has its page dimension at dim 1."""
    return list(kv) if isinstance(kv, tuple) else [kv[k] for k in sorted(kv)]


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class LlamaEngine:
    def __init__(self, cfg: llama.LlamaConfig, params=None, num_pages: int = 256,
                 decode_batch: int = 8, token_budget: int = 256, seed: int = 0,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 max_pages: int | None = None, kv_layout: str | None = None,
                 device="cuda"):
        """temperature 0 picks greedily; above 0 each pick is sampled
        (ops/sampling.sample with top_k, top_p) from a generator seeded
        seed ^ 0x5EED on `device`. kv_layout: the Llama KV layout, "tm" or
        "hm"; None picks tm iff llama.tm_layout_ok(cfg) (an int8 cache and
        the flat deferred decode), else hm, as the JAX engine does."""
        self.cfg = cfg
        self.kv_layout = kv_layout
        self.device = resolve_device(device)
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed ^ 0x5EED)
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
        `_decode(ids, pos, seq, bt, slots, lora_ids) -> (logits [B, V], kv)`
        and `_prefill_batch(ids, vl, pos, slots, bts, plens, lora_ids) ->
        (logits [S, T, V], kv)`, which update self.kv in place (lora_ids
        [B] or [S], -1 for none; read only when the params carry adapters).
        Subclasses adapt other model families."""
        self.params = (params if params is not None
                       else llama.init_params(cfg, seed, self.device))
        layout = self.kv_layout or ("tm" if llama.tm_layout_ok(cfg) else "hm")
        self.kv = llama.init_kv_cache(cfg, num_pages, layout=layout,
                                      device=self.device)
        lora = "lora_wo_A" in self.params["layers"]
        self._decode = lambda *a: llama.decode_step_kv(
            self.params, cfg, self.kv, *a[:5], lora_ids=a[5] if lora else None)
        self._prefill_batch = lambda *a: llama.prefill_batch_step_kv(
            self.params, cfg, self.kv, *a[:6], lora_ids=a[6] if lora else None)

    def add_request(self, tokens: List[int], max_new_tokens: int = 16,
                    stop_token_ids=None, token_bitmask=None,
                    lora_id: int = -1) -> int:
        """stop_token_ids: generation ends early on any of these ids.
        token_bitmask: a packed [ceil(V / 32)] int32 vocab mask
        (apply_token_bitmask's contract) applied before every pick of this
        request. lora_id: the adapter (llama.add_lora_adapters) this
        request runs with, -1 for none."""
        ps = self.cfg.page_size
        if token_bitmask is not None:
            if not isinstance(token_bitmask, torch.Tensor):
                token_bitmask = torch.from_numpy(np.asarray(token_bitmask).astype(np.int32))
            token_bitmask = token_bitmask.to(self.device, torch.int32)
        rid = self.sched.add_request(tokens, max_new_tokens)
        # radix prefix cache: reuse cached pages of the shared prefix and skip
        # prefilling it (never the final, partially filled page). An
        # adapter changes the hidden states, so LoRA requests neither reuse
        # nor publish prefixes.
        matched, cached_pages = (0, []) if lora_id >= 0 else self.sched.match_prefix(tokens)
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
                          "stop": set(stop_token_ids or ()),
                          "bitmask": token_bitmask, "lora": lora_id}
        if usable:
            self.sched.commit_progress(rid, "prefill", usable)
        return rid

    def pause_request(self, rid: int):
        """Preempt a request whose prompt is prefilled: offload its pages to
        the host (transfer_kv_to_host, every cache array) and free them."""
        r = self.reqs[rid]
        if r.get("done") or "host_kv" in r or r["len"] < len(r["tokens"]):
            raise ValueError("pause_request takes a running request whose prompt is "
                             "prefilled")
        idx = torch.tensor(r["pages"], dtype=torch.long, device=self.device)
        r["host_kv"] = [kvcache.transfer_kv_to_host(a.index_select(1, idx))
                        for a in _leaves(self.kv)]
        self.sched.finish_request(rid)
        self.sched.release_pages(r["pages"])
        r["pages"] = []
        return rid

    def resume_request(self, rid: int) -> int:
        """Re-admit a paused request: allocate pages (their ids may differ),
        copy its offloaded rows into them in place and mark its progress,
        so nothing is recomputed. Returns the request's NEW id."""
        r = self.reqs[rid]
        if "host_kv" not in r:
            raise ValueError(f"request {rid} is not paused")
        n = r["host_kv"][0].shape[0]
        pages = self.sched.alloc_pages(n)
        if len(pages) < n:
            self.sched.release_pages(pages)
            raise RuntimeError(f"KV page pool exhausted on resume: need {n} pages, "
                               f"got {len(pages)}")
        del self.reqs[rid]
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        for a, host in zip(_leaves(self.kv), r.pop("host_kv")):
            a.index_copy_(1, idx, kvcache.transfer_kv_to_device(host, like=a))
        r["pages"] = pages
        new_rid = self.sched.add_request(r["tokens"], r["max_new"])
        self.sched.commit_progress(new_rid, "prefill", len(r["tokens"]))
        self.sched.commit_progress(new_rid, "decode", len(r["out"]))
        self.sched.activate_request(new_rid)
        self.reqs[new_rid] = r
        return new_rid

    def _pick(self, logits, reqs):
        """Next tokens [n] on the device for logits [n, V] of the requests
        `reqs`: each request's grammar bitmask first, then the argmax
        (temperature 0) or a sample (ops/sampling.sample)."""
        if any(r["bitmask"] is not None for r in reqs):
            full = torch.full(((logits.shape[-1] + 31) // 32,), -1, dtype=torch.int32,
                              device=logits.device)
            logits = apply_token_bitmask(logits, torch.stack(
                [full if r["bitmask"] is None else r["bitmask"] for r in reqs]))
        if self.temperature == 0.0:
            return logits.argmax(-1)
        return sampling.sample(logits, self._gen, temperature=self.temperature,
                               top_k=self.top_k, top_p=self.top_p)

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
            lids = np.full(sb, -1, np.int32)
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
                lids[si] = r["lora"]
            logits, self.kv = self._prefill_batch(
                self._tensor(ids), self._tensor(vl), self._tensor(pos),
                self._tensor(slp), self._tensor(bts), self._tensor(plens),
                self._tensor(lids))
            # first generated token of every prompt whose last chunk ran
            last = [si for si, e in enumerate(pre)
                    if e["start"] + e["len"] == len(self.reqs[e["req_id"]]["tokens"])]
            picks = {}
            if last:
                rows = torch.tensor([pre[si]["len"] - 1 for si in last],
                                    device=logits.device)
                firsts = logits[torch.tensor(last, device=logits.device), rows]
                reqs = [self.reqs[pre[si]["req_id"]] for si in last]
                picks = dict(zip(last, self._pick(firsts, reqs).tolist()))
            for si, e in enumerate(pre):
                r = self.reqs[e["req_id"]]
                self.sched.commit_progress(e["req_id"], "prefill", e["len"])
                r["len"] = e["start"] + e["len"]
                if si in picks:
                    r["out"].append(int(picks[si]))
                    # publish this prompt's full pages into the radix cache
                    full = len(r["tokens"]) // ps
                    if full and r["lora"] < 0:
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
            lids = np.full(b, -1, np.int32)
            for i, e in enumerate(dec):
                r = self.reqs[e["req_id"]]
                cur_len = len(r["tokens"]) + len(r["out"])
                ids[i] = r["out"][-1] if r["out"] else r["tokens"][-1]
                pos[i] = cur_len - 1
                seq[i] = cur_len
                pages = r["pages"][: self.max_pages]
                bt[i, : len(pages)] = pages
                slots[i] = self._slot(r, cur_len - 1)
                lids[i] = r["lora"]
            logits, self.kv = self._decode(
                self._tensor(ids), self._tensor(pos), self._tensor(seq),
                self._tensor(bt), self._tensor(slots), self._tensor(lids))
            nxt = self._pick(logits[: len(dec)],
                             [self.reqs[e["req_id"]] for e in dec]).tolist()
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
    """DeepSeek-MLA serving engine: the same scheduler, paged-KV, sampling,
    bitmask and pause / resume machinery over the MLA model family, on split
    ckv / krope latent caches. Chunked prefill is decode_verify_step with a
    causal mask (a chunk is a fully accepted linear draft). The MLA model has
    no LoRA surface: adapter ids are dropped, as in the JAX MlaEngine.

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

        def dec(ids, pos, seq, bt, slots, lora_ids):
            logits, _, _ = dm.decode_step(self.params, cfg, *self.kv, ids, pos, seq, bt,
                                          slots)
            return logits, self.kv

        def pre(ids, vl, pos, slots, bts, plens, lora_ids):
            s, t = ids.shape
            mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=ids.device))
            logits, _, _ = dm.decode_verify_step(
                self.params, cfg, *self.kv, ids, pos, mask.expand(s, t, t), plens, bts,
                slots)
            return logits, self.kv

        self._decode, self._prefill_batch = dec, pre


def speculative_generate(t_params, t_cfg: llama.LlamaConfig, d_params, d_cfg: llama.LlamaConfig,
                         prompt: List[int], max_new_tokens: int, draft_len: int = 3,
                         num_pages: int = 16, device="cuda"):
    """Greedy speculative decoding (an EAGLE-style linear chain): the draft
    model proposes draft_len - 1 tokens after the last one a round
    (llama.decode_step); the target checks the chain in ONE
    llama.decode_verify_step and keeps the longest prefix that its argmax
    agrees with, plus its own next token. Both models run on bf16 page-major
    caches (int8_kv=False) of num_pages pages, the prompt prefilled by
    llama.prefill_chunk_step. Rejected drafts need no rollback: slots are
    position-mapped, and the next write to a position overwrites them.

    Returns (tokens, accept_counts): accept_counts[i] is the drafts accepted
    in round i."""
    if t_cfg.int8_kv or d_cfg.int8_kv:
        raise ValueError("speculative_generate runs on bf16 caches (int8_kv=False)")
    ps = t_cfg.page_size
    if d_cfg.page_size != ps:
        raise ValueError("the draft and the target must share a page size")
    dev = resolve_device(device)
    n = len(prompt)
    pages = list(range(1, num_pages))
    bt = torch.tensor([pages], dtype=torch.int32, device=dev)

    def ints(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def slot(p):
        return pages[p // ps] * ps + p % ps

    def prefill(params, cfg, toks):
        kv = llama.init_kv_cache(cfg, num_pages, layout="hm", device=dev)
        lg, _, _ = llama.prefill_chunk_step(params, cfg, *kv, ints(toks),
                                            torch.arange(n, dtype=torch.int32, device=dev),
                                            ints([slot(p) for p in range(n)]), bt[0], 0)
        return lg, kv

    lg_t, t_kv = prefill(t_params, t_cfg, prompt)
    _, d_kv = prefill(d_params, d_cfg, prompt)

    def d_step(tok, p):
        lg, _, _ = llama.decode_step(d_params, d_cfg, *d_kv, ints([tok]), ints([p]),
                                     ints([p + 1]), bt, ints([slot(p)]))
        return lg

    out = [int(lg_t[-1].argmax())]
    accept_counts = []
    t_len = n          # the target cache's verified length
    d_len = n          # the draft cache's length
    while len(out) < max_new_tokens:
        # draft a greedy chain
        chain = [out[-1]]
        for _ in range(draft_len - 1):
            chain.append(int(d_step(chain[-1], d_len)[0].argmax()))
            d_len += 1

        # verify the whole chain in one target step
        dt = len(chain)
        pos = torch.arange(t_len, t_len + dt, dtype=torch.int32, device=dev)[None]
        slots = ints([[slot(p) for p in range(t_len, t_len + dt)]])
        tree_mask = torch.tril(torch.ones((1, dt, dt), dtype=torch.bool, device=dev))
        lg, _, _ = llama.decode_verify_step(t_params, t_cfg, *t_kv, ints([chain]), pos,
                                            tree_mask, ints([t_len]), bt, slots)
        target = lg[0].argmax(-1).tolist()

        # accept the longest prefix where draft i + 1 equals the target's pick at i
        acc = 0
        while acc < dt - 1 and chain[acc + 1] == target[acc]:
            acc += 1
        accept_counts.append(acc)
        out.extend(chain[1:acc + 1] + [target[acc]])
        t_len += acc + 1

        # resync the draft cache through position want - 1 (all but the
        # last emitted token); a stale tail past want is overwritten later
        want = n + len(out) - 1
        d_len = min(d_len, want)
        while d_len < want:
            d_step(out[-(want - d_len) - 1], d_len)
            d_len += 1
    return out[:max_new_tokens], accept_counts
