"""Device-resident continuous batching with a fused device step (port of
``repro.serve.engine``, DESIGN.md §7), on a dense slot cache or on a paged
pool with radix prefix reuse (DESIGN.md §8).

- **EngineState** — cache, per-slot last token, active mask, temperature
  and steps-remaining budget live on the device; the host mirrors only the
  slot -> request bookkeeping.
- **Bucketed batched prefill** — admitted prompts are right-padded to a
  power-of-two length bucket and prefilled in one batched call per bucket
  (``model.prefill_into_slots``), padded to ``slots`` rows; dummy rows
  have length 0 and write nowhere.
- **Fused decode_and_sample** — decode plus greedy/temperature sampling
  (K3) for every slot, with done-detection (EOS / budget / cache-full) as a
  batched mask.
- **One device->host copy per step** — the new tokens and done masks of
  every wave and of the decode travel in a single copy, counted in
  ``host_transfers``.

- **Admission** goes through ``serve/sched.Scheduler`` (FCFS with a
  bounded skip-ahead past requests that cannot reserve pages and a
  starvation guard).
- **Paged mode** (``paged=True``): the slot rows become a fixed inventory
  of ``page_size``-token pages (``serve/kvpool.PagePool``) addressed
  through per-slot page tables. Admission matches the prompt against a
  host radix tree (``serve/radix.RadixCache``): the longest page-aligned
  cached prefix is borrowed (its table entries point at the shared pages,
  nothing is copied) and the prefill wave runs only the suffix, bucketed
  by suffix length, through the page gather K6. Decode runs the fused
  split-K kernel K4 over a pow2 KV-extent cap of the table
  (``fused_decode=False`` keeps the gather + softmax composition). Freed
  slots' tables are reset to all-trash before the next decode.

Behaviour kept from the reference: ``max_new_tokens=1`` finishes at
prefill, EOS is checked on the prefill token, a slot is done when its cache
length reaches ``max_len - 1``, and ``submit_t`` is stamped at ``submit``.
Temperature noise is the reference's: row i of a sampling call draws
``gumbel`` of ``fold_in(fold_in(fold_in(PRNGKey(seed), i), tag), counter)``
(``kernels/sampling.sample_tokens``), with the per-slot ``tag`` (the
request's uid) and ``counter`` (0 for the prefill token, then one more per
decode step) that the engine state carries, so tempered streams match the
reference's token for token as greedy ones do.

Later slices: chunked prefill, speculative decoding, the cost scheduler,
tracing, health and energy telemetry, ``compile_cache_stats``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.sampling import sample_tokens
from repro_torch.models import model as model_lib
from repro_torch.serve.kvpool import PagePool
from repro_torch.serve.radix import RadixCache
from repro_torch.serve.request import Finished, Request, percentile
from repro_torch.serve.sched import Scheduler

Tensor = torch.Tensor


class EngineState(NamedTuple):
    """Device-resident engine state; every leaf but the cache is (slots,...)."""

    cache: model_lib.ModelCache
    last_token: Tensor    # (slots, 1) int32
    active: Tensor        # (slots,) bool
    temp: Tensor          # (slots,) float32
    remaining: Tensor     # (slots,) int32 — new tokens still allowed
    counter: Tensor       # (slots,) int32 — sampling step (0 = prefill)
    tag: Tensor           # (slots,) int32 — the occupying request's uid


def bucket_for(plen: int, cap: int, min_bucket: int = 8) -> int:
    """Length bucket for a prompt: next power of two >= plen, floored at
    ``min_bucket`` and capped at ``cap``."""
    b = max(min_bucket, 1 << max(plen - 1, 0).bit_length())
    return min(b, cap)


def _admit_update(state: EngineState, cache: model_lib.ModelCache,
                  logits: Tensor, ids: np.ndarray, temps: Tensor,
                  budgets: Tensor, tags: Tensor, *, key: Tensor,
                  eos: Optional[int], slots: int):
    """Shared tail of every prefill wave: sample the first token, apply the
    admission updates at ``ids`` (dummy rows, id >= slots, drop) and report
    per-row done masks. Admission guarantees prompt < max_len, so the first
    decode write always fits: cache-full can only trigger in decode."""
    tok = sample_tokens(logits[:, 0], temps, key, tags,
                        torch.zeros_like(tags))
    rem = budgets - 1
    done = rem <= 0
    if eos is not None:
        done = done | (tok == eos)
    keep = np.nonzero((ids >= 0) & (ids < slots))[0]
    dev = tok.device
    src = torch.as_tensor(keep, device=dev)
    dst = torch.as_tensor(ids[keep].astype(np.int64), device=dev)
    state.last_token[dst, 0] = tok[src]
    state.active[dst] = ~done[src]
    state.temp[dst] = temps[src]
    state.remaining[dst] = rem[src]
    state.counter[dst] = 1
    state.tag[dst] = tags[src]
    return state._replace(cache=cache), (tok, done)


class Engine:
    """Fixed-slot continuous batching with a fused device step, FCFS
    admission, and optionally the paged cache pool with radix prefix reuse
    (``paged``). ``device`` defaults to the card."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 seed: int = 0, min_bucket: int = 8, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 fused_decode: Optional[bool] = None, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = None if eos_id is None else int(eos_id)
        self.min_bucket = min_bucket
        self.device = torch.device(device)
        self.key = rnd.PRNGKey(seed, self.device)
        self.paged = paged
        # Fused split-K paged decode: on for paged engines unless asked
        # off; dense engines have no paged kernel to fuse.
        self.fused_decode = paged if fused_decode is None else fused_decode
        if paged:
            if not model_lib.paged_supported(cfg):
                raise ValueError(f"paged cache: {cfg.name} is not a "
                                 "supported family")
            if max_len % page_size:
                raise ValueError(f"max_len {max_len} is not a multiple of "
                                 f"page_size {page_size}")
            self.page_size = page_size
            self.n_ptab = max_len // page_size
            if num_pages is None:
                # Dense-equivalent capacity plus the trash page.
                num_pages = slots * self.n_ptab + 1
            self.pool = PagePool(num_pages, page_size)
            self.radix = RadixCache(self.pool)
            self._slot_pages: Dict[int, List[int]] = {}
            self._prefix_hits = 0
            self._prefix_tokens = 0
            self._prompt_tokens = 0
            cache = model_lib.init_paged_cache(
                cfg, slots, max_len, page_size=page_size,
                num_pages=num_pages, device=self.device)
        else:
            cache = model_lib.init_cache(cfg, slots, max_len, self.device)
        self.sched = Scheduler("fcfs")
        z_i = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self.state = EngineState(
            cache=cache,
            last_token=torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device),
            active=torch.zeros((slots,), dtype=torch.bool, device=self.device),
            temp=torch.zeros((slots,), dtype=torch.float32,
                             device=self.device),
            remaining=z_i, counter=z_i.clone(), tag=z_i.clone())
        self.active: Dict[int, Request] = {}     # slot -> request (mirror)
        self.queue: Deque[Request] = deque()
        self.steps = 0
        self.host_transfers = 0
        self._finished_count = 0
        self._new_tokens = 0
        self._latencies: List[float] = []
        self._ttfts: List[float] = []

    # -- device calls --------------------------------------------------------
    def _prefill_wave(self, sb: int, group):
        """One pow2-bucket prefill wave, padded to ``slots`` rows. A paged
        row prefills its prompt from ``skip``, the radix-matched prefix."""
        slots = self.slots
        tokens = np.zeros((slots, sb), np.int32)
        plens = np.zeros((slots,), np.int32)          # dummy rows: len 0
        offs = np.zeros((slots,), np.int32)
        ids = np.full((slots,), slots, np.int32)      # dummy rows: drop
        temps = np.zeros((slots,), np.float32)
        budgets = np.ones((slots,), np.int32)
        tags = np.zeros((slots,), np.int32)
        for r, (slot, req, skip, _pages) in enumerate(group):
            p = np.asarray(req.prompt)
            tokens[r, : len(p) - skip] = p[skip:]
            plens[r] = len(p)
            offs[r] = skip
            ids[r] = slot
            temps[r] = req.temperature
            budgets[r] = req.max_new_tokens
            tags[r] = req.uid & 0x7FFFFFFF
        dev = self.device
        tok_t = torch.as_tensor(tokens, device=dev)
        plen_t = torch.as_tensor(plens, device=dev)
        if self.paged:
            logits, cache = model_lib.prefill_into_pages(
                self.params, tok_t, self.cfg, self.state.cache, plen_t,
                torch.as_tensor(offs, device=dev), ids)
        else:
            logits, cache = model_lib.prefill_into_slots(
                self.params, tok_t, self.cfg, self.state.cache, plen_t, ids,
                max_len=self.max_len)
        self.state, out = _admit_update(
            self.state, cache, logits, ids, torch.as_tensor(temps, device=dev),
            torch.as_tensor(budgets, device=dev),
            torch.as_tensor(tags, device=dev), key=self.key, eos=self.eos_id,
            slots=slots)
        return out

    def _decode_and_sample(self):
        st = self.state
        logits, cache = model_lib.decode_step(
            self.params, st.cache, st.last_token, self.cfg,
            kv_cap=self._decode_cap(), fused_paged=self.fused_decode)
        tok = sample_tokens(logits[:, 0], st.temp, self.key, st.tag,
                            st.counter)
        rem = st.remaining - 1
        done = (rem <= 0) | (cache.lengths >= self.max_len - 1)
        if self.eos_id is not None:
            done = done | (tok == self.eos_id)
        done = st.active & done
        self.state = EngineState(
            cache=cache,
            last_token=torch.where(st.active[:, None], tok[:, None],
                                   st.last_token),
            active=st.active & ~done,
            temp=st.temp,
            remaining=torch.where(st.active, rem, st.remaining),
            counter=st.counter + st.active.to(torch.int32),
            tag=st.tag)
        return tok, done

    def _decode_cap(self) -> Optional[int]:
        """KV-extent cap (tokens) for this step's fused paged decode, or
        None. The largest extent any active slot touches this step is
        ``prompt + generated`` (the decode writes at its last position),
        rounded up to a pow2 page count. Pages past a row's length are
        masked, so the cap changes nothing on any live row."""
        if not (self.paged and self.fused_decode):
            return None
        need = 1
        for req in self.active.values():
            need = max(need, len(req.prompt) + max(len(req.generated), 1))
        pages = -(-need // self.page_size)
        t = 1 << max(pages - 1, 0).bit_length()
        return min(t, self.n_ptab) * self.page_size

    # -- paged bookkeeping ---------------------------------------------------
    def _try_reserve(self, req: Request):
        """Radix-match the prompt (pins the shared pages) and allocate the
        rest, evicting LRU tree leaves on shortfall. Returns (skip, pages)
        or None (the request stays queued). A request that can never fit
        raises."""
        ps = self.page_size
        plen = len(req.prompt)
        last_write = min(plen + req.max_new_tokens - 2, self.max_len - 1)
        need = last_write // ps + 1
        if need > self.pool.total_pages:
            raise ValueError(
                "request needs more pages than the pool holds "
                f"(prompt {plen} + budget {req.max_new_tokens}, "
                f"{self.pool.total_pages} pages)")
        pages, skip = self.radix.match(req.prompt)
        # all_or_nothing: an admission that fails anyway must not destroy
        # cached prefixes the next requests would reuse.
        fresh = self.pool.alloc(
            need - len(pages),
            evict=lambda k: self.radix.evict(k, all_or_nothing=True))
        if fresh is None:
            self.radix.release(pages)
            return None
        return skip, pages + fresh

    def _assign_page_tables(self, admits) -> None:
        rows = np.zeros((len(admits), self.n_ptab), np.int32)
        ids = np.zeros((len(admits),), np.int32)
        for r, (slot, _req, _skip, pages) in enumerate(admits):
            ids[r] = slot
            rows[r, : len(pages)] = pages
        model_lib.set_page_rows(self.state.cache, ids, rows)

    def _teardown_slots(self, freed: List[int]) -> None:
        """Reset freed slots' page tables to all-trash BEFORE the next
        decode (a stale slot keeps writing, and its pages may be handed
        out again) and drop their page references."""
        model_lib.set_page_rows(
            self.state.cache, np.asarray(freed, np.int32),
            np.zeros((len(freed), self.n_ptab), np.int32))
        for slot in freed:
            for p in self._slot_pages.pop(slot, []):
                self.pool.release(p)

    def _register_admit(self, slot: int, req: Request, skip: int,
                        pages) -> None:
        """Book an admitted paged request: its pages, the hit counters, and
        its prompt's full pages indexed in the radix tree."""
        self._slot_pages[slot] = list(pages)
        self._prompt_tokens += len(req.prompt)
        self._prefix_tokens += skip
        if skip:
            self._prefix_hits += 1
        n_full = len(req.prompt) // self.page_size
        if n_full:
            self.radix.insert(req.prompt[: n_full * self.page_size],
                              pages[:n_full])

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request) -> None:
        # Latency and TTFT are measured from submission, not construction.
        req.submit_t = time.monotonic()
        req.skipped = 0
        self.queue.append(req)

    def step(self) -> List[Finished]:
        """One engine step: scheduler admission into free slots (with page
        reservation on a paged engine), one prefill wave per length
        bucket, one fused decode_and_sample, and a single device->host
        copy of the new tokens and done masks."""
        had_active = bool(self.active)
        tracker = self.sched.begin_step()
        free = [i for i in range(self.slots) if i not in self.active]
        picks = self.sched.pick(self.queue, len(free), tracker,
                                self._try_reserve if self.paged else None)
        admits = []
        for req, (skip, pages) in picks:
            assert len(req.prompt) < self.max_len, \
                "prompt longer than cache"
            admits.append((free.pop(0), req, skip, pages))
        if self.paged and admits:
            self._assign_page_tables(admits)
        by_bucket: Dict[int, list] = {}
        for slot, req, skip, pages in admits:
            sb = bucket_for(len(req.prompt) - skip, self.max_len,
                            self.min_bucket)
            by_bucket.setdefault(sb, []).append((slot, req, skip, pages))
        waves = []
        for sb in sorted(by_bucket):
            group = by_bucket[sb]
            waves.append((group, self._prefill_wave(sb, group)))
            for slot, req, skip, pages in group:
                self.active[slot] = req
                if self.paged:
                    self._register_admit(slot, req, skip, pages)
        dec = None
        sampled = [req for group, _ in waves for _, req, _, _ in group]
        if had_active or any(r.max_new_tokens > 1 for r in sampled):
            self.steps += 1
            dec = self._decode_and_sample()
        if not waves and dec is None:
            return []
        # The step's single device->host copy: tokens + done masks.
        outs = [o for _, o in waves] + ([dec] if dec is not None else [])
        host = torch.stack([t.to(torch.int32) for o in outs for t in o]
                           ).cpu().numpy()
        self.host_transfers += 1
        now = time.monotonic()
        finished: List[Finished] = []
        freed: List[int] = []
        for w, (group, _) in enumerate(waves):
            tok, done = host[2 * w], host[2 * w + 1]
            for r, (slot, req, _skip, _pages) in enumerate(group):
                self._append_token(req, int(tok[r]), now)
                if done[r]:
                    finished.append(self._finish(req, now))
                    del self.active[slot]
                    freed.append(slot)
        if dec is not None:
            tok, done = host[-2], host[-1]
            for slot, req in list(self.active.items()):
                self._append_token(req, int(tok[slot]), now)
                if done[slot]:
                    finished.append(self._finish(req, now))
                    del self.active[slot]
                    freed.append(slot)
        if self.paged and freed:
            self._teardown_slots(freed)
        return finished

    def _append_token(self, req: Request, tok: int, now: float) -> None:
        req.generated.append(tok)
        if len(req.generated) == 1:  # TTFT: queue wait + full prefill
            req.first_token_t = now
            self._ttfts.append(max(now - req.submit_t, 0.0))
        req.last_token_t = now

    def _finish(self, req: Request, now: float) -> Finished:
        lat = max(now - req.submit_t, 0.0)
        self._latencies.append(lat)
        self._new_tokens += len(req.generated)
        self._finished_count += 1
        return Finished(uid=req.uid, tokens=np.asarray(req.generated),
                        latency_s=lat,
                        ttft_s=max(req.first_token_t - req.submit_t, 0.0))

    def run_until_drained(self, max_steps: int = 10_000) -> List[Finished]:
        out: List[Finished] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.active and not self.queue:
                return out
        raise RuntimeError(
            f"run_until_drained: {len(self.queue)} queued, "
            f"{len(self.active)} in flight after {max_steps} steps")

    def stats(self) -> Dict[str, float]:
        """Throughput/latency aggregates (zero-request safe), and on a
        paged engine the pool and radix counters."""
        out = {
            "steps": float(self.steps),
            "host_transfers": float(self.host_transfers),
            "finished": float(self._finished_count),
            "new_tokens": float(self._new_tokens),
            "latency_p50_s": percentile(self._latencies, 50),
            "latency_p95_s": percentile(self._latencies, 95),
            "ttft_p50_s": percentile(self._ttfts, 50),
            "ttft_p95_s": percentile(self._ttfts, 95),
        }
        if self.paged:
            out.update({
                "pool_pages_total": float(self.pool.total_pages),
                "pool_pages_in_use": float(self.pool.pages_in_use),
                "pool_pages_free": float(self.pool.free_pages),
                "radix_hit_rate": (self._prefix_tokens
                                   / max(self._prompt_tokens, 1)),
                "radix_hits": float(self._prefix_hits),
                "radix_nodes": float(self.radix.nodes),
                "radix_evictions": float(self.radix.evictions),
            })
        return out
