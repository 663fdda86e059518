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
- **Chunked prefill** (``chunk_tokens=C``, DESIGN.md §10): a prompt whose
  non-cached suffix is longer than C is prefilled C tokens at a time, at
  most ONE fixed-shape ``(slots, C)`` chunk wave per step beside the
  decode, so decoding slots never wait more than one chunk behind a long
  prompt. A mid-prefill slot's progress is its ``cache.lengths`` entry
  (each chunk resumes at ``Request.prefilled`` through the models'
  offsets contract); its ``active`` mask stays False, so decode effects
  never persist for it; only a request's final chunk samples and admits.
  On a paged engine the radix insert waits for the final chunk (an insert
  at admission would let another request borrow unwritten pages). A
  prompt whose suffix fits one chunk rides the classic bucketed wave.
- **Speculative decoding** (``spec=SpecConfig(...)``, DESIGN.md §12,
  greedy requests only): the decode becomes draft -> verify -> accept over
  the K+1 chain positions [pending, d_1..d_K] of every slot. The draft is
  the host prompt-lookup (``ngram``) or a draft model's K+1 decode steps
  against a dense draft cache mirroring the admissions (``model``, dense
  non-chunked engines). ``model.verify_step`` scores the chain in one
  call (K4/K5 over slots·(K+1) rows on a paged engine), the same sampler
  (K3) picks every column, ``spec.chain_accept`` keeps the longest
  accepted prefix plus the bonus token, and ``lengths`` roll back to it.
  On a paged engine the overhang past a slot's reserved pages lands in
  per-step scratch pages (no eviction; the trash page when the pool is
  short), released after the step.

- **Admission** goes through ``serve/sched.Scheduler``: FCFS with a
  bounded skip-ahead past requests that cannot reserve pages and a
  starvation guard, or ``sched="cost"``, cheapest projected crossbar
  energy first (``hw/schedule.AdmissionCost.for_model``, optionally with
  a wear surcharge), against an optional per-step ``budget``.
- **Energy books** (``track_energy``, on by default as in the reference,
  DESIGN.md §6): at ``quant="timefloats"`` the hw twin's
  ``ServeEnergyModel`` books every prefill wave, chunk wave and decode or
  verify step at the crossbar read energy of its op census, each request
  its share (``Request.energy_pj``, ``Finished.energy_pj`` /
  ``pj_per_token``), a radix hit the energy its shorter bucket saved, and
  a wear book the per-tile reads; ``hw_telemetry()`` and ``stats()``
  report the totals. A census is taken once per shape on meta tensors
  (``hw/schedule.capture_census``): it runs no step, writes no state,
  captures nothing and launches nothing, so the books move no stream, no
  launch count and no ``compile_cache_stats()``.
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

- **Compile discipline** (the reference's ``counting_jit`` /
  ``compile_cache_stats``): every device call of a step is an entry of
  ``serve/request.StepGraphs``, named as the reference names its jitted
  callables: ``prefill[<bucket>]``, ``prefill[c<chunk_tokens>]``,
  ``decode_and_sample`` / ``decode_and_verify`` (``[c<cap>]`` per pow2
  KV-extent cap on a fused paged engine) and ``draft_prefill[<bucket>]``.
  On the card each entry is one captured CUDA graph (``graphs``, on by
  default there), replayed with the step's host arrays copied into its
  static input buffers; the engine state and the cache are the graphs'
  static tensors, updated in place. Admission, page tables, scratch pages
  and the step's one device->host copy stay outside the graphs.
- **Observability** (DESIGN.md §11, §13): pass ``tracer`` (an
  ``obs.trace.Tracer``) for the reference's span taxonomy: ``engine.step``,
  ``sched.pick``, ``prefill.chunk_wave`` and ``prefill.wave[<b>]``,
  ``decode_and_sample`` / ``decode_and_verify``, ``host_transfer``,
  ``radix.match`` / ``radix.insert``, ``pool.evict`` instants, a
  ``compile[<name>]`` span per step program built, and counter tracks for
  the queue, the pool and the twin's pJ. The prefill and decode spans carry
  the twin's attributed pJ as the same float expressions the books add, so
  their event-order folds equal ``hw_telemetry()`` exactly; a decode span
  is annotated after it closes, once the done masks are applied. Spans
  are host wall-clock and their args come from host mirrors only: on the
  card a step span times the replay's launch, and the device work lands in
  ``host_transfer``. The metrics registry (``metrics`` or a private one)
  is always on; ``health`` (an ``obs.health.HealthMonitor``) watches the
  step wall, queue, TTFT/ITL, pool, pJ-per-token and acceptance series,
  and ``slos`` add burn-rate keys to ``stats()``. The default no-op tracer
  leaves streams, ``stats()`` and launches bit-identical.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.configs.base import ModelConfig
from repro_torch.hw.schedule import StepBudget
from repro_torch.kernels.sampling import sample_tokens
from repro_torch.models import model as model_lib
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NOOP, NOOP_SPAN, TID_SERVE
from repro_torch.serve.kvpool import PagePool
from repro_torch.serve.radix import RadixCache
from repro_torch.serve.request import (Finished, Request, StepGraphs,
                                      make_serve_energy_model, memo_census,
                                      percentile)
from repro_torch.serve.sched import Scheduler
from repro_torch.serve.spec import SpecConfig, chain_accept, propose_ngram

Tensor = torch.Tensor

# Prefill waves longer than this count as decode stalls when launched
# beside active decode slots (``decode_stall_steps``); a chunked engine's
# own chunk_tokens overrides it.
STALL_REF_TOKENS = 64


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


def _admit_update(state: EngineState, logits: Tensor, ids: Tensor,
                  temps: Tensor, budgets: Tensor, tags: Tensor, *,
                  key: Tensor, eos: Optional[int], slots: int):
    """Shared tail of every prefill wave: sample the first token, apply the
    admission updates at ``ids`` (dummy rows, id >= slots, drop) to the
    state in place, with fixed shapes, and report per-row done masks.
    Admission guarantees prompt < max_len, so the first decode write always
    fits: cache-full can only trigger in decode."""
    tok = sample_tokens(logits[:, 0], temps, key, tags,
                        torch.zeros_like(tags))
    rem = budgets - 1
    done = rem <= 0
    if eos is not None:
        done = done | (tok == eos)
    src, has = model_lib.slot_sources(ids, slots, tok.device)
    model_lib.merge_rows(state.last_token, tok[:, None], src, has)
    model_lib.merge_rows(state.active, ~done, src, has)
    model_lib.merge_rows(state.temp, temps, src, has)
    model_lib.merge_rows(state.remaining, rem, src, has)
    model_lib.merge_rows(state.counter, torch.ones_like(tags), src, has)
    model_lib.merge_rows(state.tag, tags, src, has)
    return tok, done


class Engine:
    """Fixed-slot continuous batching with a fused device step, FCFS or
    cost-aware admission (``sched``, ``budget``), and optionally the paged
    cache pool with radix prefix reuse (``paged``), chunked prefill
    (``chunk_tokens``) and speculative decoding (``spec``). ``device``
    defaults to the card. ``graphs`` (default: on for a CUDA engine)
    captures every step callable into a CUDA graph at its first call and
    replays it after; ``graphs=False`` runs the same callables eagerly, and
    a CPU engine cannot take graphs. ``track_energy`` keeps the hw twin's
    energy books (a no-op unless ``cfg.quant == "timefloats"``).
    ``tracer``, ``metrics``, ``health`` and ``slos`` are the observability
    hooks (module docstring)."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 seed: int = 0, min_bucket: int = 8, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 fused_decode: Optional[bool] = None,
                 chunk_tokens: Optional[int] = None,
                 spec: Optional[SpecConfig] = None, device="cuda",
                 graphs: Optional[bool] = None, track_energy: bool = True,
                 sched: str = "fcfs", budget: Optional[StepBudget] = None,
                 wear_weight: float = 0.0, wear_endurance=None,
                 tracer=None, metrics: Optional[MetricsRegistry] = None,
                 health=None, slos=None):
        self.cfg = cfg
        self.tracer = tracer or NOOP
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = None if eos_id is None else int(eos_id)
        self.min_bucket = min_bucket
        self.device = torch.device(device)
        self.key = rnd.PRNGKey(seed, self.device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        self.graphs = StepGraphs(self.device, capture=graphs,
                                 tracer=self.tracer)
        self.decode_launches = 0
        self._step_cap: Optional[int] = None   # the last decode's KV cap
        self.paged = paged
        # Fused split-K paged decode: on for paged engines unless asked
        # off; dense engines have no paged kernel to fuse.
        self.fused_decode = paged if fused_decode is None else fused_decode
        self.spec = spec
        self._spec_model = spec is not None and spec.draft == "model"
        if spec is not None and not model_lib.paged_supported(cfg):
            raise ValueError(f"speculative decoding: {cfg.name} is not an "
                             "attention family")
        if self._spec_model:
            dcfg = spec.draft_cfg
            if paged or chunk_tokens:
                raise ValueError("draft='model' mirrors whole-prompt "
                                 "admission waves: dense, non-chunked "
                                 "engines only")
            if not model_lib.paged_supported(dcfg):
                raise ValueError("the draft model must be an attention "
                                 "family")
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share the vocab")
        self.chunk_tokens = int(chunk_tokens) if chunk_tokens else None
        if self.chunk_tokens is not None:
            c = self.chunk_tokens
            if c & (c - 1) or not c < max_len:
                raise ValueError(f"chunk_tokens {c}: a power of two below "
                                 f"max_len {max_len}")
            if not model_lib.paged_supported(cfg):
                raise ValueError(f"chunked prefill: {cfg.name} is not an "
                                 "attention family")
        self._stall_ref = self.chunk_tokens or STALL_REF_TOKENS
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
        # The pJ-priced admission cost is built only when something reads
        # it (the cost policy or an energy budget): the placement walk is
        # host work an fcfs engine need not pay.
        acost = None
        if sched == "cost" or (budget is not None
                               and budget.prefill_pj is not None):
            from repro_torch.hw.schedule import AdmissionCost

            acost = AdmissionCost.for_model(params, cfg,
                                            wear_weight=wear_weight,
                                            endurance=wear_endurance)
        self.sched = Scheduler(sched, cost=acost, budget=budget,
                               chunk_tokens=self.chunk_tokens)
        # What fixes the shapes the census programs see (the draft model
        # of a model-draft engine is not memoized: its params are its own).
        geometry = (cfg, slots, max_len, paged, page_size if paged else None,
                    num_pages, self.fused_decode,
                    None if spec is None else spec.k)
        self._hw = make_serve_energy_model(
            cfg, slots, track_energy, params=params,
            census=(None if self._spec_model
                    else functools.partial(memo_census, geometry)))
        z_i = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self.state = EngineState(
            cache=cache,
            last_token=torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device),
            active=torch.zeros((slots,), dtype=torch.bool, device=self.device),
            temp=torch.zeros((slots,), dtype=torch.float32,
                             device=self.device),
            remaining=z_i, counter=z_i.clone(), tag=z_i.clone())
        # The draft model's dense cache: as many rows as the target's, so
        # its calls run at the target's shapes.
        self._spec_dcache = (model_lib.init_cache(
            spec.draft_cfg, slots, max_len, self.device)
            if self._spec_model else None)
        # Per-slot [uid, buffer, filled] history for the ngram draft, so a
        # step appends only the tokens emitted since the last one.
        self._spec_hist: Dict[int, list] = {}
        self._spec_proposed = 0    # draft tokens offered to the verifier
        self._spec_accepted = 0    # draft tokens accepted (bonus excluded)
        self.active: Dict[int, Request] = {}     # slot -> request (mirror)
        self._chunking: Dict[int, Request] = {}  # slot -> mid-prefill req
        self.queue: Deque[Request] = deque()
        self.steps = 0
        self.host_transfers = 0
        self.chunk_waves = 0
        self.decode_stall_steps = 0
        # (uid, offset, n_tokens) per chunk-wave row: the offsets tile each
        # chunked prompt once, in order.
        self.chunk_log: List[Tuple[int, int, int]] = []
        self._finished_count = 0
        self._new_tokens = 0
        self._latencies: List[float] = []
        self._ttfts: List[float] = []

        # The health layer; it may be attached after construction, so the
        # delta trackers start unconditionally.
        self.health = health
        self.slos = tuple(slos) if slos else ()
        self._h_ttft_count = 0
        self._h_ttft_sum = 0.0
        self._h_itl_count = 0
        self._h_itl_sum = 0.0
        self._h_pj = 0.0
        self._h_spec_proposed = 0
        self._h_spec_accepted = 0

        # The metrics registry, always on and pre-bound, so hot paths pay a
        # method call, not a lookup.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m_steps = m.counter("serve_steps")
        self._m_finished = m.counter("serve_finished")
        self._m_new_tokens = m.counter("serve_new_tokens")
        self._m_submitted = m.counter("serve_submitted")
        self._m_queue_depth = m.gauge("serve_queue_depth")
        self._m_ttft = m.histogram("serve_ttft_s")
        self._m_itl = m.histogram("serve_itl_s")
        self._m_latency = m.histogram("serve_latency_s")
        self._m_chunk_rows = m.histogram("serve_chunk_wave_rows")
        self._m_stalls = m.counter("serve_decode_stall_steps")
        self._m_decode_launches = m.counter("serve_decode_launches")
        if paged:
            self._m_pool_in_use = m.gauge("serve_pool_pages_in_use")
            self._m_radix_hits = m.counter("serve_radix_hits")
            self._m_radix_hit_tokens = m.counter("serve_radix_hit_tokens")
            self._m_evictions = m.counter("serve_pool_evictions")
        if spec is not None:
            self._m_spec_proposed = m.counter("serve_spec_proposed")
            self._m_spec_accepted = m.counter("serve_spec_accepted")
            self._m_spec_emit = m.histogram("serve_spec_emit_per_slot")

    # -- device calls --------------------------------------------------------
    # Each ``_*_fn`` builds a step callable over the engine's persistent
    # tensors; it reads its host inputs from static buffers, updates the
    # state and the cache in place and returns the tensors the step's host
    # copy reads. ``self.graphs`` runs it (captured on the card).

    def _prefill_fn(self):
        st, cfg, slots = self.state, self.cfg, self.slots

        def fn(tokens, plens, offs, ids, temps, budgets, tags):
            if self.paged:
                logits, _ = model_lib.prefill_into_pages(
                    self.params, tokens, cfg, st.cache, plens, offs, ids)
            else:
                logits, _ = model_lib.prefill_into_slots(
                    self.params, tokens, cfg, st.cache, plens, ids,
                    max_len=self.max_len)
            return _admit_update(st, logits, ids, temps, budgets, tags,
                                 key=self.key, eos=self.eos_id, slots=slots)

        return fn

    def _draft_prefill_fn(self):
        """The draft cache's mirror of a bucket wave (``draft="model"``):
        the same rows, no sampling (the pending token is the target's)."""
        def fn(tokens, plens, ids):
            model_lib.prefill_into_slots(
                self.spec.draft_params, tokens, self.spec.draft_cfg,
                self._spec_dcache, plens, ids, max_len=self.max_len)
            return ()

        return fn

    def _prefill_wave(self, sb: int, group, sp=NOOP_SPAN):
        """One pow2-bucket prefill wave, padded to ``slots`` rows, and its
        admissions. A paged row prefills its prompt from ``skip``, the
        radix-matched prefix. ``sp`` is the enclosing span; the twin's
        attributed pJ for the wave lands in its args."""
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
        if self._hw is not None:
            mode = "paged" if self.paged else "dense"
            pj = self._hw.prefill_bucket_pj(
                (sb, slots, mode), self._census_prefill, self.params,
                self.state.cache, tokens, plens,
                offs if self.paged else None, ids)
            share = self._hw.on_prefill_wave(pj, len(group),
                                             tokens=slots * sb)
            sp.set(total_pj=pj, attributed_pj=share * len(group))
            for _, req, _, _ in group:
                req.energy_pj += share
            if self.paged:
                self._credit_prefix_hits(group, sb, pj)
        out = self.graphs.call(f"prefill[{sb}]", self._prefill_fn(),
                               tokens, plens, offs, ids, temps, budgets, tags)
        if self._spec_model:
            self.graphs.call(f"draft_prefill[{sb}]", self._draft_prefill_fn(),
                             tokens, plens, ids)
        for slot, req, skip, pages in group:
            self.active[slot] = req
            if self.paged:
                self._count_admit(slot, req, skip, pages)
                self._insert_radix(req, pages)
        return out

    # -- the hw twin's census programs: the model calls of each step
    # callable, which ``capture_census`` runs on meta tensors ---------------
    def _census_prefill(self, params, cache, tokens, plens, offs, ids):
        if self.paged:
            model_lib.prefill_into_pages(params, tokens, self.cfg, cache,
                                         plens, offs, ids)
        else:
            model_lib.prefill_into_slots(params, tokens, self.cfg, cache,
                                         plens, ids, max_len=self.max_len,
                                         offsets=offs)

    def _census_decode(self, params, cache, tokens, cap, dparams=None,
                       dcache=None):
        """A decode step, or the chain verify of ``tokens`` (slots, K+1)
        with the draft model's K+1 decode steps before it."""
        if self.spec is None:
            model_lib.decode_step(params, cache, tokens, self.cfg,
                                  kv_cap=cap, fused_paged=self.fused_decode)
            return
        if dparams is not None:
            for _ in range(self.spec.k + 1):
                _, dcache = model_lib.decode_step(
                    dparams, dcache, tokens[:, :1], self.spec.draft_cfg)
        model_lib.verify_step(params, cache, tokens, self.cfg, kv_cap=cap,
                              fused_paged=self.fused_decode)

    def _book_decode(self, cap: Optional[int], emit, sp=NOOP_SPAN) -> None:
        """Book the step's decode (or verify) energy, after the waves'
        done masks: a request that finished at prefill takes no decode
        share. The attributed pJ (and a verify's accepted/rejected split)
        land in the args of the decode span ``sp``, closed by now."""
        hw, slots = self._hw, self.slots
        if hw.decode_step_pj is None:
            depth = 1 if self.spec is None else self.spec.k + 1
            tokens = np.zeros((slots, depth), np.int32)
            draft = ((self.spec.draft_params, self._spec_dcache)
                     if self._spec_model else ())
            hw.observe_decode(self._census_decode, self.params,
                              self.state.cache, tokens, cap, *draft)
        n_act = len(self.active)
        if self.spec is None:
            share = hw.on_decode_step(n_act, tokens=slots)
            sp.set(attributed_pj=share * n_act)
        else:
            emitted = sum(int(emit[s]) for s in self.active)
            share, acc, rej, step_pj = hw.on_spec_step(
                n_act, emitted, self.spec.k + 1,
                tokens=slots * (self.spec.k + 1))
            sp.set(attributed_pj=step_pj, accepted_pj=acc, rejected_pj=rej)
        for req in self.active.values():
            req.energy_pj += share

    def _credit_prefix_hits(self, group, sb: int, pj_exec: float) -> None:
        """A prefix hit is charged the executed suffix bucket only; its
        credit is the cost delta to the bucket the whole prompt would have
        needed (0 when the pow2 bucket does not shrink)."""
        slots = self.slots
        for _slot, req, skip, _pages in group:
            if skip <= 0:
                continue
            fsb = bucket_for(len(req.prompt), self.max_len, self.min_bucket)
            saved = 0.0
            if fsb != sb:
                z = np.zeros((slots,), np.int32)
                pj_full = self._hw.prefill_bucket_pj(
                    (fsb, slots, "paged"), self._census_prefill,
                    self.params, self.state.cache,
                    np.zeros((slots, fsb), np.int32), z, z,
                    np.full((slots,), slots, np.int32))
                saved = max(pj_full - pj_exec, 0.0) / slots
            self._hw.on_prefix_hit(saved, skip)

    def _chunk_wave_fn(self):
        """ONE fixed-shape callable for every chunk wave: ``wids`` select
        the rows written, ``aids`` hold the slot on final-chunk rows and
        the drop sentinel on mid-chunk rows, so only final chunks admit."""
        st, cfg, slots = self.state, self.cfg, self.slots

        def fn(tokens, tots, offs, wids, aids, temps, budgets, tags):
            if self.paged:
                logits, _ = model_lib.prefill_into_pages(
                    self.params, tokens, cfg, st.cache, tots, offs, wids)
            else:
                logits, _ = model_lib.prefill_into_slots(
                    self.params, tokens, cfg, st.cache, tots, wids,
                    max_len=self.max_len, offsets=offs)
            return _admit_update(st, logits, aids, temps, budgets, tags,
                                 key=self.key, eos=self.eos_id, slots=slots)

        return fn

    def _run_chunk_wave(self, sp=NOOP_SPAN):
        """Advance every mid-prefill slot by one chunk in ONE fixed-shape
        ``(slots, chunk_tokens)`` wave. Final-chunk rows sample their first
        token and join ``active``; mid-chunk rows admit nothing
        (``admit_ids`` holds the drop sentinel there). Returns the rows
        that admitted, [(row, slot, request)], and the wave's outputs.
        ``sp`` is the enclosing span; the twin's attributed pJ for the
        wave lands in its args."""
        C, slots = self.chunk_tokens, self.slots
        tokens = np.zeros((slots, C), np.int32)
        tots = np.zeros((slots,), np.int32)
        offs = np.zeros((slots,), np.int32)
        wids = np.full((slots,), slots, np.int32)   # dummy rows: drop
        aids = np.full((slots,), slots, np.int32)   # mid-chunk rows: drop
        temps = np.zeros((slots,), np.float32)
        budgets = np.ones((slots,), np.int32)
        tags = np.zeros((slots,), np.int32)
        finals = []
        for r, (slot, req) in enumerate(sorted(self._chunking.items())):
            p = np.asarray(req.prompt)
            start = req.prefilled
            n = min(C, len(p) - start)
            tokens[r, :n] = p[start:start + n]
            offs[r] = start
            tots[r] = start + n
            wids[r] = slot
            req.prefilled = start + n
            self.chunk_log.append((req.uid, start, n))
            if req.prefilled == len(p):
                aids[r] = slot
                temps[r] = req.temperature
                budgets[r] = req.max_new_tokens
                tags[r] = req.uid & 0x7FFFFFFF
                finals.append((r, slot, req))
        rows = len(self._chunking)
        sp.set(rows=rows, finals=len(finals))
        self._m_chunk_rows.observe(float(rows))
        if self._hw is not None:
            mode = "paged" if self.paged else "dense"
            pj = self._hw.prefill_bucket_pj(
                ("chunk", C, slots, mode), self._census_prefill, self.params,
                self.state.cache, tokens, tots, offs, wids)
            share = self._hw.on_prefill_wave(pj, rows, tokens=slots * C)
            sp.set(total_pj=pj, attributed_pj=share * rows)
            for req in self._chunking.values():
                req.energy_pj += share
        out = self.graphs.call(f"prefill[c{C}]", self._chunk_wave_fn(),
                               tokens, tots, offs, wids, aids, temps,
                               budgets, tags)
        self.chunk_waves += 1
        for _r, slot, req in finals:
            del self._chunking[slot]
            self.active[slot] = req
            if self.paged:
                self._insert_radix(req, self._slot_pages[slot])
        return finals, out

    def _decode_fn(self, cap: Optional[int]):
        st = self.state

        def fn():
            logits, cache = model_lib.decode_step(
                self.params, st.cache, st.last_token, self.cfg, kv_cap=cap,
                fused_paged=self.fused_decode)
            tok = sample_tokens(logits[:, 0], st.temp, self.key, st.tag,
                                st.counter)
            rem = st.remaining - 1
            done = (rem <= 0) | (cache.lengths >= self.max_len - 1)
            if self.eos_id is not None:
                done = done | (tok == self.eos_id)
            done = st.active & done
            # Every new value first, from the old ``active``; then the
            # in-place writes.
            last = torch.where(st.active[:, None], tok[:, None],
                               st.last_token)
            remaining = torch.where(st.active, rem, st.remaining)
            counter = st.counter + st.active.to(torch.int32)
            active = st.active & ~done
            for buf, new in ((st.cache.lengths, cache.lengths),
                             (st.last_token, last),
                             (st.remaining, remaining),
                             (st.counter, counter), (st.active, active)):
                buf.copy_(new)
            return tok, done

        return fn

    def _draft_chain(self) -> Tensor:
        """The draft model's chain for every slot, (slots, K): K+1 greedy
        decode steps on the draft cache. K+1, not K: on full acceptance the
        target commits rows n0..n0+K, so the draft cache must hold d_K's
        row too before the lengths are synced. Runs inside the verify's
        callable; the draft cache's lengths are synced there."""
        st, k = self.state, self.spec.k
        dc, tok, drafts = self._spec_dcache, st.last_token, []
        for _ in range(k + 1):
            dlg, dc = model_lib.decode_step(self.spec.draft_params, dc, tok,
                                            self.spec.draft_cfg)
            nt = sample_tokens(dlg[:, 0], st.temp, self.key, st.tag,
                               st.counter)
            tok = nt[:, None]
            drafts.append(nt)
        return torch.stack(drafts[:k], dim=1)

    def _verify_fn(self, cap: Optional[int]):
        """The speculative replacement for :meth:`_decode_fn`: the target's
        chain verify over [pending, d_1..d_K], every column sampled by the
        same sampler as the non-spec step (greedy rows take the
        lowest-index argmax), the longest accepted prefix kept with the
        non-spec done predicate per emission, and ``lengths`` rolled back
        to it. Returns (tokens (slots, K+1), emitted counts, done). An
        ngram engine reads its drafts from a static input."""
        st = self.state

        def fn(*draft_in):
            draft = draft_in[0] if draft_in else self._draft_chain()
            tokens = torch.cat([st.last_token, draft], dim=1)
            logits, cache = model_lib.verify_step(
                self.params, st.cache, tokens, self.cfg, kv_cap=cap,
                fused_paged=self.fused_decode)
            b, s, v = logits.shape
            ctrs = (st.counter[:, None] + torch.arange(
                s, dtype=torch.int32, device=self.device)[None, :]
                    ).reshape(-1)
            greedy = sample_tokens(logits.reshape(b * s, v),
                                   st.temp.repeat_interleave(s), self.key,
                                   st.tag.repeat_interleave(s), ctrs
                                   ).reshape(b, s)
            n0 = st.cache.lengths
            _emit, e, stop = chain_accept(greedy, draft, st.remaining, n0,
                                          max_len=self.max_len,
                                          eos=self.eos_id)
            done = st.active & stop
            e_act = torch.where(st.active, e, 0)
            last = torch.gather(greedy, 1, (e - 1).to(torch.int64)[:, None])
            lengths = torch.where(st.active, n0 + e, cache.lengths)
            last = torch.where(st.active[:, None], last, st.last_token)
            remaining = st.remaining - e_act
            counter = st.counter + e_act
            active = st.active & ~done
            for buf, new in ((st.cache.lengths, lengths),
                             (st.last_token, last),
                             (st.remaining, remaining),
                             (st.counter, counter), (st.active, active)):
                buf.copy_(new)
            if self._spec_model:
                # The draft cache's committed extent follows the target's.
                self._spec_dcache.lengths.copy_(lengths)
            return greedy, e_act, done

        return fn

    def _decode_step(self):
        """The step's decode (or chain verify) through its callable, keyed
        by the host-picked KV-extent cap (kept for the energy books).
        Returns its outputs and its span, which the energy books annotate
        after it closes."""
        cap = self._step_cap = self._decode_cap()
        self.decode_launches += 1
        self._m_decode_launches.inc()
        if self.spec is None:
            base, fn, args = "decode_and_sample", self._decode_fn(cap), ()
        else:
            base, fn = "decode_and_verify", self._verify_fn(cap)
            args = () if self._spec_model else (self._build_drafts(),)
        name = base if cap is None else f"{base}[c{cap}]"
        with self.tracer.span(base, "serve.decode", tid=TID_SERVE, cap=cap,
                              active=len(self.active)) as sp:
            out = self.graphs.call(name, fn, *args)
        return out, sp

    def _decode_cap(self) -> Optional[int]:
        """KV-extent cap (tokens) for this step's fused paged decode, or
        None. The largest extent any active slot touches this step is
        ``prompt + generated`` (the decode writes at its last position),
        plus the draft depth for a chain verify, rounded up to a pow2 page
        count. Pages past a row's length are masked, so the cap changes
        nothing on any live row; mid-prefill slots do not count (their
        decode row is discarded)."""
        if not (self.paged and self.fused_decode):
            return None
        need = 1
        for req in self.active.values():
            need = max(need, len(req.prompt) + max(len(req.generated), 1))
        if self.spec is not None:
            need += self.spec.k
        pages = -(-need // self.page_size)
        t = 1 << max(pages - 1, 0).bit_length()
        return min(t, self.n_ptab) * self.page_size

    # -- speculative drafts and scratch pages --------------------------------
    def _build_drafts(self) -> np.ndarray:
        """Host prompt-lookup proposals, (slots, K), for every active slot;
        idle rows stay zero (their verify is masked by ``active``).
        ``generated`` already holds the pending token, so the proposal
        continues the chain the verify scores."""
        k = self.spec.k
        draft = np.zeros((self.slots, k), np.int32)
        for slot, req in self.active.items():
            n_prompt = len(req.prompt)
            total = n_prompt + len(req.generated)
            ent = self._spec_hist.get(slot)
            if ent is None or ent[0] != req.uid or ent[2] > total:
                buf = np.empty((total + req.max_new_tokens + k + 8,),
                               np.int64)
                buf[:n_prompt] = np.asarray(req.prompt,
                                            np.int64).reshape(-1)
                ent = self._spec_hist[slot] = [req.uid, buf, n_prompt]
            buf, filled = ent[1], ent[2]
            if total > len(buf):
                buf = np.concatenate([buf, np.empty_like(buf)])
                ent[1] = buf
            if total > filled:
                buf[filled:total] = req.generated[filled - n_prompt:]
                ent[2] = total
            draft[slot] = propose_ngram(buf[:total], k,
                                        max_n=self.spec.ngram_max)
        return draft

    def _attach_scratch_pages(self) -> Dict[int, List[int]]:
        """Back the chain's overhang with per-step scratch pages: the
        admission reservation covers every position the accept rule can
        commit, but the verify writes through ``n0 + K``. The uncovered
        tail of each slot is allocated without eviction (scratch never
        takes the radix cache's pages); on shortfall the table keeps
        pointing at the trash page, which is correct since overhang rows
        are never read back as committed state. Returns {slot: pages}."""
        k, ps = self.spec.k, self.page_size
        ids: List[int] = []
        rows: List[np.ndarray] = []
        scratch: Dict[int, List[int]] = {}
        for slot, req in self.active.items():
            owned = self._slot_pages.get(slot)
            if not owned:
                continue
            n0 = len(req.prompt) + max(len(req.generated), 1) - 1
            need = min(n0 + k, self.max_len - 1) // ps + 1
            if need <= len(owned):
                continue
            extra = self.pool.alloc(need - len(owned))
            if extra is None:
                continue  # the trash page takes the overhang
            scratch[slot] = extra
            row = np.zeros((self.n_ptab,), np.int32)
            row[: len(owned)] = owned
            row[len(owned): len(owned) + len(extra)] = extra
            ids.append(slot)
            rows.append(row)
        if ids:
            model_lib.set_page_rows(self.state.cache,
                                    np.asarray(ids, np.int32),
                                    np.stack(rows))
        return scratch

    def _release_scratch_pages(self, scratch: Dict[int, List[int]]) -> None:
        """Give this step's scratch pages back to the pool. The table rows
        are reset first: a released page may be handed out before the next
        step, and a stale entry would let the slot write into it."""
        ids = np.asarray(sorted(scratch), np.int32)
        rows = np.zeros((len(ids), self.n_ptab), np.int32)
        for r, slot in enumerate(ids):
            owned = self._slot_pages.get(int(slot), [])
            rows[r, : len(owned)] = owned
        model_lib.set_page_rows(self.state.cache, ids, rows)
        for pages in scratch.values():
            for p in pages:
                self.pool.release(p)

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
        tr = self.tracer
        with tr.span("radix.match", "serve.radix", tid=TID_SERVE,
                     uid=req.uid) as sp:
            pages, skip = self.radix.match(req.prompt)
            sp.set(skip=skip, pages=len(pages))
        # all_or_nothing: an admission that fails anyway must not destroy
        # cached prefixes the next requests would reuse.
        ev0 = self.radix.evictions
        fresh = self.pool.alloc(
            need - len(pages),
            evict=lambda k: self.radix.evict(k, all_or_nothing=True))
        if self.radix.evictions > ev0:
            n_ev = self.radix.evictions - ev0
            self._m_evictions.inc(n_ev)
            if tr.enabled:
                tr.instant("pool.evict", "serve.radix", tid=TID_SERVE,
                           evicted=n_ev)
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

    def _count_admit(self, slot: int, req: Request, skip: int,
                     pages) -> None:
        """Book an admitted paged request: its pages and the hit
        counters."""
        self._slot_pages[slot] = list(pages)
        self._prompt_tokens += len(req.prompt)
        self._prefix_tokens += skip
        if skip:
            self._prefix_hits += 1
            self._m_radix_hits.inc()
            self._m_radix_hit_tokens.inc(skip)

    def _insert_radix(self, req: Request, pages) -> None:
        """Index the prompt's full pages in the radix tree. A chunked
        admission inserts at its final chunk: only then has every page's
        K/V been written."""
        n_full = len(req.prompt) // self.page_size
        if n_full:
            with self.tracer.span("radix.insert", "serve.radix",
                                  tid=TID_SERVE, uid=req.uid,
                                  pages=n_full):
                self.radix.insert(req.prompt[: n_full * self.page_size],
                                  pages[:n_full])

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request) -> None:
        if self.spec is not None and req.temperature > 0.0:
            raise ValueError("speculative decoding is greedy-only: the "
                             "chain-accept rule replays argmax, not the "
                             "tempered sampling stream")
        # Latency and TTFT are measured from submission, not construction.
        req.submit_t = time.monotonic()
        req.prefilled = 0
        req.skipped = 0
        req.queued_step = self.sched.now
        self.queue.append(req)
        self._m_submitted.inc()
        self._m_queue_depth.set(float(len(self.queue)))

    def step(self) -> List[Finished]:
        """One engine step: scheduler admission into free slots (with page
        reservation on a paged engine), at most one chunk wave and one
        prefill wave per length bucket, one fused decode_and_sample (or
        chain verify), and a single device->host copy of the new tokens
        and done masks."""
        tr = self.tracer
        with tr.span("engine.step", "serve", tid=TID_SERVE) as sp:
            out = self._step_impl()
            if tr.enabled:
                sp.set(step=self.sched.now, finished=len(out),
                       active=len(self.active))
            return out

    def _step_impl(self) -> List[Finished]:
        tr = self.tracer
        t_step0 = time.monotonic() if self.health is not None else 0.0
        had_active = bool(self.active)
        C = self.chunk_tokens
        tracker = self.sched.begin_step()
        if self._chunking:
            # In-flight prefills always progress and outrank admissions.
            cont = sum(min(C, len(r.prompt) - r.prefilled)
                       for r in self._chunking.values())
            tracker.spend(cont, self.sched.cost.prefill_pj(cont))
        free = [i for i in range(self.slots)
                if i not in self.active and i not in self._chunking]
        with tr.span("sched.pick", "serve.sched", tid=TID_SERVE) as sp_pick:
            picks = self.sched.pick(self.queue, len(free), tracker,
                                    self._try_reserve if self.paged
                                    else None)
            sp_pick.set(free=len(free), picked=len(picks),
                        queued=len(self.queue))
        self._m_queue_depth.set(float(len(self.queue)))
        admits, chunked = [], []
        for req, (skip, pages) in picks:
            assert len(req.prompt) < self.max_len, \
                "prompt longer than cache"
            slot = free.pop(0)
            if C is not None and len(req.prompt) - skip > C:
                req.prefilled = skip
                self._chunking[slot] = req
                chunked.append((slot, req, skip, pages))
            else:
                admits.append((slot, req, skip, pages))
        if self.paged and picks:
            self._assign_page_tables(admits + chunked)
            for slot, req, skip, pages in chunked:
                self._count_admit(slot, req, skip, pages)
        # waves: ([(row, slot, request) sampled], (tokens, done)).
        waves = []
        if self._chunking:
            with tr.span("prefill.chunk_wave", "serve.prefill",
                         tid=TID_SERVE, chunk=C) as sp_cw:
                waves.append(self._run_chunk_wave(sp_cw))
        by_bucket: Dict[int, list] = {}
        for slot, req, skip, pages in admits:
            sb = bucket_for(len(req.prompt) - skip, self.max_len,
                            self.min_bucket)
            by_bucket.setdefault(sb, []).append((slot, req, skip, pages))
        if had_active and any(sb > self._stall_ref for sb in by_bucket):
            self.decode_stall_steps += 1
            self._m_stalls.inc()
        for sb in sorted(by_bucket):
            group = by_bucket[sb]
            with tr.span(f"prefill.wave[{sb}]", "serve.prefill",
                         tid=TID_SERVE, bucket=sb, rows=len(group)) as sp_w:
                out = self._prefill_wave(sb, group, sp_w)
            waves.append(([(r, slot, req) for r, (slot, req, _s, _p)
                           in enumerate(group)], out))
        dec = None
        dec_sp = NOOP_SPAN
        scratch = None
        sampled = [req for rows, _ in waves for _, _, req in rows]
        if had_active or any(r.max_new_tokens > 1 for r in sampled):
            self.steps += 1
            self._m_steps.inc()
            if self.spec is not None and self.paged:
                scratch = self._attach_scratch_pages()
            dec, dec_sp = self._decode_step()
        if not waves and dec is None:
            return []
        # The step's single device->host copy: tokens + done masks (and a
        # verify's emitted counts).
        outs = [o for _, o in waves] + ([dec] if dec is not None else [])
        flat = [t.to(torch.int32).reshape(-1) for o in outs for t in o]
        with tr.span("host_transfer", "serve", tid=TID_SERVE):
            host = torch.cat(flat).cpu().numpy()
        self.host_transfers += 1
        parts, at = [], 0
        for t in flat:
            parts.append(host[at: at + t.numel()])
            at += t.numel()
        now = time.monotonic()
        finished: List[Finished] = []
        freed: List[int] = []
        for w, (rows, _) in enumerate(waves):
            tok, done = parts[2 * w], parts[2 * w + 1]
            for r, slot, req in rows:
                self._append_tokens(req, tok[r:r + 1], now)
                if done[r]:
                    finished.append(self._finish(req, now))
                    del self.active[slot]
                    freed.append(slot)
        if dec is not None:
            tok = parts[2 * len(waves)]
            done = parts[-1]
            if self.spec is None:
                tok, emit = tok[:, None], np.ones(self.slots, np.int64)
            else:
                tok = tok.reshape(self.slots, self.spec.k + 1)
                emit = parts[2 * len(waves) + 1]
            if self._hw is not None:
                self._book_decode(self._step_cap, emit, dec_sp)
            for slot, req in list(self.active.items()):
                e = int(emit[slot])
                if self.spec is not None:
                    self._spec_proposed += self.spec.k
                    self._spec_accepted += max(e - 1, 0)
                    self._m_spec_proposed.inc(self.spec.k)
                    self._m_spec_accepted.inc(max(e - 1, 0))
                    self._m_spec_emit.observe(float(e))
                self._append_tokens(req, tok[slot, :e], now)
                if done[slot]:
                    finished.append(self._finish(req, now))
                    del self.active[slot]
                    freed.append(slot)
        if scratch:
            self._release_scratch_pages(scratch)
        if self.paged and freed:
            self._teardown_slots(freed)
        if self.paged:
            self._m_pool_in_use.set(float(self.pool.pages_in_use))
        if tr.enabled:
            # Counter tracks beside the spans: queue depth, pool occupancy
            # and the twin's pJ and wear.
            tr.counter("serve.queue_depth", float(len(self.queue)),
                       tid=TID_SERVE)
            if self.paged:
                tr.counter("pool.occupancy", float(self.pool.pages_in_use),
                           tid=TID_SERVE)
            if self._hw is not None:
                tr.counter("hw.attributed_pj", self._hw.attributed_pj,
                           tid=TID_SERVE)
                if self._hw.wear is not None:
                    tr.counter("hw.tile_read_chunks_max",
                               self._hw.wear.reads_max, tid=TID_SERVE)
        if self.health is not None:
            self._observe_health(t_step0)
        return finished

    def _observe_health(self, t0: float) -> None:
        """Feed the health monitor one step's deltas (DESIGN.md §13): the
        TTFT and ITL series are the histograms' per-step (sum, count)
        delta means, and pJ per token the attributed-pJ delta over the
        step's emitted tokens (each books one TTFT or ITL sample)."""
        h = self.health
        h.observe("serve.step_wall_s", time.monotonic() - t0)
        h.observe("serve.queue_depth", float(len(self.queue)))
        d_ttft_n = self._m_ttft.count - self._h_ttft_count
        d_ttft_s = self._m_ttft.sum - self._h_ttft_sum
        self._h_ttft_count = self._m_ttft.count
        self._h_ttft_sum = self._m_ttft.sum
        if d_ttft_n:
            h.observe("serve.ttft_s", d_ttft_s / d_ttft_n)
        d_itl_n = self._m_itl.count - self._h_itl_count
        d_itl_s = self._m_itl.sum - self._h_itl_sum
        self._h_itl_count = self._m_itl.count
        self._h_itl_sum = self._m_itl.sum
        if d_itl_n:
            h.observe("serve.itl_s", d_itl_s / d_itl_n)
        if self.paged:
            h.observe("serve.pool_occupancy", float(self.pool.pages_in_use))
        if self._hw is not None:
            d_pj = self._hw.attributed_pj - self._h_pj
            self._h_pj = self._hw.attributed_pj
            d_tok = d_ttft_n + d_itl_n
            if d_tok:
                h.observe("serve.pj_per_token", d_pj / d_tok)
        if self.spec is not None:
            d_prop = self._spec_proposed - self._h_spec_proposed
            d_acc = self._spec_accepted - self._h_spec_accepted
            self._h_spec_proposed = self._spec_proposed
            self._h_spec_accepted = self._spec_accepted
            if d_prop:
                h.observe("serve.spec_accept", d_acc / d_prop,
                          direction="down")

    def _append_tokens(self, req: Request, toks, now: float) -> None:
        """Book the tokens one step emitted for a request (a verify can
        emit several). A request's first token books TTFT (queue wait and
        full prefill); every other token books one inter-token latency,
        the step's wall gap split evenly over its emitted tokens, so a
        verify's K+1 tokens do not read as one gap."""
        toks = [int(t) for t in toks]
        if not toks:
            return
        fresh = not req.generated
        gap = 0.0 if fresh else max(now - req.last_token_t, 0.0)
        n_itl = len(toks) - 1 if fresh else len(toks)
        if fresh:
            req.first_token_t = now
            self._ttfts.append(max(now - req.submit_t, 0.0))
            self._m_ttft.observe(max(now - req.submit_t, 0.0))
        if n_itl > 0:
            per = gap / n_itl
            for _ in range(n_itl):
                self._m_itl.observe(per)
        req.generated.extend(toks)
        req.last_token_t = now

    def _finish(self, req: Request, now: float) -> Finished:
        n_tok = len(req.prompt) + len(req.generated)
        lat = max(now - req.submit_t, 0.0)
        self._latencies.append(lat)
        self._new_tokens += len(req.generated)
        self._finished_count += 1
        self._m_latency.observe(lat)
        self._m_new_tokens.inc(len(req.generated))
        self._m_finished.inc()
        return Finished(uid=req.uid, tokens=np.asarray(req.generated),
                        energy_pj=req.energy_pj,
                        pj_per_token=req.energy_pj / max(n_tok, 1),
                        latency_s=lat,
                        ttft_s=max(req.first_token_t - req.submit_t, 0.0))

    def run_until_drained(self, max_steps: int = 10_000) -> List[Finished]:
        out: List[Finished] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.active and not self._chunking and not self.queue:
                return out
        raise RuntimeError(
            f"run_until_drained: {len(self.queue)} queued, "
            f"{len(self.active) + len(self._chunking)} in flight after "
            f"{max_steps} steps")

    def compile_cache_stats(self) -> Dict[str, int]:
        """Step callables built per name, as the reference's: each entry is
        1 (one capture, or one eager callable, per static shape);
        ``prefill_total`` sums the target's prefill waves (bucket and chunk
        shapes) and ``decode_total`` the decode or verify cap variants."""
        stats = dict(self.graphs.counts)
        stats["prefill_total"] = sum(
            v for k, v in stats.items() if k.startswith("prefill["))
        stats["decode_total"] = sum(
            v for k, v in stats.items() if k.startswith("decode_and_"))
        return stats

    def hw_telemetry(self) -> Optional[Dict[str, float]]:
        """The hw twin's serving aggregates (None when its books are off):
        attributed against total crossbar energy, the per-phase split, the
        idle remainder (empty decode slots and dummy wave rows), decode
        slot utilization, the prefix-hit credit, the speculative split and
        the wear book's per-tile reads."""
        return self._hw.telemetry() if self._hw is not None else None

    def stats(self) -> Dict[str, float]:
        """Throughput/latency aggregates (zero-request safe); on a paged
        engine the pool and radix counters, on a speculative one the
        draft counters, with energy books the twin's telemetry as
        ``hw_<key>``, and with ``slos`` each one's burn rate and verdict."""
        cc = self.compile_cache_stats()
        out = {
            "steps": float(self.steps),
            "host_transfers": float(self.host_transfers),
            "finished": float(self._finished_count),
            "new_tokens": float(self._new_tokens),
            "latency_p50_s": percentile(self._latencies, 50),
            "latency_p95_s": percentile(self._latencies, 95),
            "ttft_p50_s": percentile(self._ttfts, 50),
            "ttft_p95_s": percentile(self._ttfts, 95),
            "prefill_compiles": float(cc["prefill_total"]),
            "decode_compiles": float(cc["decode_total"]),
            "decode_launches": float(self.decode_launches),
            "chunk_waves": float(self.chunk_waves),
            "decode_stall_steps": float(self.decode_stall_steps),
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
        if self.spec is not None:
            out.update({
                "spec_k": float(self.spec.k),
                "spec_proposed": float(self._spec_proposed),
                "spec_accepted": float(self._spec_accepted),
                "spec_accept_rate": (self._spec_accepted
                                     / max(self._spec_proposed, 1)),
                # Emitted tokens per verify step (>= 1; K+1 at best).
                "spec_tokens_per_step": (self._new_tokens
                                         / max(self.steps, 1)),
            })
        if self._hw is not None:
            out.update({f"hw_{k}": float(v)
                        for k, v in self._hw.telemetry().items()})
        # Declarative SLOs: only an engine given ``slos`` grows these keys.
        for spec in self.slos:
            st = spec.evaluate(self.metrics)
            out[f"slo_{spec.name}_burn_rate"] = st.burn_rate
            out[f"slo_{spec.name}_ok"] = float(st.ok)
        return out
