"""Device-resident continuous batching, dense fused path (port of
``repro.serve.engine``, DESIGN.md §7).

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

Behaviour kept from the reference: ``max_new_tokens=1`` finishes at
prefill, EOS is checked on the prefill token, a slot is done when its cache
length reaches ``max_len - 1``, and ``submit_t`` is stamped at ``submit``.
Temperature noise comes from a ``torch.Generator`` seeded with ``seed``
(the reference's threefry key chain is not ported), so only greedy streams
match the reference token for token.

Later slices: paged cache + radix reuse, chunked prefill, speculative
decoding, the cost scheduler, tracing, health and energy telemetry.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.sampling import sample_tokens
from repro_torch.models import model as model_lib
from repro_torch.serve.request import Finished, Request, percentile

Tensor = torch.Tensor


class EngineState(NamedTuple):
    """Device-resident engine state; every leaf but the cache is (slots,...)."""

    cache: model_lib.ModelCache
    last_token: Tensor    # (slots, 1) int32
    active: Tensor        # (slots,) bool
    temp: Tensor          # (slots,) float32
    remaining: Tensor     # (slots,) int32 — new tokens still allowed


def bucket_for(plen: int, cap: int, min_bucket: int = 8) -> int:
    """Length bucket for a prompt: next power of two >= plen, floored at
    ``min_bucket`` and capped at ``cap``."""
    b = max(min_bucket, 1 << max(plen - 1, 0).bit_length())
    return min(b, cap)


def _admit_update(state: EngineState, cache: model_lib.ModelCache,
                  logits: Tensor, ids: np.ndarray, temps: Tensor,
                  budgets: Tensor, *, eos: Optional[int], slots: int,
                  generator: Optional[torch.Generator]):
    """Shared tail of every prefill wave: sample the first token, apply the
    admission updates at ``ids`` (dummy rows, id >= slots, drop) and report
    per-row done masks. Admission guarantees prompt < max_len, so the first
    decode write always fits: cache-full can only trigger in decode."""
    tok = sample_tokens(logits[:, 0], temps, generator)
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
    return state._replace(cache=cache), (tok, done)


class Engine:
    """Fixed-slot continuous batching with a fused device step (dense
    cache, FCFS admission). ``device`` defaults to the card."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 seed: int = 0, min_bucket: int = 8, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = None if eos_id is None else int(eos_id)
        self.min_bucket = min_bucket
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        z_i = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self.state = EngineState(
            cache=model_lib.init_cache(cfg, slots, max_len, self.device),
            last_token=torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device),
            active=torch.zeros((slots,), dtype=torch.bool, device=self.device),
            temp=torch.zeros((slots,), dtype=torch.float32,
                             device=self.device),
            remaining=z_i)
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
        """One pow2-bucket prefill wave, padded to ``slots`` rows."""
        slots = self.slots
        tokens = np.zeros((slots, sb), np.int32)
        plens = np.zeros((slots,), np.int32)          # dummy rows: len 0
        ids = np.full((slots,), slots, np.int32)      # dummy rows: drop
        temps = np.zeros((slots,), np.float32)
        budgets = np.ones((slots,), np.int32)
        for r, (slot, req) in enumerate(group):
            p = np.asarray(req.prompt)
            tokens[r, : len(p)] = p
            plens[r] = len(p)
            ids[r] = slot
            temps[r] = req.temperature
            budgets[r] = req.max_new_tokens
        dev = self.device
        logits, cache = model_lib.prefill_into_slots(
            self.params, torch.as_tensor(tokens, device=dev), self.cfg,
            self.state.cache, torch.as_tensor(plens, device=dev), ids,
            max_len=self.max_len)
        self.state, out = _admit_update(
            self.state, cache, logits, ids, torch.as_tensor(temps, device=dev),
            torch.as_tensor(budgets, device=dev), eos=self.eos_id,
            slots=slots, generator=self.generator)
        return out

    def _decode_and_sample(self):
        st = self.state
        logits, cache = model_lib.decode_step(self.params, st.cache,
                                              st.last_token, self.cfg)
        tok = sample_tokens(logits[:, 0], st.temp, self.generator)
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
            remaining=torch.where(st.active, rem, st.remaining))
        return tok, done

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request) -> None:
        # Latency and TTFT are measured from submission, not construction.
        req.submit_t = time.monotonic()
        self.queue.append(req)

    def step(self) -> List[Finished]:
        """One engine step: FCFS admission into free slots, one prefill wave
        per length bucket, one fused decode_and_sample, and a single
        device->host copy of the new tokens and done masks."""
        had_active = bool(self.active)
        free = [i for i in range(self.slots) if i not in self.active]
        by_bucket: Dict[int, list] = {}
        while free and self.queue:
            req = self.queue.popleft()
            assert len(req.prompt) < self.max_len, \
                "prompt longer than cache"
            sb = bucket_for(len(req.prompt), self.max_len, self.min_bucket)
            by_bucket.setdefault(sb, []).append((free.pop(0), req))
        waves = []
        for sb in sorted(by_bucket):
            group = by_bucket[sb]
            waves.append((group, self._prefill_wave(sb, group)))
            for slot, req in group:
                self.active[slot] = req
        dec = None
        sampled = [req for group, _ in waves for _, req in group]
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
        for w, (group, _) in enumerate(waves):
            tok, done = host[2 * w], host[2 * w + 1]
            for r, (slot, req) in enumerate(group):
                self._append_token(req, int(tok[r]), now)
                if done[r]:
                    finished.append(self._finish(req, now))
                    del self.active[slot]
        if dec is not None:
            tok, done = host[-2], host[-1]
            for slot, req in list(self.active.items()):
                self._append_token(req, int(tok[slot]), now)
                if done[slot]:
                    finished.append(self._finish(req, now))
                    del self.active[slot]
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
        """Throughput/latency aggregates (zero-request safe)."""
        return {
            "steps": float(self.steps),
            "host_transfers": float(self.host_transfers),
            "finished": float(self._finished_count),
            "new_tokens": float(self._new_tokens),
            "latency_p50_s": percentile(self._latencies, 50),
            "latency_p95_s": percentile(self._latencies, 95),
            "ttft_p50_s": percentile(self._ttfts, 50),
            "ttft_p95_s": percentile(self._ttfts, 95),
        }
