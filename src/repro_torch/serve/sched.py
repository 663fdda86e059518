"""Host-side admission scheduler for the serving engine (port of
``repro.serve.sched``, DESIGN.md §10).

- ``fcfs``: arrival order with a BOUNDED skip-ahead past requests that
  cannot reserve pages (``max_skip`` positions past the first blocked one)
  and a starvation guard: every pass-over bumps the blocked request's
  ``skipped`` counter, and once it reaches ``starve_after`` nothing is
  admitted past it, so an aged request regains strict priority.
- ``cost``: the front ``window`` of the queue scored with
  ``hw/schedule.AdmissionCost`` (per-chunk crossbar pJ plus projected
  decode-slot occupancy from the Table I read costs, decayed by age) and
  admitted cheapest-first against the per-step ``StepBudget``; a request
  passed over ``starve_after`` times goes to the front.

Page reservation stays in the engine and comes in as a callable: the dense
engine passes none (every candidate reserves trivially), the paged engine
its pool reservation. With ``chunk_tokens`` (chunked prefill) an admission
costs the step budget its first chunk only; the engine pre-charges the
chunks of prompts already in flight before it picks. The scheduler is pure
host bookkeeping.
"""
from __future__ import annotations

from typing import Callable, Deque, List, Optional, Tuple

from repro_torch.hw.schedule import AdmissionCost, BudgetTracker, StepBudget
from repro_torch.serve.request import Request

# (skip, pages) grant for engines without page reservation.
DENSE_GRANT: Tuple[int, None] = (0, None)

POLICIES = ("fcfs", "cost")


class Scheduler:
    """Admission policy: which queued requests enter free slots this step,
    against an optional per-step prefill ``budget``. ``policy`` is "fcfs"
    (arrival order + skip-ahead on reservation failure) or "cost"
    (cheapest-first within ``window``). ``chunk_tokens`` caps the first
    prefill wave a request costs at admission (the chunk waves take over
    from there); None/0 means the whole prompt lands in one wave."""

    def __init__(self, policy: str = "fcfs", *,
                 cost: Optional[AdmissionCost] = None,
                 budget: Optional[StepBudget] = None,
                 chunk_tokens: Optional[int] = None,
                 max_skip: int = 8, starve_after: int = 4,
                 window: int = 32):
        if policy not in POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"one of {POLICIES}")
        self.policy = policy
        self.cost = cost or AdmissionCost()
        self.budget = budget
        self.chunk_tokens = chunk_tokens or None
        self.max_skip = max_skip
        self.starve_after = starve_after
        self.window = window
        self.now = 0              # engine steps seen (the age clock)

    def begin_step(self) -> BudgetTracker:
        """Advance the age clock and open this step's budget tracker. The
        engine pre-charges chunk continuations on the tracker before calling
        :meth:`pick`: in-flight prefills outrank every admission."""
        self.now += 1
        return BudgetTracker(self.budget)

    def admit_tokens(self, req: Request, skip: int = 0) -> int:
        """Prefill positions the admission itself launches this step: the
        first chunk (chunked) or the whole non-cached remainder."""
        remaining = max(len(req.prompt) - skip, 1)
        if self.chunk_tokens:
            return min(remaining, self.chunk_tokens)
        return remaining

    def _rank(self, req: Request) -> Tuple[float, int]:
        score = self.cost.request_score(
            max(len(req.prompt) - req.prefilled, 0), req.max_new_tokens)
        # Linear age decay: a request's projected cost fades as it waits,
        # so expensive requests drift forward instead of parking forever
        # (the hard guarantee is still the starve_after guard).
        age = max(self.now - req.queued_step, 0)
        return (score / (1.0 + 0.25 * age), req.queued_step)

    def _order(self, queue) -> List[int]:
        if self.policy == "fcfs":
            return list(range(len(queue)))
        idx = list(range(min(len(queue), self.window)))
        starved = [i for i in idx
                   if queue[i].skipped >= self.starve_after]
        fresh = [i for i in idx
                 if queue[i].skipped < self.starve_after]
        fresh.sort(key=lambda i: self._rank(queue[i]))
        return starved + fresh

    def pick(self, queue: Deque[Request], n_free: int,
             tracker: BudgetTracker,
             try_reserve: Optional[Callable[[Request], Optional[tuple]]]
             = None) -> List[Tuple[Request, tuple]]:
        """Select up to ``n_free`` requests, remove them from ``queue``,
        and return [(request, (skip, pages))]. Requests that fail to
        reserve stay queued; their ``skipped`` counters age them toward
        strict priority."""
        if n_free <= 0 or not queue:
            return []
        picked: List[Tuple[int, Request, tuple]] = []
        blocked: List[int] = []       # queue positions passed over
        first_block: Optional[int] = None
        for i in self._order(queue):
            if len(picked) >= n_free:
                break
            if (self.policy == "fcfs" and first_block is not None
                    and i > first_block + self.max_skip):
                break  # bounded skip-ahead: don't scan arbitrarily deep
            req = queue[i]
            starved = req.skipped >= self.starve_after
            tok = self.admit_tokens(req)
            pj = self.cost.prefill_pj(tok)
            if not tracker.fits(tok, pj):
                if self.policy == "fcfs" or starved:
                    break  # order (or the aged request) holds the step
                blocked.append(i)
                if first_block is None:
                    first_block = i
                continue
            grant = try_reserve(req) if try_reserve else DENSE_GRANT
            if grant is None:
                if starved:
                    break  # starvation guard: nothing passes an aged head
                blocked.append(i)
                if first_block is None:
                    first_block = i
                continue
            picked.append((i, req, grant))
            tracker.spend(tok, pj)
        if picked:
            last = max(i for i, _, _ in picked)
            for j in blocked:
                if j < last:
                    queue[j].skipped += 1
        for i in sorted((i for i, _, _ in picked), reverse=True):
            del queue[i]
        return [(req, grant) for _, req, grant in picked]
