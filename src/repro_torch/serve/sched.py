"""Host-side admission scheduler for the serving engine (port of
``repro.serve.sched``, DESIGN.md §10), ``fcfs`` policy.

Arrival order with a BOUNDED skip-ahead past requests that cannot reserve
pages (``max_skip`` positions past the first blocked one) and a
starvation guard: every pass-over bumps the blocked request's ``skipped``
counter, and once it reaches ``starve_after`` nothing is admitted past it,
so an aged request regains strict priority. Page reservation stays in the
engine and comes in as a callable: the dense engine passes none (every
candidate reserves trivially), the paged engine its pool reservation.

The reference's ``policy="cost"`` scores requests with the hardware twin's
costs, which the port does not have yet: it raises
``NotImplementedError``.
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
    against an optional per-step prefill ``budget``."""

    def __init__(self, policy: str = "fcfs", *,
                 budget: Optional[StepBudget] = None,
                 max_skip: int = 8, starve_after: int = 4):
        if policy not in POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"one of {POLICIES}")
        if policy == "cost":
            raise NotImplementedError(
                'policy="cost" needs the hardware twin, not ported yet')
        self.policy = policy
        self.cost = AdmissionCost()
        self.budget = budget
        self.max_skip = max_skip
        self.starve_after = starve_after
        self.now = 0              # engine steps seen (the age clock)

    def begin_step(self) -> BudgetTracker:
        """Advance the age clock and open this step's budget tracker."""
        self.now += 1
        return BudgetTracker(self.budget)

    def admit_tokens(self, req: Request) -> int:
        """Prefill positions the admission itself launches this step (the
        whole prompt: chunked prefill is not ported)."""
        return max(len(req.prompt), 1)

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
        for i in range(len(queue)):
            if len(picked) >= n_free:
                break
            if first_block is not None and i > first_block + self.max_skip:
                break  # bounded skip-ahead: don't scan arbitrarily deep
            req = queue[i]
            starved = req.skipped >= self.starve_after
            tok = self.admit_tokens(req)
            pj = self.cost.prefill_pj(tok)
            if not tracker.fits(tok, pj):
                break  # arrival order holds the step
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
