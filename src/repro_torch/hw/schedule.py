"""Admission cost and per-step budget for the serving scheduler (the part
of ``repro.hw.schedule`` that ``serve/sched.Scheduler`` uses by default).

The reference module imports JAX for the hardware twin (census, placement,
energy, wear), so the port keeps its own copy of the three pure classes:
:class:`StepBudget`, :class:`BudgetTracker` and the token-count form of
:class:`AdmissionCost` (1.0 pJ per token, no wear surcharge).
``AdmissionCost.for_model`` and the rest of the twin come with the hw-twin
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class StepBudget:
    """Per-engine-step prefill admission budget (DESIGN.md §10).

    ``prefill_tokens`` bounds the prefill positions launched per step;
    ``prefill_pj`` bounds their projected crossbar read energy. None
    disables that axis."""

    prefill_tokens: Optional[int] = None
    prefill_pj: Optional[float] = None


class BudgetTracker:
    """Mutable within-step remainder of a `StepBudget`."""

    def __init__(self, budget: Optional[StepBudget]):
        b = budget or StepBudget()
        self.tokens_left = (float("inf") if b.prefill_tokens is None
                            else int(b.prefill_tokens))
        self.pj_left = (float("inf") if b.prefill_pj is None
                        else float(b.prefill_pj))

    def fits(self, tokens: int, pj: float) -> bool:
        return tokens <= self.tokens_left and pj <= self.pj_left

    def spend(self, tokens: int, pj: float) -> None:
        self.tokens_left -= tokens
        self.pj_left -= pj


class AdmissionCost:
    """Per-token prefill and decode costs used to score queued requests.
    The default 1.0 pJ per token makes scores token counts, as the
    reference's does without a placement."""

    def __init__(self, token_pj: float = 1.0, decode_token_pj: float = 1.0):
        self.token_pj = float(token_pj)
        self.decode_token_pj = float(decode_token_pj)

    def prefill_pj(self, tokens: int) -> float:
        """Projected pJ of prefilling ``tokens`` positions."""
        return tokens * self.token_pj

    def request_score(self, remaining_prompt: int, max_new: int) -> float:
        """Projected cost of finishing a request from here: the
        un-prefilled prompt remainder plus its decode-slot occupancy."""
        return (remaining_prompt * self.token_pj
                + max_new * self.decode_token_pj)
