"""Shared serving types (port of ``repro.serve.request``): request and
finished records and the nearest-rank percentile."""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    generated: List[int] = dataclasses.field(default_factory=list)
    submit_t: float = dataclasses.field(default_factory=time.monotonic)
    skipped: int = 0              # times a younger request was admitted
                                  # first (serve/sched's starvation guard)
    first_token_t: float = 0.0    # wall time the first token landed (TTFT)
    last_token_t: float = 0.0     # wall time of the latest token


@dataclasses.dataclass
class Finished:
    uid: int
    tokens: np.ndarray
    latency_s: float = 0.0        # submit -> finished wall time
    ttft_s: float = 0.0           # submit -> first token wall time


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile; 0.0 for an empty input."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]
