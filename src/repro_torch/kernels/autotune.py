"""Split count for the fused paged-attention kernels K4 and K5 (port of
``repro.kernels.autotune``'s lookup, DESIGN.md §9).

The only tunable of ``kernels/paged_attn.py`` is ``n_splits``: how many
blocks share one row's page-table walk (per kv-head for K4, per group of
heads for K5). More splits buy parallelism on the card's 132 SMs and pay
a combine (for K5 one (H, C) float32 state per split and row). ``chip_smoke.py``
times the candidates at the serving decode shape on the card and prints
the winner; the winners are committed to ``autotune_h100.json`` beside
this module, a record the port owns. It never reads ``BENCH_kernel.json``:
the reference's values there were measured on a CPU.

Keys are ``p{page}_h{heads}_d{head_dim}`` with an optional ``_r{rows}``
(the launch batch). Lookup order, as the reference's: the exact
rows-qualified key, then the rows-agnostic key, then the nearest recorded
shape in log space, and 1 when the record is empty.
"""
from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

RECORD_PATH = Path(__file__).resolve().with_name("autotune_h100.json")
_CACHE_KEY = "paged_attn_n_splits"
_memo: Dict[str, int] = {}
_persisted: Optional[Dict[str, int]] = None

_KEY_RE = re.compile(r"^p(\d+)_h(\d+)_d(\d+)(?:_r(\d+))?$")


def shape_key(page_size: int, heads: int, head_dim: int,
              rows: Optional[int] = None) -> str:
    base = f"p{page_size}_h{heads}_d{head_dim}"
    return base if rows is None else f"{base}_r{rows}"


def _parse_key(key: str) -> Optional[Tuple[int, int, int, Optional[int]]]:
    m = _KEY_RE.match(key)
    if not m:
        return None
    p, h, d, r = m.groups()
    return int(p), int(h), int(d), (int(r) if r is not None else None)


def _load_persisted() -> Dict[str, int]:
    global _persisted
    if _persisted is None:
        _persisted = {}
        try:
            payload = json.loads(RECORD_PATH.read_text())
            _persisted = {str(k): int(v)
                          for k, v in payload.get(_CACHE_KEY, {}).items()}
        except (OSError, ValueError):
            pass  # no record: the default below
    return _persisted


def _nearest_key(page_size: int, heads: int, head_dim: int,
                 rows: Optional[int]) -> Optional[str]:
    """Closest recorded shape by log2 distance over (page, heads, dim),
    with a softer rows term, as the reference's."""
    best_key, best_dist = None, None
    for key, _ in sorted(_load_persisted().items()):
        parsed = _parse_key(key)
        if parsed is None:
            continue
        p, h, d, r = parsed
        dist = (abs(math.log2(page_size / p)) + abs(math.log2(heads / h))
                + abs(math.log2(head_dim / d)))
        if rows is not None and r is not None:
            dist += 0.25 * abs(math.log2(rows / r))
        elif (rows is None) != (r is None):
            dist += 0.5
        if best_dist is None or dist < best_dist:
            best_key, best_dist = key, dist
    return best_key


def best_n_splits(page_size: int, heads: int, head_dim: int,
                  rows: Optional[int] = None) -> int:
    """Recorded split count for a kernel shape (>= 1; callers normalize
    it to a divisor of their table extent)."""
    key = shape_key(page_size, heads, head_dim, rows)
    if key not in _memo:
        persisted = _load_persisted()
        val = persisted.get(key)
        if val is None and rows is not None:
            val = persisted.get(shape_key(page_size, heads, head_dim))
        if val is None and persisted:
            near = _nearest_key(page_size, heads, head_dim, rows)
            if near is not None:
                val = persisted[near]
        _memo[key] = 1 if val is None else int(val)
    return max(1, _memo[key])


def record(page_size: int, heads: int, head_dim: int, n_splits: int,
           rows: Optional[int] = None) -> None:
    """Install a value for this process (tests pin the reference's)."""
    _memo[shape_key(page_size, heads, head_dim, rows)] = int(n_splits)


def clear_memo() -> None:
    """Drop in-process state so the record is read again."""
    global _persisted
    _memo.clear()
    _persisted = None
