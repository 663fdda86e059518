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
(the launch batch) and an optional ``_t{pages}`` after it (the table
extent a call walks, the engine's pow2 KV-extent cap): the best split
count depends on both, since rows x head groups x splits is what fills the
card (at the chain verify's 20 rows K5 is fastest at one split on short
tables and at two on a 32-page one). Lookup order: the rows- and
extent-qualified key, the key of the same shape and rows whose extent is
nearest in log space (the smaller on a tie), the rows-qualified key, the
rows-agnostic key (the reference's order from the third on), then the
nearest recorded shape in log space, and 1 when the record is empty. So
where a shape and row count has extent-qualified records, they alone
decide. A value pinned with :func:`record` is found before any recorded
one.
"""
from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

RECORD_PATH = Path(__file__).resolve().with_name("autotune_h100.json")
_CACHE_KEY = "paged_attn_n_splits"
_memo: Dict[str, int] = {}       # values pinned with record()
_resolved: Dict[tuple, int] = {}  # lookups already answered
_persisted: Optional[Dict[str, int]] = None

_KEY_RE = re.compile(r"^p(\d+)_h(\d+)_d(\d+)(?:_r(\d+))?(?:_t(\d+))?$")


def shape_key(page_size: int, heads: int, head_dim: int,
              rows: Optional[int] = None, pages: Optional[int] = None
              ) -> str:
    key = f"p{page_size}_h{heads}_d{head_dim}"
    if rows is not None:
        key += f"_r{rows}"
    if pages is not None:
        key += f"_t{pages}"
    return key


def _parse_key(key: str):
    """(page, heads, head_dim, rows or None, pages or None), or None."""
    m = _KEY_RE.match(key)
    if not m:
        return None
    p, h, d, r, t = m.groups()
    return (int(p), int(h), int(d), None if r is None else int(r),
            None if t is None else int(t))


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
                 rows: Optional[int], pages: Optional[int]) -> Optional[str]:
    """Closest recorded shape by log2 distance over (page, heads, dim),
    with softer rows and extent terms, as the reference's rows term."""
    best_key, best_dist = None, None
    for key, _ in sorted(_load_persisted().items()):
        parsed = _parse_key(key)
        if parsed is None:
            continue
        p, h, d, r, t = parsed
        dist = (abs(math.log2(page_size / p)) + abs(math.log2(heads / h))
                + abs(math.log2(head_dim / d)))
        for want, got in ((rows, r), (pages, t)):
            if want is not None and got is not None:
                dist += 0.25 * abs(math.log2(want / got))
            elif (want is None) != (got is None):
                dist += 0.5
        if best_dist is None or dist < best_dist:
            best_key, best_dist = key, dist
    return best_key


def _nearest_extent(page_size: int, heads: int, head_dim: int, rows: int,
                    pages: int) -> Optional[str]:
    """The recorded key of this shape and ``rows`` whose table extent is
    nearest ``pages`` in log space (the smaller extent on a tie), or
    None."""
    best = None
    for key in _load_persisted():
        parsed = _parse_key(key)
        if (parsed is None or parsed[:4] != (page_size, heads, head_dim, rows)
                or parsed[4] is None):
            continue
        rank = (abs(math.log2(pages / parsed[4])), parsed[4])
        if best is None or rank < best[0]:
            best = (rank, key)
    return None if best is None else best[1]


def best_n_splits(page_size: int, heads: int, head_dim: int,
                  rows: Optional[int] = None,
                  pages: Optional[int] = None) -> int:
    """Recorded split count for a kernel shape, ``rows`` rows walking a
    ``pages``-page table (>= 1; callers normalize it to a divisor of their
    table extent)."""
    shape = (page_size, heads, head_dim)
    keys = [shape_key(*shape, rows, pages)]
    if pages is not None and rows is not None:
        keys.append(shape_key(*shape, rows))
    if rows is not None or pages is not None:
        keys.append(shape_key(*shape))
    for key in keys:
        if key in _memo:
            return max(1, _memo[key])
    look = shape + (rows, pages)
    if look not in _resolved:
        persisted = _load_persisted()
        order = keys[:1]
        if rows is not None and pages is not None:
            near = _nearest_extent(*shape, rows, pages)
            if near is not None:
                order.append(near)
        val = next((persisted[k] for k in order + keys[1:]
                    if k in persisted), None)
        if val is None and persisted:
            near = _nearest_key(*shape, rows, pages)
            if near is not None:
                val = persisted[near]
        _resolved[look] = 1 if val is None else int(val)
    return max(1, _resolved[look])


def record(page_size: int, heads: int, head_dim: int, n_splits: int,
           rows: Optional[int] = None, pages: Optional[int] = None) -> None:
    """Install a value for this process (tests pin the reference's)."""
    _memo[shape_key(page_size, heads, head_dim, rows, pages)] = int(n_splits)


def clear_memo() -> None:
    """Drop in-process state so the record is read again."""
    global _persisted
    _memo.clear()
    _resolved.clear()
    _persisted = None
