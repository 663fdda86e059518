"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
tolerance reports mirrored from tests/test_paged_attn.py, the JAX -> numpy
tree conversion that carries reference parameters into the port (bf16 as
a uint16 bit view), and the engine ``stats()`` comparison."""
import numpy as np


def tolerance_report(got, want) -> dict:
    """Elementwise comparison summary: exact flag, mismatch count, max
    absolute and relative deviation (f64 accumulation)."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    diff = np.abs(g - w)
    rel = diff / np.maximum(np.abs(w), 1e-12)
    return {
        "exact": bool(np.array_equal(g, w)),
        "mismatched": int(np.count_nonzero(g != w)),
        "total": int(g.size),
        "max_abs": float(diff.max(initial=0.0)),
        "max_rel": float(rel.max(initial=0.0)),
    }


def assert_bitwise(got, want, label: str = "") -> None:
    rep = tolerance_report(got, want)
    assert rep["exact"], f"{label} not bitwise: {rep}"


def to_numpy(tree):
    """JAX tree -> nested dicts/lists of numpy arrays; bf16 leaves become
    their uint16 bit view."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    a = np.asarray(tree)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def hold_stats(got: dict, want: dict) -> None:
    """A port engine's ``stats()`` against the reference engine's: the same
    keys apart from the twin's books, which the port adds as ``hw_*``, and
    every value that is not a wall-clock time (``*_s``) equal."""
    assert {k for k in got if not k.startswith("hw_")} == set(want)
    assert {k: got[k] for k in want if not k.endswith("_s")} == \
        {k: float(v) for k, v in want.items() if not k.endswith("_s")}
