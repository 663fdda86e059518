"""Where a K4 block spends its time: clock64() at each phase boundary.

Builds ``csrc/paged_attn_gqa.cu`` a second time with ``-DK4_PHASE_CLOCKS``
(thread 0 of every block records ``clock64()`` as it enters each phase;
the build the port uses has none of it) into
``build/repro_torch/paged_attn_gqa_clocks-<hash>.so``, launches it at the
qwen3-0.6b decode shape (4 rows, 16 query and 8 kv heads of 128, bf16
pools of 16-token pages, every row at the table's full length) for
tables of 1, 8 and 32 pages at 1 and 8 splits, checks each output against
the plain version, and prints the mean and the largest SM cycles per
block spent in each phase:

- ``load``: lengths, page ids and q, one round trip to device memory;
- ``issue``: issuing the copies of the first ring's pages;
- ``pass1``: waiting for the K rows and the scores;
- ``softmax``: max, p and l, and (m, l) stored into the owners' inboxes;
- ``pass2``: p @ V and acc stored into the owners' inboxes;
- ``combine``: the cluster barrier and the reduction over the splits.

Clocks are per SM and not synchronized across SMs, so only differences
within a block are printed. The records cost a few instructions per
phase. Run from the repository root on a machine with an NVIDIA GPU:
``PYTHONPATH=src python3 -m repro_torch.launch.profile_k4``.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import paged_attn as kpa

PHASES = ("load", "issue", "pass1", "softmax", "pass2", "combine")
CLOCK_BLOCKS = 4096   # kClockBlocks in the .cu
ROWS, HEADS, KV_HEADS, HEAD_DIM, PAGE = 4, 16, 8, 128, 16


def build(name: str = "paged_attn_gqa",
          flag: str = "-DK4_PHASE_CLOCKS") -> ctypes.CDLL:
    """``csrc/<name>.cu`` built a second time with ``flag`` into
    ``build/repro_torch/<name>_clocks-<hash>.so``, its entry points typed
    from ``_build.SIGNATURES`` and ``<name>_clocks`` beside them."""
    src = _build.CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"{name}_clocks-{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, flag, "-o",
                        str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    for entry, argtypes in _build.SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
    clocks = getattr(lib, f"{name}_clocks")
    clocks.restype, clocks.argtypes = ctypes.c_int, [ctypes.c_void_p]
    return lib


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def phase_cycles(lib: ctypes.CDLL, name: str, blocks: int) -> str:
    """The last launch's mean and largest SM cycles per block in each of
    PHASES and in all, over its first ``blocks`` blocks."""
    clocks = np.zeros((CLOCK_BLOCKS, 8), np.int64)
    _build.check(getattr(lib, f"{name}_clocks")(clocks.ctypes.data),
                 f"{name}_clocks")
    d = np.diff(clocks[:blocks, :7], axis=1)
    total = clocks[:blocks, 6] - clocks[:blocks, 0]
    cells = " ".join(f"{ph}={d[:, i].mean():.0f}/{d[:, i].max()}"
                     for i, ph in enumerate(PHASES))
    return f"{cells} total={total.mean():.0f}/{total.max()}"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_k4: needs a CUDA device", file=sys.stderr)
        return 1
    print(f"device: {device_line()}", flush=True)
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_pages = ROWS * 32 + 1
    q = torch.randn(ROWS, HEADS, HEAD_DIM, generator=gen,
                    device="cuda").bfloat16()
    kpool, vpool = (torch.randn(n_pages, PAGE, KV_HEADS, HEAD_DIM,
                                generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
    scale = 1.0 / math.sqrt(HEAD_DIM)
    g = HEADS // KV_HEADS
    for cap in (1, 8, 32):
        lens = torch.full((ROWS,), cap * PAGE, dtype=torch.int32,
                          device="cuda")
        ids = torch.randperm(n_pages - 1, generator=gen, device="cuda")
        pt = (ids[:ROWS * cap] + 1).to(torch.int32).reshape(ROWS, cap)
        for ns in sorted({1, min(8, cap)}):
            ts = cap // ns
            plan = kpa.k4_plan(g, HEAD_DIM, HEAD_DIM, PAGE, ts, ns, 2)
            out = torch.empty(ROWS, HEADS, HEAD_DIM, device="cuda")
            args = (q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                    pt.data_ptr(), lens.data_ptr(), out.data_ptr(), ROWS,
                    HEADS, KV_HEADS, HEAD_DIM, HEAD_DIM, n_pages, PAGE, ts,
                    plan.cluster, plan.ring, pt.stride(0), scale, 1, 1,
                    plan.smem, _build.stream_ptr())
            for _ in range(3):   # the last launch's clocks are read
                _build.check(lib.paged_attn_gqa(*args), "paged_attn_gqa")
            torch.cuda.synchronize()
            want = kpa._combine(*kpa._gqa_plain(q, kpool, vpool, pt, lens,
                                                scale=scale, n_splits=ns))
            if not torch.equal(out, want):
                print(f"profile_k4: cap={cap} n_splits={ns}: the "
                      "instrumented kernel differs from the plain version",
                      file=sys.stderr)
                return 1
            blocks = ROWS * KV_HEADS * ns
            print(f"K4 cap={cap:2d} pages n_splits={ns} ring={plan.ring} "
                  f"blocks={blocks} cycles per phase (mean/max): "
                  f"{phase_cycles(lib, 'paged_attn_gqa', blocks)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
