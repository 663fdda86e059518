"""Where a K5 block spends its time: clock64() at each phase boundary.

Builds ``csrc/paged_attn_mla.cu`` a second time with ``-DK5_PHASE_CLOCKS``
(thread 0 of every block records ``clock64()`` as it enters each phase;
the build the port uses has none of it) into
``build/repro_torch/paged_attn_mla_clocks-<hash>.so``, launches it at
deepseek-v3's decode shape (4 rows, 128 heads, latent 512 + rope 64, bf16
pools of 16-token pages, every row at the table's full length) for tables
of 1, 8 and 32 pages at 1 and 8 splits, checks each output against the
plain version (within 1e-6 of max(1, |plain|), bitwise reported), and
prints the mean and the largest SM cycles per block spent in each phase:

- ``load``: the loads of lengths, page ids and q issued, the page ids
  stored (one round trip to device memory);
- ``issue``: issuing the copies of the first ring's pages, then q converted
  to double once its loads have landed;
- ``pass1``: waiting for the rows and the scores;
- ``softmax``: max, p and l, and (m, l) stored into the owners' inboxes;
- ``pass2``: p @ c_kv and acc stored into the owners' inboxes;
- ``combine``: the cluster barrier and the reduction over the splits.

The build and the readout are ``profile_k4``'s. Clocks are per SM and not
synchronized across SMs, so only differences within a block are printed.
Run from the repository root on a machine with an NVIDIA GPU:
``PYTHONPATH=src python3 -m repro_torch.launch.profile_k5``.
"""
from __future__ import annotations

import math
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import paged_attn as kpa
from repro_torch.launch.profile_k4 import build, device_line, phase_cycles

NAME = "paged_attn_mla"
ROWS, HEADS, LATENT, ROPE, PAGE = 4, 128, 512, 64, 16
SCALE = 1.0 / math.sqrt(128 + ROPE)   # deepseek-v3: nope 128 + rope 64
TOL = 1e-6


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_k5: needs a CUDA device", file=sys.stderr)
        return 1
    print(f"device: {device_line()}", flush=True)
    lib = build(NAME, "-DK5_PHASE_CLOCKS")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_pages = ROWS * 32 + 1
    q_lat = torch.randn(ROWS, HEADS, LATENT, generator=gen,
                        device="cuda") * 0.05
    q_rope = torch.randn(ROWS, HEADS, ROPE, generator=gen,
                         device="cuda").bfloat16()
    cpool = torch.randn(n_pages, PAGE, LATENT, generator=gen,
                        device="cuda").bfloat16()
    rpool = torch.randn(n_pages, PAGE, ROPE, generator=gen,
                        device="cuda").bfloat16()
    for cap in (1, 8, 32):
        lens = torch.full((ROWS,), cap * PAGE, dtype=torch.int32,
                          device="cuda")
        ids = torch.randperm(n_pages - 1, generator=gen, device="cuda")
        pt = (ids[:ROWS * cap] + 1).to(torch.int32).reshape(ROWS, cap)
        for ns in sorted({1, min(8, cap)}):
            ts = cap // ns
            plan = kpa.k5_plan(HEADS, LATENT, ROPE, PAGE, ts, ns, 2)
            out = torch.empty(ROWS, HEADS, LATENT, device="cuda")
            args = (q_lat.data_ptr(), q_rope.data_ptr(), cpool.data_ptr(),
                    rpool.data_ptr(), pt.data_ptr(), lens.data_ptr(),
                    out.data_ptr(), ROWS, HEADS, plan.heads_per_block,
                    LATENT, ROPE, n_pages, PAGE, ts, plan.cluster, plan.ring,
                    pt.stride(0), q_lat.stride(0), q_lat.stride(1),
                    q_rope.stride(0), q_rope.stride(1), SCALE, 1, 0, 1,
                    plan.smem, _build.stream_ptr())
            for _ in range(3):   # the last launch's clocks are read
                _build.check(lib.paged_attn_mla(*args), NAME)
            torch.cuda.synchronize()
            want = kpa._combine(*kpa._mla_plain(
                q_lat, q_rope, cpool, rpool, pt, lens, scale=SCALE,
                n_splits=ns))
            err = ((out - want).abs().max()
                   / want.abs().max().clamp_min(1.0)).item()
            if not err <= TOL:
                print(f"profile_k5: cap={cap} n_splits={ns}: the "
                      f"instrumented kernel is {err} off the plain version",
                      file=sys.stderr)
                return 1
            blocks = ROWS * -(-HEADS // plan.heads_per_block) * ns
            print(f"K5 cap={cap:2d} pages n_splits={ns} heads_per_block="
                  f"{plan.heads_per_block} ring={plan.ring} blocks={blocks} "
                  f"bitwise={torch.equal(out, want)} cycles per phase "
                  f"(mean/max): {phase_cycles(lib, NAME, blocks)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
