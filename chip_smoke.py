#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (src/repro_torch).

Drives the port's serving and training paths on one NVIDIA GPU and fails
on any fault:

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — compiles the CUDA kernels from src/repro_torch/csrc (one nvcc
             per source, in parallel) and prints the build seconds.
3. K1      — the TimeFloats int8 block-MAC at every main-path shape
             (decode M=4, a 4-row prefill wave at every length bucket the
             drain admits, M in {32, 64, 128, 256}, and the training
             step's M = 4 x 256 = 1024; K in {1024, 2048, 3072}, N in
             {1024, 2048, 3072, 151936}), with and without the fixed 4-bit
             ADC: bitwise against its plain version; kernel, plain and
             library (dequantize + one f32 matmul) times and the bound of
             the unpadded function's bytes and int8 operations.
4. K2      — the transposed read dx = g @ W^T at the training step's
             M = 1024 and the (K, N) of every projection and the tied head:
             within N * 2^-24 * (|gd| @ |wd|^T) of its plain version
             elementwise (both sum the same exact products in f32, in
             different orders); kernel, plain and library (dequantize +
             one f32 matmul) times and the bound of the unpadded bytes and
             of 2*M*N*K flops at the bf16 tensor-core rate (the
             dequantized products are exact in bf16).
5. K3      — fused sampling on (4, 151936) logits with injected exact ties,
             greedy and temperature rows sharing one noise tensor: bitwise;
             its bound counts noise only for the temperature rows.
6. K6      — the page gather at the paged prefill shape, pool (129, 16, 8,
             128) bf16 and a (4, 32) table with trash entries, plus one
             pool whose page is not a multiple of 16 bytes: bitwise against
             its plain version (``pool[pt]``); kernel, plain and library
             (``pool[pt]``, one call) times and the bound of the pages'
             bytes read and written.
7. K4      — the split-K paged decode at the decode shape (4 rows, 16 query
             and 8 kv heads of 128, bf16 pools of 16-token pages), tables
             of 1, 8 and 32 pages with ragged lengths (0 included) and
             trash entries: within 1e-6 of the plain version at n_splits
             1, 2, 4 and 8 (bitwise expected: both sum in float64),
             bitwise neutral to a covering table
             prefix at one split; the n_splits that is fastest over the
             three caps, kernel, plain and library (two gathers and
             ``scaled_dot_product_attention`` with the length mask, three
             calls) times and the bound of the live K/V bytes.
8. serve   — qwen3-0.6b at full width (28 layers, random weights from
             --seed), TimeFloats ``mode="pallas"``, bf16 activations,
             Engine(slots=4, max_len=512), 8 requests (prompts of 5-60
             tokens, 8 new tokens each, one at temperature 0.8) drained
             with the kernels; launch counts must be > 0 and host transfers
             equal decode steps. The same requests are then drained with
             every kernel replaced by its plain version: the token streams
             must be identical and the launch counts must not move.
9. paged   — the same model, Engine(paged=True, slots=4, max_len=512,
             page_size=16), 8 greedy requests sharing a 48-token prefix
             (3 pages) with 5-60-token tails, 16 new tokens each, drained
             with the kernels and then with the plain versions. Gates:
             identical first tokens, at least 6 of 8 identical streams (the
             reference's own bar for split-K decode against a gather
             composition), radix hits, a conserved pool, all-trash tables
             after the drain, K4 and K6 launched only in the kernel drain,
             one host transfer per step. Information only: how many
             streams equal a dense engine's drain of the same requests.
10. train  — the same model and mode, remat="full", AdamW: run_loop for 3
             steps of batch 4 x 256 from DataPipeline(kind="lm"), with a
             final checkpoint in a temporary directory. Per step: loss,
             grad norm, wall and host CPU seconds, K1 and K2 launches
             (one K2 per dense call; K1 twice for a recomputed block's).
             Gates: step 0's gradients of the kernels against the plain
             versions per leaf (cosine and relative error), the same 3
             steps with the plain versions (step 0's loss bitwise, later
             losses within 1e-3), finite losses and norms, and the final
             checkpoint restoring bitwise.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root:
``python3 chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
SLOTS, MAX_LEN = 4, 512        # the main drain's engine
PROMPT_LENS = (5, 60)          # shortest and longest prompt of the drain
PAGE, PREFIX = 16, 48          # the paged drain's page size, shared prefix
# New tokens per dense request: 8 (16 before the paged phase came) keeps
# the smoke near its earlier length while every slot is still reused once.
DENSE_NEW = 8
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 256, 3   # the training phase
K2_COSINE = 0.99999            # step-0 grads, kernels vs plain, per leaf
K2_MAX_REL = 1e-2              # and max |diff| / max |plain| per leaf
LOSS_RTOL = 1e-3               # later steps' losses, kernels vs plain
# K4 against its plain version, |diff| / max(1, max |plain|). Expected
# bitwise: both accumulate every sum in float64 and round once to float32,
# so their different summation orders can differ only where a float64
# result sits at a float32 rounding tie; such an ulp moves the output by
# less than this.
K4_TOL = 1e-6
K4_SPLITS = (1, 2, 4, 8)
K4_CAPS = (1, 8, 32)           # table extents (pages) held and timed
PAGED_MIN_SAME = 6             # of 8 paged streams, kernels vs plain


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound(nbytes: float, ops: float, peak: float = INT8_OPS_PER_S
          ) -> tuple[float, str]:
    """Least time (ms) for the work at the card's memory rate and the
    operations' ``peak`` rate, and what bounds it."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                     else "operations")


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Device ms per call of ``fn``. A sleep kernel queued first gives the
    host a head start, so every call is enqueued before the device reaches
    it and host launch overhead is not counted (the small kernels here take
    less time on the device than their launch takes on the host). If the
    host still falls behind (``fn`` waits for the device, or is slow to
    enqueue), the time includes launch gaps, and a line says so."""
    for _ in range(warmup):
        fn()
    for cycles in (10**8, 10**9):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        ev[2].record()
        torch.cuda.synchronize()
        ms = ev[1].elapsed_time(ev[2]) / reps
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ms
    print(f"timing: the host fell behind ({host_ms:.1f} ms to enqueue); "
          f"{ms:.4f} ms includes launch gaps", flush=True)
    return ms


# (K, N) of the dense projections and the tied head of qwen3-0.6b, and how
# many K1 launches each takes per forward (28 layers; q, k, v, o, gate,
# up, down; then the head).
def k1_shapes(cfg):
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim, cfg.d_ff)
    per_layer = {(d, h * hd): 1, (d, hkv * hd): 2, (h * hd, d): 1,
                 (d, f): 2, (f, d): 1}
    shapes = {kn: c * cfg.n_layers for kn, c in per_layer.items()}
    shapes[(d, cfg.vocab_size)] = shapes.get((d, cfg.vocab_size), 0) + 1
    return shapes


def k1_rows(cfg) -> dict:
    """M of every K1 call the main paths make: a decode step has one row
    per slot, a prefill wave ``SLOTS`` rows of its prompts' length bucket
    (dense prompts, and paged prompts with their shared prefix; a radix
    hit's suffix falls in a dense prompt's bucket), a training step
    ``TRAIN_B * TRAIN_S``."""
    from repro_torch.serve.engine import bucket_for

    lo, hi = PROMPT_LENS
    buckets = sorted({bucket_for(n, MAX_LEN) for n in range(lo, hi + 1)}
                     | {bucket_for(n, MAX_LEN)
                        for n in range(PREFIX + lo, PREFIX + hi + 1)})
    return {"decode": SLOTS, **{f"prefill{b}": SLOTS * b for b in buckets},
            "train": TRAIN_B * TRAIN_S}


def train_launches(cfg) -> tuple[int, int]:
    """(K1, K2) launches of one training step: every dense call's forward
    is one K1 (a checkpointed block's twice: forward and recomputation),
    its dx one K2; the tied head is outside the blocks."""
    per_block = sum(k1_shapes(dataclasses.replace(cfg, n_layers=1)).values()
                    ) - 1
    blocks = per_block * cfg.n_layers
    return (2 if cfg.remat == "full" else 1) * blocks + 1, blocks + 1


def k1_traffic(c: int, m: int, n: int) -> tuple[float, float]:
    """(bytes, int8 operations) of one K1 call on the unpadded function:
    qx (C,M,64) int8 and sx (C,M) f32, qw (C,64,N) int8 and sw (C,N) f32
    read once, the (M,N) f32 output written once."""
    nbytes = c * m * 64 + c * m * 4 + c * 64 * n + c * n * 4 + m * n * 4
    return float(nbytes), 2.0 * m * c * 64 * n


def phase_k1(torch, cfg, seed: int) -> dict:
    from repro_torch.core import timefloats as tf
    from repro_torch.kernels import ops
    from repro_torch.kernels import timefloats_matmul as km

    gen = torch.Generator(device="cuda").manual_seed(seed)
    per_step = k1_shapes(cfg)
    rows = k1_rows(cfg)
    print(f"K1 rows held: {rows}", flush=True)
    cfgs = {adc: tf.TFConfig(mode="pallas", adc_bits=adc, adc_mode="fixed")
            for adc in (None, 4)}
    worst = 0.0
    tot = {path: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bytes": 0.0, "ops": 0.0} for path in ("decode", "train")}
    k1_train = train_launches(cfg)[0]
    remat = 2 if cfg.remat == "full" else 1
    for (k, n), count in per_step.items():
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        # The ADC acts after the MAC, so both configs quantize alike.
        qw = tf.quantize_weight(tf._pow2_prescale(w, cfgs[None])[0],
                                cfgs[None])
        for label, m in rows.items():
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            qx = tf.quantize_input(tf._pow2_prescale(x, cfgs[None])[0],
                                   cfgs[None])
            a = ops.padded_operands(qx, qw)
            for adc, cfg_tf in cfgs.items():
                got = km.timefloats_matmul_quantized(*a, cfg=cfg_tf)
                want = km.timefloats_matmul_plain(*a, cfg_tf)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                worst = max(worst, err)
                check(torch.equal(got, want),
                      f"K1 {label} M={m} K={k} N={n} adc={adc}: kernel != "
                      f"plain (max abs {err})")
            ms = time_ms(torch, lambda: km.timefloats_matmul_quantized(
                *a, cfg=cfgs[None]), reps=20)
            plain = time_ms(torch, lambda: km.timefloats_matmul_plain(
                *a, cfgs[None]), reps=3, warmup=1)
            lib = time_ms(torch, lambda: tf.dequantize_input(qx, k)
                          @ tf.dequantize_weight(qw, k), reps=10)
            nbytes, nops = k1_traffic(qx.q.shape[0], m, n)
            b_ms, b_by = bound(nbytes, nops)
            # A training step runs each checkpointed block's calls twice.
            c = count * (remat if label == "train" and n != cfg.vocab_size
                         else 1)
            print(f"K1 {label:9s} M={m:4d} K={k:4d} N={n:6d} bitwise=True "
                  f"(adc None and 4) ms={ms:.4f} plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"launches_per_step={c}", flush=True)
            if label in tot:
                t = tot[label]
                t["ms"] += c * ms
                t["plain_ms"] += c * plain
                t["library_ms"] += c * lib
                t["bytes"] += c * nbytes
                t["ops"] += c * nops
    recs = []
    for path, what, n_calls in (("decode", "one decode step",
                                 sum(per_step.values())),
                                ("train", "one training step", k1_train)):
        t = tot[path]
        b_ms, b_by = bound(t["bytes"], t["ops"])
        print(f"K1 per {what} ({n_calls} launches): ms={t['ms']:.4f} "
              f"plain_ms={t['plain_ms']:.4f} library_ms="
              f"{t['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})",
              flush=True)
        recs.append({"name": f"K1 timefloats_matmul ({what})",
                     "route": "cuda",
                     "source": "src/repro_torch/csrc/timefloats_matmul.cu",
                     "replaces": "src/repro/kernels/timefloats_matmul.py:47",
                     "max_abs_err": worst, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": t["library_ms"]})
    return recs


def k2_traffic(m: int, n: int, k: int) -> tuple[float, float]:
    """(bytes, flops) of one K2 call on the unpadded function: g's planes
    (M,N) int8 with (N/64, M) f32 scales and the weight's (K,N) int8 with
    (K/64, N) f32 scales read once, dx (M,K) f32 written once; 2*M*N*K
    flops."""
    d, c = math.ceil(n / 64), math.ceil(k / 64)
    nbytes = m * n + d * m * 4 + k * n + c * n * 4 + m * k * 4
    return float(nbytes), 2.0 * m * n * k


def k2_tolerance(km, *operands):
    """Elementwise bound on the gap between two f32 sums of the same exact
    products in any order, ``N * 2^-24 * (|gd| @ |wd|^T)``: the reference
    promises an f32 sum, not its order."""
    gd, wd = km.dequantize_transposed(*operands)
    return gd.shape[1] * 2.0 ** -24 * (gd.abs() @ wd.abs().T)


def phase_k2(torch, cfg, seed: int) -> dict:
    from repro_torch.core import timefloats as tf
    from repro_torch.kernels import ops
    from repro_torch.kernels import timefloats_matmul as km

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    cfg_tf = tf.TFConfig(mode="pallas")
    m = TRAIN_B * TRAIN_S
    worst_err, worst_share = 0.0, 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "ops": 0.0}
    for (k, n), count in k1_shapes(cfg).items():
        # The stored planes of a (K, N) weight, as the forward read them,
        # and a streamed gradient g (M, N) quantized along N.
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        qw = tf.quantize_weight(tf._pow2_prescale(w, cfg_tf)[0], cfg_tf)
        g = torch.randn(m, n, generator=gen, device="cuda") * 1e-3
        qg = tf.quantize_input(tf._pow2_prescale(g, cfg_tf)[0], cfg_tf)
        a = ops.padded_transposed_operands(qg, qw)
        got = km.timefloats_matmul_transposed_quantized(*a, cfg=cfg_tf)
        want = km.timefloats_matmul_transposed_plain(*a)
        tol = k2_tolerance(km, *a)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        share = (diff / tol.clamp_min(1e-38)).max().item()
        err = diff.max().item()
        worst_err, worst_share = max(worst_err, err), max(worst_share, share)
        check(bool((diff <= tol).all()) and bool(torch.isfinite(got).all()),
              f"K2 M={m} K={k} N={n}: kernel outside N*2^-24*(|gd|@|wd|^T)"
              f" of plain (max abs {err}, worst diff/tol {share})")
        ms = time_ms(torch, lambda: km.timefloats_matmul_transposed_quantized(
            *a, cfg=cfg_tf), reps=10)
        plain = time_ms(torch, lambda: km.timefloats_matmul_transposed_plain(
            *a), reps=5, warmup=1)
        lib = time_ms(torch, lambda: torch.matmul(
            tf.dequantize_input(qg, n), tf.dequantize_weight(qw, k).T),
            reps=5, warmup=1)
        nbytes, nops = k2_traffic(m, n, k)
        b_ms, b_by = bound(nbytes, nops, BF16_FLOPS_PER_S)
        print(f"K2 M={m} K={k:4d} N={n:6d} max_abs={err:.3e} "
              f"worst_diff/tol={share:.3e} ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.4f} launches_per_step={count}",
              flush=True)
        tot["ms"] += count * ms
        tot["plain_ms"] += count * plain
        tot["library_ms"] += count * lib
        tot["bytes"] += count * nbytes
        tot["ops"] += count * nops
    b_ms, b_by = bound(tot["bytes"], tot["ops"], BF16_FLOPS_PER_S)
    print(f"K2 per training step ({train_launches(cfg)[1]} launches): "
          f"ms={tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
          f"library_ms={tot['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by})",
          flush=True)
    return {"name": "K2 timefloats_matmul_transposed (one training step)",
            "route": "cuda",
            "source": "src/repro_torch/csrc/timefloats_matmul_transposed.cu",
            "replaces": "src/repro/kernels/timefloats_matmul.py:132",
            "max_abs_err": worst_err, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tot["library_ms"]}


def phase_k3(torch, cfg, seed: int) -> dict:
    from repro_torch.kernels import sampling as ks

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    s, v = 4, cfg.vocab_size
    lg = (torch.randn(s, v, generator=gen, device="cuda") * 4).round() / 4
    noise = (ks.gumbel_noise((s, v), gen, "cuda") * 2).round() / 2
    temps = torch.tensor([0.0, 0.8, 1.0, 0.0], device="cuda")
    # Exact ties at the top of every row, after scaling and noise.
    for r, (i, j) in enumerate([(900, 77), (150000, 4321), (12, 11), (5, 6)]):
        top = 80.0 if r == 1 else 100.0
        lg[r, i] = lg[r, j] = top
        noise[r, i] = noise[r, j] = 0.0
    lg[3, 20] = float("nan")  # a NaN row returns V, as the reference
    got = ks.sample(lg, noise, temps)
    want = ks.sample_plain(lg, noise, temps)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K3: kernel {got.tolist()} != plain "
          f"{want.tolist()}")
    check(got.tolist() == [77, 4321, 11, v], f"K3 tie/NaN rule: {got.tolist()}")
    ms = time_ms(torch, lambda: ks.sample(lg, noise, temps), reps=50)
    plain = time_ms(torch, lambda: ks.sample_plain(lg, noise, temps), reps=20)
    lib = time_ms(torch, lambda: torch.argmax(lg, dim=-1), reps=50)
    # lg is read once; noise only for the temperature rows (greedy rows
    # never touch it, in the kernel or in the function); temps in, tokens
    # out.
    hot = int((temps > 0).sum().item())
    b_ms, b_by = bound(lg.numel() * 4 + hot * v * 4 + s * 4 + s * 4, 0.0)
    greedy_ms, _ = bound(lg.numel() * 4 + s * 4 + s * 4, 0.0)
    print(f"K3 S={s} V={v} temperature_rows={hot} bitwise=True "
          f"tokens={got.tolist()} ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms(argmax)={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"bound_ms_all_greedy={greedy_ms:.4f} launches_per_decode_step=1",
          flush=True)
    return {"name": "K3 sampling", "route": "cuda",
            "source": "src/repro_torch/csrc/sampling.cu",
            "replaces": "src/repro/kernels/sampling.py:59",
            "max_abs_err": float((got - want).abs().max().item()),
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib}


def phase_k6(torch, cfg, seed: int) -> dict:
    from repro_torch.kernels import paged as kp

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    n_tab = MAX_LEN // PAGE
    p = SLOTS * n_tab + 1
    pool = torch.randn(p, PAGE, cfg.n_kv_heads, cfg.resolved_head_dim,
                       generator=gen, device="cuda").bfloat16()
    pt = torch.randint(1, p, (SLOTS, n_tab), generator=gen, device="cuda",
                       dtype=torch.int32)
    pt[0, 8:] = 0   # trash entries past a short row
    pt[3] = 0       # an idle row
    got = kp.gather_pages(pool, pt)
    want = kp.gather_pages_plain(pool, pt)
    # A pool whose pages are 12 bytes: the kernel's 4-byte copy unit.
    odd = torch.randn(7, 3, generator=gen, device="cuda")
    odd_pt = torch.tensor([[6, 0], [2, 2]], dtype=torch.int32, device="cuda")
    got_odd = kp.gather_pages(odd, odd_pt)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int16), want.view(torch.int16))
          and torch.equal(got_odd, kp.gather_pages_plain(odd, odd_pt)),
          "K6: kernel != plain")
    ms = time_ms(torch, lambda: kp.gather_pages(pool, pt), reps=50)
    plain = time_ms(torch, lambda: kp.gather_pages_plain(pool, pt), reps=50)
    lib = time_ms(torch, lambda: pool[pt], reps=50)
    page_bytes = pool[0].numel() * pool.element_size()
    nbytes = 2 * pt.numel() * page_bytes + pt.numel() * 4
    b_ms, b_by = bound(nbytes, 0.0)
    print(f"K6 pool={tuple(pool.shape)} bf16 pt={tuple(pt.shape)} "
          f"bitwise=True (and a 12-byte page) MiB_moved={nbytes / 2**20:.2f} "
          f"ms={ms:.4f} plain_ms={plain:.4f} library_ms(pool[pt])={lib:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.4f} "
          f"launches_per_prefill_wave={2 * cfg.n_layers}", flush=True)
    return {"name": "K6 gather_pages (one launch at the prefill shape)",
            "route": "cuda", "source": "src/repro_torch/csrc/paged_gather.cu",
            "replaces": "src/repro/kernels/paged.py:35", "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib}


def k4_case(torch, cfg, gen, n_tab: int):
    """Decode-shape operands with an ``n_tab``-page table: ragged lengths
    (an empty row, a full one, a single page, a random one) and trash
    entries past each row's extent."""
    p = SLOTS * (MAX_LEN // PAGE) + 1
    hkv, d = cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.randn(SLOTS, cfg.n_heads, d, generator=gen,
                    device="cuda").bfloat16()
    kpool = torch.randn(p, PAGE, hkv, d, generator=gen,
                        device="cuda").bfloat16()
    vpool = torch.randn(p, PAGE, hkv, d, generator=gen,
                        device="cuda").bfloat16()
    cap = n_tab * PAGE
    rnd = int(torch.randint(1, cap + 1, (1,), generator=gen,
                            device="cuda").item())
    lens = torch.tensor([0, cap, min(PAGE, cap), rnd], dtype=torch.int32,
                        device="cuda")
    ids = torch.randperm(p - 1, generator=gen, device="cuda")[:SLOTS * n_tab]
    pt = (ids + 1).to(torch.int32).reshape(SLOTS, n_tab)
    live = (lens.to(torch.int64) + PAGE - 1) // PAGE
    pt[torch.arange(n_tab, device="cuda")[None, :] >= live[:, None]] = 0
    return q, kpool, vpool, pt, lens


def phase_k4(torch, cfg, seed: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attn as kpa

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    hkv, d = cfg.n_kv_heads, cfg.resolved_head_dim
    times = {ns: 0.0 for ns in K4_SPLITS}
    worst, exact, rec = 0.0, True, None
    for n_tab in K4_CAPS:
        q, kpool, vpool, pt, lens = k4_case(torch, cfg, gen, n_tab)
        for ns in K4_SPLITS:
            got = kpa.paged_decode_attention(q, kpool, vpool, pt, lens,
                                             n_splits=ns)
            want = kpa._combine(*kpa._gqa_plain(
                q, kpool, vpool, pt, lens, scale=1.0 / math.sqrt(d),
                n_splits=kpa._norm_splits(ns, n_tab, page_size=PAGE,
                                          heads=cfg.n_heads, head_dim=d)))
            torch.cuda.synchronize()
            err = ((got - want).abs().max()
                   / want.abs().max().clamp_min(1.0)).item()
            worst = max(worst, err)
            exact = exact and torch.equal(got, want)
            check(err <= K4_TOL and bool(torch.isfinite(got).all())
                  and bool((got[lens == 0] == 0).all()),
                  f"K4 cap={n_tab} n_splits={ns}: max rel {err} > {K4_TOL}"
                  " or a length-0 row not exactly 0")
        # A covering prefix of the table is neutral (one split: the same
        # live positions in the same order).
        if n_tab == 32:
            short = lens.clamp_max(8 * PAGE)
            full = kpa.paged_decode_attention(q, kpool, vpool, pt, short,
                                              n_splits=1)
            capped = kpa.paged_decode_attention(q, kpool, vpool, pt[:, :8],
                                                short, n_splits=1)
            torch.cuda.synchronize()
            check(torch.equal(full, capped), "K4: an 8-page prefix of a "
                  "32-page table changes the output")
        row = []
        for ns in K4_SPLITS:
            t = time_ms(torch, lambda: kpa.paged_decode_attention(
                q, kpool, vpool, pt, lens, n_splits=ns), reps=50)
            times[ns] += t
            row.append(f"{ns}:{t:.4f}")
        print(f"K4 cap={n_tab:2d} pages lengths={lens.tolist()} ms by "
              f"n_splits {' '.join(row)}", flush=True)
        if n_tab == 8:  # the paged drain's usual cap (prompts up to 108)
            rec = (q, kpool, vpool, pt, lens)
    ns_best = min(K4_SPLITS, key=lambda n: times[n])
    print(f"K4 n_splits winner over caps {K4_CAPS}: {ns_best} (key "
          f"p{PAGE}_h{cfg.n_heads}_d{d}_r{SLOTS}); bitwise={exact} max "
          f"|diff|/max(1,|plain|) {worst:.3e} (tolerance {K4_TOL})",
          flush=True)

    q, kpool, vpool, pt, lens = rec
    ms = time_ms(torch, lambda: kpa.paged_decode_attention(
        q, kpool, vpool, pt, lens, n_splits=ns_best), reps=50)
    plain = time_ms(torch, lambda: kpa._combine(*kpa._gqa_plain(
        q, kpool, vpool, pt, lens, scale=1.0 / math.sqrt(d),
        n_splits=ns_best)),
        reps=10)
    s_len = pt.shape[1] * PAGE
    mask = (torch.arange(s_len, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        k = kpool[pt].reshape(SLOTS, s_len, hkv, d).transpose(1, 2)
        v = vpool[pt].reshape(SLOTS, s_len, hkv, d).transpose(1, 2)
        return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                              enable_gqa=True)

    lib = time_ms(torch, library, reps=50)
    live = int(lens.sum().item())
    nbytes = (live * hkv * 2 * d * kpool.element_size() + q.numel() * 2
              + SLOTS * cfg.n_heads * d * 4 + pt.numel() * 4 + SLOTS * 4)
    b_ms, b_by = bound(nbytes, 4.0 * live * cfg.n_heads * d,
                       BF16_FLOPS_PER_S)
    per = cfg.n_layers
    print(f"K4 cap=8 pages n_splits={ns_best} live_positions={live} "
          f"KiB_live={nbytes / 1024:.1f} ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms(2 gathers + sdpa, 3 calls)={lib:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by}) share_of_bound={b_ms / ms:.4f} "
          f"launches_per_decode_step={per}; per decode step ms="
          f"{per * ms:.4f} plain_ms={per * plain:.4f} "
          f"library_ms={per * lib:.4f} bound_ms={per * b_ms:.5f}",
          flush=True)
    return {"name": f"K4 paged_decode_attention (one decode step: {per} "
                    "launches, 8-page cap)",
            "route": "cuda", "source": "src/repro_torch/csrc/paged_attn_gqa.cu",
            "replaces": "src/repro/kernels/paged_attn.py:172",
            "max_abs_err": worst, "ms": per * ms, "plain_ms": per * plain,
            "bound_ms": per * b_ms, "bound_by": b_by,
            "library_ms": per * lib}


def _requests(cfg, seed: int):
    import numpy as np

    from repro_torch.serve.request import Request

    rng = np.random.default_rng(seed)
    lo, hi = PROMPT_LENS
    lens = rng.integers(lo, hi + 1, 8)
    lens[0], lens[1] = lo, hi
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=DENSE_NEW,
                    temperature=0.8 if i == 3 else 0.0)
            for i, n in enumerate(lens)]


def _drain(torch, params, cfg, seed: int):
    from repro_torch.serve.engine import Engine

    eng = Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN, seed=seed)
    for r in _requests(cfg, seed):
        eng.submit(r)
    torch.cuda.synchronize()
    t0, c0 = time.monotonic(), time.process_time()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    cpu = time.process_time() - c0   # this process's CPU seconds, all threads
    return eng, {f.uid: [int(t) for t in f.tokens] for f in done}, wall, cpu


def phase_serve(torch, cfg, seed: int, params) -> dict:
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import sampling as ks
    from repro_torch.kernels import timefloats_matmul as km
    from repro_torch.models import model

    km.timefloats_matmul_quantized.launches = 0
    ks.sample.launches = 0
    eng, streams, wall, cpu = _drain(torch, params, cfg, seed)
    k1, k3 = km.timefloats_matmul_quantized.launches, ks.sample.launches
    st = eng.stats()
    new = int(st["new_tokens"])
    print(f"serve: drained {int(st['finished'])} requests, {new} tokens in "
          f"{wall:.2f}s: tok/s={new / wall:.2f} "
          f"wall_ms_per_step={1e3 * wall / eng.steps:.1f} "
          f"host_cpu_ms_per_step={1e3 * cpu / eng.steps:.1f} "
          f"host_cpu_share={cpu / wall:.3f} "
          f"ttft_p50_s={st['ttft_p50_s']:.4f} "
          f"latency_p50_s={st['latency_p50_s']:.4f} steps={eng.steps} "
          f"host_transfers={eng.host_transfers} K1_launches={k1} "
          f"K3_launches={k3} peak_mem_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    check(sorted(streams) == list(range(8)), f"finished {sorted(streams)}")
    check(all(len(t) == DENSE_NEW for t in streams.values()),
          f"{DENSE_NEW} tokens each")
    check(all(0 <= t < cfg.vocab_size for s in streams.values() for t in s),
          "token ids in range")
    check(k1 > 0 and k3 > 0, f"kernel launches K1={k1} K3={k3}")
    check(eng.host_transfers == eng.steps,
          f"host_transfers {eng.host_transfers} != steps {eng.steps}")

    x = torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32, device="cuda")
    logits, _ = model.prefill(params, x, cfg, model.init_cache(cfg, 1, 8))
    check(logits.shape == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits finite")

    km.timefloats_matmul_quantized.launches = 0
    ks.sample.launches = 0
    with dispatch.override(kernels=False):
        _, ref_streams, ref_wall, _ = _drain(torch, params, cfg, seed)
    print(f"serve: reference drain (plain versions) in {ref_wall:.2f}s; "
          f"streams identical={ref_streams == streams}", flush=True)
    check(ref_streams == streams, "kernel and plain drains differ")
    check(km.timefloats_matmul_quantized.launches == 0
          and ks.sample.launches == 0, "reference drain launched a kernel")
    return {"K1": k1, "K3": k3}


def _paged_requests(cfg, seed: int):
    """8 greedy requests: a shared 48-token prefix (3 pages) plus tails of
    5-60 tokens, 16 new tokens each."""
    import numpy as np

    from repro_torch.serve.request import Request

    rng = np.random.default_rng(seed + 5)
    shared = rng.integers(0, cfg.vocab_size, PREFIX).astype(np.int32)
    lo, hi = PROMPT_LENS
    lens = rng.integers(lo, hi + 1, 8)
    lens[0], lens[1] = lo, hi
    return [Request(uid=i, prompt=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)]),
        max_new_tokens=16) for i, n in enumerate(lens)]


def _paged_drain(torch, params, cfg, seed: int, paged: bool = True):
    from repro_torch.serve.engine import Engine

    eng = Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN, seed=seed,
                 paged=paged, page_size=PAGE)
    for r in _paged_requests(cfg, seed):
        eng.submit(r)
    torch.cuda.synchronize()
    t0, c0 = time.monotonic(), time.process_time()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    cpu = time.process_time() - c0
    return eng, {f.uid: [int(t) for t in f.tokens] for f in done}, wall, cpu


def phase_paged_serve(torch, cfg, seed: int, params) -> dict:
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import paged as kp
    from repro_torch.kernels import paged_attn as kpa
    from repro_torch.kernels import sampling as ks
    from repro_torch.kernels import timefloats_matmul as km

    counters = {"K1": km.timefloats_matmul_quantized, "K3": ks.sample,
                "K4": kpa.paged_decode_attention, "K6": kp.gather_pages}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    reset()
    eng, streams, wall, cpu = _paged_drain(torch, params, cfg, seed)
    launches = {k: fn.launches for k, fn in counters.items()}
    st = eng.stats()
    new = int(st["new_tokens"])
    print(f"paged: drained {int(st['finished'])} requests, {new} tokens in "
          f"{wall:.2f}s: tok/s={new / wall:.2f} "
          f"wall_ms_per_step={1e3 * wall / eng.steps:.1f} "
          f"host_cpu_ms_per_step={1e3 * cpu / eng.steps:.1f} "
          f"host_cpu_share={cpu / wall:.3f} "
          f"ttft_p50_s={st['ttft_p50_s']:.4f} "
          f"latency_p50_s={st['latency_p50_s']:.4f} steps={eng.steps} "
          f"host_transfers={eng.host_transfers} launches={launches} "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)
    print("paged: " + " ".join(f"{k}={st[k]:g}" for k in (
        "radix_hits", "radix_hit_rate", "radix_nodes", "radix_evictions",
        "pool_pages_total", "pool_pages_in_use", "pool_pages_free")),
        flush=True)
    waves = launches["K6"] // (2 * cfg.n_layers)
    print(f"paged: K4 launches per decode step "
          f"{launches['K4'] / eng.steps:g}, K6 launches per prefill wave "
          f"{launches['K6'] / max(waves, 1):g} ({waves} waves)", flush=True)
    check(sorted(streams) == list(range(8)), f"paged: finished "
          f"{sorted(streams)}")
    check(all(len(t) == 16 for t in streams.values()), "paged: 16 tokens each")
    check(launches["K4"] > 0 and launches["K6"] > 0,
          f"paged: kernel launches {launches}")
    check(launches["K4"] == cfg.n_layers * eng.steps,
          f"paged: {launches['K4']} K4 launches in {eng.steps} steps")
    check(launches["K6"] == 2 * cfg.n_layers * waves, "paged: K6 launches "
          "are not 2 per layer per wave")
    check(eng.host_transfers == eng.steps,
          f"paged: host_transfers {eng.host_transfers} != steps {eng.steps}")
    check(st["radix_hit_rate"] > 0, "paged: no radix hit")
    check(eng.pool.conserved(), "paged: pool not conserved")
    check(not bool(eng.state.cache.layers[0].pt.any()),
          "paged: page tables not all-trash after the drain")

    reset()
    with dispatch.override(kernels=False):
        ref_eng, ref, ref_wall, _ = _paged_drain(torch, params, cfg, seed)
    plain_launches = {k: fn.launches for k, fn in counters.items()}
    same = sorted(u for u in streams if streams[u] == ref[u])
    firsts = all(streams[u][0] == ref[u][0] for u in streams)
    print(f"paged: reference drain (plain versions) in {ref_wall:.2f}s; "
          f"identical streams {len(same)}/8 (gate >= {PAGED_MIN_SAME}); "
          f"identical first tokens {firsts}", flush=True)
    for u in sorted(set(streams) - set(same)):
        step = next(i for i, (a, b) in enumerate(zip(streams[u], ref[u]))
                    if a != b)
        print(f"paged: uid {u} first differs at token {step}", flush=True)
    check(firsts, "paged: first tokens differ between kernels and plain")
    check(len(same) >= PAGED_MIN_SAME, f"paged: only {len(same)}/8 streams "
          "identical")
    check(all(v == 0 for v in plain_launches.values()),
          f"paged: the plain drain launched {plain_launches}")
    check(ref_eng.pool.conserved(), "paged: plain drain's pool")

    _, dense, _, _ = _paged_drain(torch, params, cfg, seed, paged=False)
    print(f"paged: information only: {sum(dense[u] == streams[u] for u in streams)}"
          "/8 streams equal a dense engine's drain of the same requests",
          flush=True)
    reset()
    return launches


def phase_train(torch, cfg, seed: int) -> dict:
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import sampling as ks
    from repro_torch.kernels import timefloats_matmul as km
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train import step as tsl
    from repro_torch.train.trainer import LoopConfig, run_loop

    k1w, k2w = km.timefloats_matmul_quantized, \
        km.timefloats_matmul_transposed_quantized
    tcfg = tsl.TrainConfig(optimizer=OptimizerConfig(
        name="adamw", lr=3e-4, warmup=1, total_steps=TRAIN_STEPS))
    t0 = time.monotonic()
    state0 = tsl.init_state(cfg, tcfg, seed, "cuda")
    pipe = DataPipeline(cfg, TRAIN_B, TRAIN_S, seed=seed, kind="lm",
                        device="cuda")
    step_fn = tsl.make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    print(f"train: init {cfg.name} (remat={cfg.remat}, AdamW, batch "
          f"{TRAIN_B} x {TRAIN_S}) in {time.monotonic() - t0:.1f}s",
          flush=True)

    # Step 0's gradients, kernels against plain versions (not counted).
    batch0 = pipe.batch_at(0)
    m_k, g_k = tsl.loss_and_grads(cfg, state0.params, batch0)
    with dispatch.override(kernels=False):
        m_p, g_p = tsl.loss_and_grads(cfg, state0.params, batch0)
    cos_min, rel_max = 1.0, 0.0
    for (path, a), b in zip(tree_lib.leaves_with_path(g_k),
                            tree_lib.leaves(g_p)):
        a64, b64 = a.double().flatten(), b.double().flatten()
        cos = float(a64 @ b64 / (a64.norm() * b64.norm()).clamp_min(1e-300))
        rel = float((a64 - b64).abs().max() / b64.abs().max().clamp_min(
            1e-300))
        cos_min, rel_max = min(cos_min, cos), max(rel_max, rel)
        check(cos >= K2_COSINE and rel <= K2_MAX_REL,
              f"train: step-0 grad {tree_lib.path_str(path)} kernels vs "
              f"plain: cosine {cos}, max rel {rel}")
    check(torch.equal(m_k["loss"], m_p["loss"]),
          f"train: step-0 loss {m_k['loss'].item()} != plain "
          f"{m_p['loss'].item()}")
    print(f"train: step-0 grads kernels vs plain: min cosine {cos_min:.9f} "
          f"(gate {K2_COSINE}), max |diff|/max|plain| {rel_max:.3e} (gate "
          f"{K2_MAX_REL}); loss bitwise {m_k['loss'].item():.6f}",
          flush=True)
    del g_k, g_p

    per_step = []

    def on_metrics(step, m):
        per_step.append(dict(m, k1=k1w.launches, k2=k2w.launches,
                             cpu=time.process_time()))

    with tempfile.TemporaryDirectory() as ckpt:
        loop = LoopConfig(total_steps=TRAIN_STEPS, log_every=1,
                          ckpt_every=10**9, ckpt_dir=ckpt)
        k1w.launches = k2w.launches = ks.sample.launches = 0
        cpu0 = time.process_time()
        t0 = time.monotonic()
        final, report = run_loop(state0, step_fn, pipe.batch_at, loop,
                                 on_metrics=on_metrics)
        wall = time.monotonic() - t0
        launches = {"K1": k1w.launches, "K2": k2w.launches,
                    "K3": ks.sample.launches}
        prev = {"k1": 0, "k2": 0, "cpu": cpu0}
        for i, m in enumerate(per_step):
            print(f"train: step {i} loss {m['loss']:.6f} grad_norm "
                  f"{m['grad_norm']:.6f} wall_s {m['step_s']:.3f} "
                  f"host_cpu_s {m['cpu'] - prev['cpu']:.3f} K1_launches "
                  f"{m['k1'] - prev['k1']} K2_launches {m['k2'] - prev['k2']}",
                  flush=True)
            prev = m
        print(f"train: {TRAIN_STEPS} steps + final checkpoint in "
              f"{wall:.2f}s; launches {launches}; peak_mem_GB="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
        mgr = CheckpointManager(ckpt)
        check(mgr.latest_step() == TRAIN_STEPS,
              f"train: checkpoints {mgr.all_steps()}")
        t0 = time.monotonic()
        back = mgr.restore(TRAIN_STEPS, final)
        same = back.step == final.step and all(
            torch.equal(a, b) for a, b in zip(
                tree_lib.leaves((final.params, final.opt)),
                tree_lib.leaves((back.params, back.opt))))
        print(f"train: restored step {back.step} bitwise={same} in "
              f"{time.monotonic() - t0:.1f}s", flush=True)
        check(same, "train: the final checkpoint does not restore bitwise")
        del back
    k1_step, k2_step = train_launches(cfg)
    check(launches == {"K1": TRAIN_STEPS * k1_step,
                       "K2": TRAIN_STEPS * k2_step, "K3": 0},
          f"train: launches {launches}, expected {k1_step} K1 and "
          f"{k2_step} K2 per step")
    check(all(math.isfinite(m[k]) for m in per_step
              for k in ("loss", "grad_norm")), "train: non-finite metrics")

    k1w.launches = k2w.launches = 0
    with dispatch.override(kernels=False):
        _, ref = run_loop(state0, step_fn, pipe.batch_at, LoopConfig(
            total_steps=TRAIN_STEPS, log_every=1))
    print(f"train: plain versions' losses {ref.losses}; kernels' "
          f"{report.losses}", flush=True)
    check(k1w.launches == 0 and k2w.launches == 0,
          "train: the plain run launched a kernel")
    check(report.losses[0] == ref.losses[0],
          f"train: step-0 loss {report.losses[0]} != plain {ref.losses[0]}")
    for i, (a, b) in enumerate(zip(report.losses, ref.losses)):
        check(abs(a - b) <= LOSS_RTOL * abs(b),
              f"train: step {i} loss {a} vs plain {b}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    t_start = time.monotonic()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.timefloats import TFConfig
    from repro_torch.kernels import _build
    from repro_torch.models import model

    # The plain K1 takes each chunk's integer dot as an f32 matmul, exact
    # only without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; host cores {len(os.sched_getaffinity(0))}",
          flush=True)

    secs = _build.build(_build.SOURCES)
    for name in _build.SOURCES:
        _build.load(name)
    print(f"build: K1, K2, K3, K4 and K6 built from src/repro_torch/csrc "
          f"in {secs:.1f}s", flush=True)

    cfg = get_config("qwen3-0.6b", tf=TFConfig(mode="pallas"))
    try:
        k1_serve, k1_train = phase_k1(torch, cfg, args.seed)
        k2 = phase_k2(torch, cfg, args.seed)
        k3 = phase_k3(torch, cfg, args.seed)
        k6 = phase_k6(torch, cfg, args.seed)
        k4 = phase_k4(torch, cfg, args.seed)
        t0 = time.monotonic()
        params = model.init(cfg, args.seed, device="cuda")
        torch.cuda.synchronize()
        print(f"serve: init {cfg.name} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab_size}) in "
              f"{time.monotonic() - t0:.1f}s", flush=True)
        serve = phase_serve(torch, cfg, args.seed, params)
        paged = phase_paged_serve(torch, cfg, args.seed, params)
        del params
        train = phase_train(torch, cfg, args.seed)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    k1_serve["launches"], k3["launches"] = serve["K1"], serve["K3"]
    k1_train["launches"], k2["launches"] = train["K1"], train["K2"]
    k4["launches"], k6["launches"] = paged["K4"], paged["K6"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"total: {time.monotonic() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in (
        k1_serve, k1_train, k2, k3, k4, k6)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
