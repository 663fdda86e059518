#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (src/repro_torch).

Drives the port's serving and training paths on one NVIDIA GPU and fails
on any fault:

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — compiles the CUDA kernels from src/repro_torch/csrc (one nvcc
             per source, in parallel) and prints the build seconds.
3. K1      — the TimeFloats int8 block-MAC at every main-path shape
             (decode M=4, a 4-row prefill wave at every length bucket the
             drain admits, M in {32, 64, 128, 256, 512}, and the training
             step's M = 4 x 256 = 1024; K in {1024, 2048, 3072}, N in
             {1024, 2048, 3072, 151936}), the (K, N) of every dense call of
             the deepseek-v3 training cut at M = 1024 (wq_a, wq_b, wkv_a,
             wkv_b, wo, gate/up, down, the untied head: K 512-18432, N
             576-129280), two ragged (M, K, N), and scales
             past the fused arithmetic's exactness argument, with and
             without the fixed 4-bit ADC: bitwise against its plain
             version and on two calls, at the wrapper's plan and (decode,
             training, ragged) at the other tiles and split counts;
             kernel, ADC, plain and library (dequantize + one f32 matmul)
             times, the bound of the unpadded function's bytes and int8
             operations, and the sweep over plans.
4. K2      — the transposed read dx = g @ W^T at the training step's
             M = 1024 and the (K, N) of every projection and the tied head,
             of every dense call of the deepseek-v3 training cut, plus a
             ragged (M, K, N) = (1000, 1000, 3000): within
             N * 2^-24 * (|gd| @ |wd|^T) of its plain version elementwise
             (both sum the same exact products in f32, in different
             orders; the worst diff/tol is printed) at the wrapper's split
             count and at 1-4 splits, bitwise equal on two calls; the sweep
             over splits; kernel, plain and library (dequantize + one f32
             matmul) times and the bound of the unpadded bytes and of
             2*M*N*K flops at the bf16 tensor-core rate (the dequantized
             products are exact in bf16); information only, the time of a
             bf16 dequantize + bf16 matmul.
5. K3      — fused sampling on (4, 151936) logits with injected exact ties,
             greedy and temperature rows sharing one noise tensor: bitwise;
             then at (4, 151936), (4, 129280), (1, 151936), (3, 151937) and
             (4, 301), at 4, 8 and 16 blocks per row, bitwise on mixed
             greedy and temperature rows, on exact ties straddling every
             slice boundary of each cluster size, and on a tie between
             index 0 and V-1, an all -inf row and a NaN row; the sweep over
             blocks per row at both vocabularies beside ``torch.argmax``
             and the cluster size the wrapper picked (the largest of 16, 8
             and 4 the card can place); its bound counts noise only for
             the temperature rows.
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
             1, 2, 4 and 8 (bitwise expected: both sum in float64), and
             at the CPU tests' small shapes (f32 pools, MQA G = 4, head
             dims 8-32, rows that are not 16-byte multiples); two calls
             bitwise equal; bitwise neutral to a covering table prefix
             at one split; one device launch per call, as
             ``torch.profiler`` counts it; the n_splits that is fastest
             over the three caps, kernel, plain and library (two gathers
             and ``scaled_dot_product_attention`` with the length mask,
             three calls) times at every cap and the bound of the live
             K/V bytes. Then the chain verify's row pattern (SPEC_K = 4:
             4 slots x 5 = 20 rows, each slot's table repeated 5 times,
             lengths n0+1 .. n0+5 clamped to the table's extent): within
             1e-6 at every cap and split (bitwise reported), two calls
             equal, one launch a call, at tables of 1, 2, 4, 8, 16 and 32
             pages (every cap a 512-token engine picks); the n_splits sweep
             at each cap and summed over the caps (the ``_r20`` record), at
             every cap the split count the lookup picks beside the library
             call, and at the 8-page cap the kernel, plain, library and
             bound times (each slot's live pages counted once).
Every serving drain replays captured CUDA graphs, the engine's default
on the card (one per prefill bucket, chunk wave and decode or verify cap),
unless it is named eager. The serve phase's engines keep the engine's
default smallest prefill bucket (8), so its drains capture and replay
prefill[8] to prefill[64]; the other serving phases' engines take
``min_bucket=64`` (MIN_BUCKET), so each of their drains captures one or two
prefill graphs. Each serving phase's kernel drain is held
against an eager drain of the same engine configuration (identical
streams, equal launches of every kernel, one host transfer a step), and
the same requests drained again through the graph engine must capture
nothing new (on a paged engine, whose radix tree then shortens the
suffixes, a second drain may add a prefill bucket and a third nothing);
each prints its graphs, their capture seconds and the peak device memory.
A kernel drain's logits (for the near-tie reports) and its launches by
row count are read on its eager twin, whose streams and launches are
gated equal; the comparison drains (plain versions, gather composition,
dense engine, quant=none, unchunked, spec off) replay graphs, and the
logit tap reads each captured step's top logits after every replay.

7a. hw    — the hardware twin and the paper's exact mode. (a) The paper's
             edge MLP (configs/timefloats_mlp.py: 64 -> 128 -> 128 -> 10,
             batch 128, ``mode="exact"``) through the port's
             ``timefloats.linear``: the forward and a backward from a
             fixed cotangent on the card bitwise equal to the same
             functions on the CPU (every layer's output, dx and dW), then
             in-situ SGD steps with stochastic rounding on the card's
             generator (the examples' ``insitu`` arm), gated on a falling
             held-out loss. (b) The op census recorded during that card
             forward (equal to the meta-device census), expanded with the
             structural backward and scheduled on the MLP's placement: the
             projected hardware TOPS/W within 1 % of the paper's 22.1,
             printed with the step's energy, cell writes and latency bound.
             (c) The full-width placements (tiles, macros, utilization) and
             per-token forward pJ of qwen3-0.6b, deepseek-v3-671b and
             kimi-k2-1t-a32b, shape-only. The serving and training phases
             below keep the twin's energy books on (the engines' default):
             the serve and paged drains gate per-request energy as
             conserved (requests + idle = total, the prefix credit outside
             it) and the wear book's read chunks as the executed tokens
             times the per-token census; the serve phase also drains with
             ``sched="cost"`` (every request finishes, every admission the
             head of the scheduler's cost order, the first one its
             host-side recomputation); the train phase books an
             ``HwMonitor`` on its graph and eager drains (equal books, the
             per-tile conservation invariant). Each phase line prints the
             host seconds its censuses took.
8. serve   — qwen3-0.6b at full width (28 layers, random weights from
             --seed), TimeFloats ``mode="pallas"``, bf16 activations,
             Engine(slots=4, max_len=512), 8 requests (prompts of 5-60
             tokens, 8 new tokens each, one at temperature 0.8) drained
             with the kernels; launch counts must be > 0 and host transfers
             equal decode steps; the warm drain's streams must be the
             first's. The same requests are then drained with every kernel
             replaced by its plain version: the token streams must be
             identical and the launch counts must not move. The cold graph
             drain runs traced (``obs.trace.Tracer``), with the engine's
             metrics registry, a ``HealthMonitor`` and
             ``default_serve_slos()``; its trace and metrics are written
             (``.json``) to a temporary directory, where
             ``validate_trace`` (the serving phases present, nothing
             dropped, the pJ folds equal to ``hw_telemetry()`` exactly),
             ``validate_health`` and the in-process ``obs_report
             --validate`` must accept them, and the trace must hold one
             ``host_transfer`` span a host transfer, one decode span a
             decode launch and one ``compile[...]`` span a captured graph
             (again after the warm drain, also traced: a replay emits no
             compile span). Prints each span kind's count and host
             seconds, and the warm drain's wall per step traced and, on
             one more warm drain, untraced (information only).
9. paged   — the same model, Engine(paged=True, slots=4, max_len=512,
             page_size=16), 8 greedy requests sharing a 48-token prefix
             (3 pages) with 5-60-token tails, 16 new tokens each, drained
             with the kernels and then with the plain versions. Gates:
             identical first tokens, at least 6 of 8 identical streams,
             radix hits, a conserved pool, all-trash tables after the
             drain, K4 and K6 launched only in the kernel drain, one host
             transfer per step. Then the same requests through the gather
             composition (fused_decode=False), a dense engine, and fused
             and gather drains without TimeFloats (quant="none"); for each
             pair, every stream that differs is reported with its first
             differing token and each drain's lead of its own pick in bf16
             ulps of its top logit. Gates: the gather composition equal to
             the dense engine on 8 of 8 streams (the reference pins them
             bitwise); every fused-vs-gather divergence a near-tie flip
             (after the first token, within each other's top 8, leads <=
             64 ulps). Last, an eviction case through the model's first 7
             layers: a 16-page pool, 8 new tokens each, kernels against
             plain versions (evictions, a conserved pool, all-trash tables,
             >= 6 of 8 identical streams and identical first tokens). The
             kernel drain and the eviction case's drain run traced, with
             the serve phase's trace gates, ``radix.match`` and
             ``radix.insert`` spans, and one ``pool.evict`` instant's pages
             for each eviction ``stats()`` counts.
10. chunked — the same model through its first 14 of 28 layers,
             Engine(chunk_tokens=64), dense (slots=4,
             max_len=512) and paged (page_size=16, the paged phase's 48-token
             shared prefix before every prompt): 8 greedy requests, 4 of
             150-400 tokens and 4 of 5-60, 8 new tokens each, against the
             same engine unchunked (kernels in both), each mode's graph
             drain against its eager twin. Gates: chunk waves,
             every long prompt's chunk log tiling it in order, one host
             transfer per step, every divergence from the unchunked streams
             a near-tie flip (the first token included); paged: radix hits,
             a conserved pool, all-trash tables and K6 launched twice per
             layer on every chunk wave.
11. spec   — the same model through its first 14 of 28 layers, a paged
             engine with SpecConfig(k=4) against the same engine without,
             on 8 greedy motif-tiled prompts (tests/test_spec.py's) of 16
             new tokens: once with the ngram
             draft, once with a replay of the spec-off stream as the draft
             (random weights never repeat themselves, so the ngram draft has
             nothing to be accepted). Gates for both: K4 launched at 20 rows
             on every layer of every step, K3 at 20 rows, scratch pages
             released and the pool conserved, all-trash tables, every
             divergence from the spec-off streams a near-tie flip (the logit
             tap maps a verify column to the token index it emits); for the
             replay, drafts accepted. The ngram graph drain runs traced,
             with the serve phase's trace gates: its verify spans'
             accepted and rejected pJ fold to the twin's speculative split
             exactly. Prints steps, tokens per step, tok/s
             and TTFT of each beside the card's name and power limit. Then a
             dense self-draft drain (draft="model", the target its own
             draft, 4 requests of 16 tokens), with graphs and eagerly:
             acceptance >= 0.9 in both, and the graph drain against the
             eager one.
12. K5     — the split-K absorbed-MLA paged decode at deepseek-v3's decode
             shape (4 rows, 128 heads, latent 512 + rope 64, bf16 pools of
             16-token pages), tables of 1, 8 and 32 pages with ragged
             lengths (0 included) and trash entries: within 1e-6 of the
             plain version at n_splits 1, 2, 4 and 8 (bitwise expected:
             both sum in float64), and at the CPU tests' small shapes (H =
             1, f32 pools, latents down to 8), one whose rope rows are not
             16-byte multiples, one whose H = 20 is not a multiple of the
             16 heads a block and one with an odd latent width; two calls
             bitwise equal; bitwise
             neutral to a covering table prefix at one split; one device
             launch per call, as ``torch.profiler`` counts it; the
             n_splits that is fastest over the three caps, kernel, plain
             and library (the gathers and one
             ``scaled_dot_product_attention`` with the H heads as query
             rows against one kv head) times at every cap and the bound of
             the live latent bytes and the f32 flops; information only,
             the earlier library composition (``enable_gqa=True``, the kv
             head expanded H-fold). K6 is also held bitwise on the MLA
             pools. Then the chain verify's 20-row pattern as for K4, K5
             at the lookup's split count gated faster than the library call
             at every cap.
13. train  — the same model and mode, remat="full", AdamW: run_loop for 3
             steps of batch 4 x 256 from DataPipeline(kind="lm"), the step
             replaying its captured CUDA graph (make_train_step's default
             on the card: the first call an eager warm-up, then the
             capture), with checkpoints at steps 2 and 3 in a temporary
             directory. Per step: loss, grad norm, wall and host CPU
             seconds, K1 and K2 launches (one K2 per dense call; K1 twice
             for a recomputed block's; a replay adds what its capture
             recorded). Gates: step 0's gradients of the kernels against
             the plain versions per leaf (cosine and relative error) and
             its loss bitwise; K1 and K2 launches per step equal to
             ``train_launches`` (393, 197); the final checkpoint restoring
             bitwise; a drain resumed from step 2's checkpoint ending
             bitwise equal to the uninterrupted one, and, as the shape's
             second drain, capturing nothing; the graph
             drain against its eager twin (graphs=False, the same initial
             state) bitwise in every loss, grad norm, parameter and
             optimizer leaf; 2 steps of in-situ E4M4 updates with
             stochastic rounding, graphs against eager, bitwise (state
             and generator); 2 steps with the plain versions (step 0's
             loss bitwise, step 1's within 1e-3). Prints wall ms and host
             CPU s per replayed step against the eager step, warm-up and
             capture seconds and each arm's peak device memory. The graph
             drain runs with a tracer, a metrics registry and a health
             monitor: three ``train.step`` spans carrying the drain's
             losses, a trace ``validate_trace`` accepts (``train.step``
             required), ``train_steps`` and ``train_step_s`` at 3, the
             twin's per-tile wear gauges (``hw_tile_writes_max`` 3,
             labeled ``hw_tile_read_chunks``) and the health series
             ``train.step_s`` and ``hw.tile_write_rate`` (1 a step).
14. mla    — with qwen3's state freed: deepseek-v3 at full width cut to
             its three dense layers (``get_config("deepseek-v3-671b",
             n_layers=3)``: MLA, FFN 18432, vocab 129280, untied head;
             random weights from --seed), TimeFloats ``mode="pallas"``.
             K1 bitwise at every decode-step shape (and its plans), with
             kernel, plain and library times and the bound; K3 bitwise at
             V = 129280 with threefry noise; a paged drain of the paged
             phase's 8 requests through Engine(paged=True, slots=4,
             max_len=512, page_size=16), with the kernels and then with
             the plain versions (gates: identical first tokens, >= 6 of 8
             identical streams, radix hits, a conserved pool, all-trash
             tables, K5 launched 3 times per decode step and K6 6 times
             per prefill wave, none in the plain drain); the same requests
             with SpecConfig(k=4) and chunk_tokens=32 together against the
             kernel drain (K5 at 20 rows on every layer of every step, chunk
             waves, a conserved pool, at least 7 of 8 streams identical and
             every divergence a near-tie flip, peak memory below 80 GB; its
             streams' digest is printed, to compare runs; its eager twin,
             drained after every other drain of the phase, must give the
             same streams); before them, the absorption products at 20 rows
             against 4-row columns (float32 einsums reported, the float64
             sums gated bitwise); then a dense engine drain of 4 requests (8
             new tokens, one at temperature 0.8, so the threefry key chain
             runs on the card), kernels against plain versions: identical
             streams. One engine's graphs are alive at a time. Prints the
             peak device memory.
15. moe    — with the MLA model freed: deepseek-v3 cut to 4 layers, its 3
             dense layers and its first MoE layer (256 routed experts of
             width 2048, top-8, one shared expert, capacity factor 1.25),
             every published width, bf16 parameters (15.11e9: 30.2 GB),
             random weights from --seed, TimeFloats ``mode="pallas"``. K1
             over a group of experts (``timefloats_matmul_experts``, one
             launch) at the MoE layer's wg, wu and wd shapes, at the decode
             capacity (8), a 4 x 64-token prefill's (16) and a drop-free
             verify's (20): bitwise
             against its plain version (the 2-D plain version expert by
             expert), on two calls and against the 2-D launch of each
             expert; kernel, plain and library (dequantize + batched f32
             matmul) times and the bound of one decode step's launches.
             One MoE block of a decode step (MLA mixer, router, dispatch,
             experts, shared expert, combine) and its MoE layer at a 20-row
             drop-free verify, kernels against plain versions within
             K5_TOL of max(1, |plain|). A paged drain of 4
             greedy requests (5-60 tokens, 8 new each; K1 dense and over
             experts, K5 every decode step, K6 every wave, K3) against its
             eager twin (identical streams and launches) and a warm drain
             that captures nothing; the same requests with SpecConfig(k=4)
             and chunk_tokens=32, its drafts a replay of the paged drain's
             streams (the MoE layer routes drop-free at the 20-row verify,
             K5 at 20 rows; drafts accepted), against its eager twin, every
             divergence from the paged drain a near-tie flip; no
             assignment dropped at any decode or verify dispatch (read on
             the eager twins); one eager decode step's device ms
             (``torch.profiler``) and its launches. Prints peak memory.
16. train_mla — deepseek-v3 cut to its first dense layer at every
             published width (``get_config("deepseek-v3-671b",
             n_layers=1)``: MLA with 128 heads, FFN 18432, vocab 129280,
             untied head; 2.437e9 parameters), TimeFloats ``mode="pallas"``,
             remat="full", SGD without momentum (AdamW's state and SGD's
             momentum do not fit; the initial state waits on the host),
             batch 4 x 256.
             Gates: step 0's loss bitwise and every gradient within
             K2_COSINE / K2_MAX_REL, kernels against plain versions; a
             3-step graph drain bitwise equal to its eager twin (losses,
             grad norms, every parameter leaf); K1 and K2
             launches per step equal to ``train_launches`` (17, 9); the
             final checkpoint restoring bitwise. Prints each arm's wall ms
             per step, a fourth step's device ms (``torch.profiler``) and
             peak memory.
17. graphs — in a process of its own, a step whose capture fails (a host
             sync) raises, is not counted and never runs eagerly in place of
             the graph.

The kernels' JSON record and then the card's name and power limit are
printed on the two lines before the last, each phase's seconds as it
ends; the last line is ``{"ok": true, "device": {...}}``. Run from the repository root:
``python3 chip_smoke.py`` (``--phases k1,paged`` runs a subset, in the
order above, and records only the kernels it held).
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
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SLOTS, MAX_LEN = 4, 512        # the main drain's engine
PROMPT_LENS = (5, 60)          # shortest and longest prompt of the drain
PAGE, PREFIX = 16, 48          # the paged drain's page size, shared prefix
# The smallest prefill bucket of every serving engine but the serve
# phase's: their drains' prompts (5-108 tokens) then land in one or two
# buckets, so each drain captures one or two prefill graphs (a capture
# costs about as much as an eager step). The serve phase keeps the
# engine's default of 8 and holds prefill[8] to prefill[64] on the card.
MIN_BUCKET = 64
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
# The chain verify's table extents: every pow2 KV cap of a 512-token engine.
VERIFY_CAPS = (1, 2, 4, 8, 16, 32)
PAGED_MIN_SAME = 6             # of 8 paged streams, kernels vs plain
K5_TOL = K4_TOL                # K5 against its plain version, the same way
SPEC_K = 4                     # draft depth of the speculative drains
VERIFY_ROWS = SLOTS * (SPEC_K + 1)   # K4/K5 rows of a chain verify: 20
MLA_LAYERS = 3                 # deepseek-v3's dense layers (first_k_dense)
MLA_CHUNK = 32                 # chunk_tokens of the MLA spec+chunked drain
# The MLA training vehicle: deepseek-v3's first dense layer at every
# published width (2.437e9 parameters; three layers' state does not fit).
MLA_TRAIN_LAYERS = 1
# Of its 8 streams, how many must equal the MLA kernel drain's: 7 since its
# absorption products sum in float64 (3-5 of 8 with float32 einsums, and
# which ones changed with the phases run before). The eighth parts at an
# exact tie: norms, softmax sums and the per-tensor prescale still see the
# rows a call carries (PERF.md §7).
MLA_SPEC_CHUNKED_SAME = 7
PHASES = ("k1", "k2", "k3", "k6", "k4", "k5", "hw", "serve", "paged",
          "chunked", "spec", "train", "mla", "moe", "train_mla")
HW_STEPS, HW_LR = 40, 0.08     # the edge MLP's in-situ SGD steps
COST_NEW = 2                   # new tokens per request of the cost drain
ENERGY_RTOL = 1e-9             # energy books: sums of the same terms


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


def train_shapes(cfg) -> dict:
    """(K, N) of every dense call of a training forward and its count:
    qwen3's projections (``k1_shapes``), or the MLA cut's wq_a, wq_b,
    wkv_a, wkv_b (the expanded path's up-projection), wo and its MLP, and
    the head either way."""
    if cfg.mla is None:
        return k1_shapes(cfg)
    m, h = cfg.mla, cfg.n_heads
    shapes = mla_k1_shapes(cfg)
    kn = (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim))
    shapes[kn] = shapes.get(kn, 0) + cfg.n_layers
    return shapes


def train_launches(cfg) -> tuple[int, int]:
    """(K1, K2) launches of one training step: every dense call's forward
    is one K1 (a checkpointed block's twice: forward and recomputation),
    its dx one K2; the head is outside the blocks."""
    blocks = sum(train_shapes(cfg).values()) - 1
    return (2 if cfg.remat == "full" else 1) * blocks + 1, blocks + 1


def k1_traffic(c: int, m: int, n: int) -> tuple[float, float]:
    """(bytes, int8 operations) of one K1 call on the unpadded function:
    qx (C,M,64) int8 and sx (C,M) f32, qw (C,64,N) int8 and sw (C,N) f32
    read once, the (M,N) f32 output written once."""
    nbytes = c * m * 64 + c * m * 4 + c * 64 * n + c * n * 4 + m * n * 4
    return float(nbytes), 2.0 * m * c * 64 * n


K1_RAGGED = ((12, 1000, 600), (1000, 1000, 3000))  # (M, K, N) besides


def k1_alternatives(km, m: int, c: int, n: int, rule) -> list:
    """Plans timed beside the rule's: at M <= 256 the rule's tile at 1, 2,
    4 and 8 splits and its family's widest tile unsplit; above, every tile
    of 64 rows or more."""
    if m > km.SPLIT_MAX_M:
        alts = [km.K1Plan(i, 1) for i, conf in enumerate(km.CONFIGS)
                if conf.bm >= 64]
    else:
        fam = km.SMALL_M[8] if m <= 8 else km.SMALL_M[32]
        alts = [km.K1Plan(fam[0], 1)] + [km.K1Plan(rule.config, s)
                                         for s in (1, 2, 4, 8)]
    ok = []
    for p in [rule] + alts:
        try:
            km.check_plan(p, m, c, n)
        except ValueError:
            continue
        if p not in ok:
            ok.append(p)
    return ok


def k1_hold(torch, km, a, cfgs, what: str, plans=()) -> float:
    """K1 bitwise against its plain version with and without the ADC, at
    the rule's plan and at ``plans``, and bitwise equal on two calls;
    returns the max |kernel - plain| seen (0 when bitwise)."""
    worst = 0.0
    for adc, cfg_tf in cfgs.items():
        want = km.timefloats_matmul_plain(*a, cfg_tf)
        for plan in (None, *plans):
            got = km.timefloats_matmul_quantized(*a, cfg=cfg_tf, plan=plan)
            again = km.timefloats_matmul_quantized(*a, cfg=cfg_tf, plan=plan)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            err = 0.0 if same else float((got - want).abs().nan_to_num(
                float("inf")).max().item())
            worst = max(worst, err)
            check(same, f"K1 {what} adc={adc} plan={plan}: kernel != plain "
                  f"(max abs {err})")
            check(torch.equal(got, again), f"K1 {what} adc={adc} plan={plan}:"
                  " two calls differ")
    return worst


def phase_k1(torch, cfg, seed: int, cfg_mla_train) -> list:
    from repro_torch.core import timefloats as tf
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import timefloats_matmul as km

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sms = _build.sm_count("cuda")
    per_step = k1_shapes(cfg)
    rows = k1_rows(cfg)
    print(f"K1 rows held: {rows}; deepseek-v3 training (K, N): "
          f"{sorted(train_shapes(cfg_mla_train))} at M = "
          f"{TRAIN_B * TRAIN_S}", flush=True)
    cfgs = {adc: tf.TFConfig(mode="pallas", adc_bits=adc, adc_mode="fixed")
            for adc in (None, 4)}
    worst = 0.0
    paths = ("decode", "train", "mla_train")
    tot = {path: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bytes": 0.0, "ops": 0.0} for path in paths}
    # qwen3's shapes at every main-path M, then the deepseek-v3 cut's
    # training calls at the training step's M; a training step runs each
    # checkpointed block's calls twice, the head once.
    sets = [(shapes, rws, c.vocab_size, 2 if c.remat == "full" else 1)
            for c, shapes, rws in (
                (cfg, per_step, rows),
                (cfg_mla_train, train_shapes(cfg_mla_train),
                 {"mla_train": TRAIN_B * TRAIN_S}))]
    slower = []
    for (k, n), count, rows, vocab, remat in (
            (kn, cnt, rws, v, r) for shapes, rws, v, r in sets
            for kn, cnt in shapes.items()):
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        # The ADC acts after the MAC, so both configs quantize alike.
        qw = tf.quantize_weight(tf._pow2_prescale(w, cfgs[None])[0],
                                cfgs[None])
        for label, m in rows.items():
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            qx = tf.quantize_input(tf._pow2_prescale(x, cfgs[None])[0],
                                   cfgs[None])
            a = ops.padded_operands(qx, qw)
            c, mp, np_ = a[0].shape[0], a[0].shape[1], a[2].shape[2]
            rule = km.k1_plan(mp, c, np_, sms)
            alts = k1_alternatives(km, mp, c, np_, rule)
            worst = max(worst, k1_hold(torch, km, a, cfgs,
                                       f"{label} M={m} K={k} N={n}",
                                       alts[1:] if label in tot else ()))
            ms = time_ms(torch, lambda: km.timefloats_matmul_quantized(
                *a, cfg=cfgs[None]), reps=20)
            adc_ms = time_ms(torch, lambda: km.timefloats_matmul_quantized(
                *a, cfg=cfgs[4]), reps=20)
            plain = time_ms(torch, lambda: km.timefloats_matmul_plain(
                *a, cfgs[None]), reps=3, warmup=1)
            lib = time_ms(torch, lambda: tf.dequantize_input(qx, k)
                          @ tf.dequantize_weight(qw, k), reps=10)
            nbytes, nops = k1_traffic(qx.q.shape[0], m, n)
            b_ms, b_by = bound(nbytes, nops)
            cnt = count * (remat if label in ("train", "mla_train")
                           and n != vocab else 1)
            if ms >= lib:
                slower.append((label, m, k, n))
            print(f"K1 {label:9s} M={m:4d} K={k:4d} N={n:6d} bitwise=True "
                  f"(adc None and 4, two calls) plan={tuple(rule)} "
                  f"tile={km.CONFIGS[rule.config].bm}x"
                  f"{km.CONFIGS[rule.config].bn} ms={ms:.4f} "
                  f"adc_ms={adc_ms:.4f} plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"share_of_bound={b_ms / ms:.4f} launches_per_step={cnt}",
                  flush=True)
            if label in tot:
                sweep = {p: time_ms(torch, lambda: km.timefloats_matmul_quantized(
                    *a, cfg=cfgs[None], plan=p), reps=20) for p in alts}
                print(f"K1 {label:9s} M={m:4d} K={k:4d} N={n:6d} ms by plan "
                      "(config, splits) " + " ".join(
                          f"{tuple(p)}:{t:.4f}" for p, t in sweep.items())
                      + f"; rule {tuple(rule)}, fastest "
                      f"{tuple(min(sweep, key=sweep.get))}", flush=True)
                t = tot[label]
                t["ms"] += cnt * ms
                t["plain_ms"] += cnt * plain
                t["library_ms"] += cnt * lib
                t["bytes"] += cnt * nbytes
                t["ops"] += cnt * nops
    for m, k, n in K1_RAGGED:
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        qw = tf.quantize_weight(tf._pow2_prescale(w, cfgs[None])[0],
                                cfgs[None])
        qx = tf.quantize_input(tf._pow2_prescale(x, cfgs[None])[0],
                               cfgs[None])
        a = ops.padded_operands(qx, qw)
        c, mp, np_ = a[0].shape[0], a[0].shape[1], a[2].shape[2]
        rule = km.k1_plan(mp, c, np_, sms)
        worst = max(worst, k1_hold(torch, km, a, cfgs, f"ragged M={m} K={k} "
                                   f"N={n}", k1_alternatives(km, mp, c, np_,
                                                             rule)[1:]))
        print(f"K1 ragged M={m} K={k} N={n} (padded {mp} x {np_}) bitwise=True"
              f" at plan {tuple(rule)} and its alternatives", flush=True)
    # Scales that the fused epilogue must refuse (its exactness argument
    # fails), one chunk each: sx past 2^104; sx * sw below 2^-149 (the
    # spec's product loses bits); sx * sw * p past the f32 range (the
    # spec's term is infinite); a subnormal sx; sx not a power of two.
    for m, k, n in ((4, 3072, 1024), (1024, 1024, 1024)):
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        qw = tf.quantize_weight(tf._pow2_prescale(w, cfgs[None])[0],
                                cfgs[None])
        qx = tf.quantize_input(tf._pow2_prescale(x, cfgs[None])[0],
                               cfgs[None])
        a = list(ops.padded_operands(qx, qw))
        sx, sw = a[1].clone(), a[3].clone()
        sx[0], sw[0] = 2.0 ** 110, 2.0 ** -120
        sx[1], sw[1] = 2.0 ** -100, 2.0 ** -60
        sx[2], sw[2] = 2.0 ** 20, 2.0 ** 100
        sx[3] = 2.0 ** -140
        sx[4] = 0.75 * 2.0 ** -4
        a[1], a[3] = sx, sw
        c, mp, np_ = a[0].shape[0], a[0].shape[1], a[2].shape[2]
        rule = km.k1_plan(mp, c, np_, sms)
        worst = max(worst, k1_hold(torch, km, a, cfgs, f"extreme scales M={m}"
                                   f" K={k} N={n}", k1_alternatives(
                                       km, mp, c, np_, rule)[1:]))
        print(f"K1 extreme scales M={m} K={k} N={n}: bitwise=True at plan "
              f"{tuple(rule)} and its alternatives (infinite outputs "
              f"{int(torch.isinf(km.timefloats_matmul_plain(*a, cfgs[None])).sum())})",
              flush=True)
    print(f"K1 slower than dequantize + f32 matmul at: {slower or 'none'}",
          flush=True)
    recs = []
    for path, what, n_calls in (
            ("decode", "one decode step", sum(per_step.values())),
            ("train", "one training step", train_launches(cfg)[0]),
            ("mla_train", "one deepseek-v3 training step",
             train_launches(cfg_mla_train)[0])):
        t = tot[path]
        b_ms, b_by = bound(t["bytes"], t["ops"])
        print(f"K1 per {what} ({n_calls} launches): ms={t['ms']:.4f} "
              f"plain_ms={t['plain_ms']:.4f} library_ms="
              f"{t['library_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"share_of_bound={b_ms / t['ms']:.4f}", flush=True)
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


K2_SPLITS = (1, 2, 3, 4)       # split counts swept beside the wrapper's rule
K2_RAGGED = (1000, 1000, 3000)  # (M, K, N) held besides the training shapes


def phase_k2(torch, cfg, seed: int, cfg_mla_train) -> list:
    from repro_torch.core import timefloats as tf
    from repro_torch.kernels import ops
    from repro_torch.kernels import timefloats_matmul as km

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    cfg_tf = tf.TFConfig(mode="pallas")
    m = TRAIN_B * TRAIN_S
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    recs = []
    # qwen3's training calls and a ragged shape, then the deepseek-v3 cut's
    # training calls, each at the training step's M.
    for c_, what, extra in ((cfg, "one training step", [(*K2_RAGGED, 0)]),
                            (cfg_mla_train, "one deepseek-v3 training step",
                             [])):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bf16_ms": 0.0,
               "bytes": 0.0, "ops": 0.0}
        worst_err, worst_share = 0.0, 0.0
        cases = [(m, k, n, count)
                 for (k, n), count in train_shapes(c_).items()] + extra
        for m_, k, n, count in cases:
            # The stored planes of a (K, N) weight, as the forward read them,
            # and a streamed gradient g (M, N) quantized along N.
            w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
            qw = tf.quantize_weight(tf._pow2_prescale(w, cfg_tf)[0], cfg_tf)
            g = torch.randn(m_, n, generator=gen, device="cuda") * 1e-3
            qg = tf.quantize_input(tf._pow2_prescale(g, cfg_tf)[0], cfg_tf)
            a = ops.padded_transposed_operands(qg, qw)
            d, c = a[0].shape[0], a[2].shape[0]
            rule = km.k2_splits(a[0].shape[1], c, d, sms)
            want = km.timefloats_matmul_transposed_plain(*a)
            tol = k2_tolerance(km, *a)
            sweep = []
            for sp in sorted({rule, *(x for x in K2_SPLITS if x <= d)}):
                got = km.timefloats_matmul_transposed_quantized(*a, cfg=cfg_tf,
                                                                splits=sp)
                again = km.timefloats_matmul_transposed_quantized(
                    *a, cfg=cfg_tf, splits=sp)
                torch.cuda.synchronize()
                diff = (got - want).abs()
                share = (diff / tol.clamp_min(1e-38)).max().item()
                err = diff.max().item()
                worst_err = max(worst_err, err)
                worst_share = max(worst_share, share)
                check(bool((diff <= tol).all())
                      and bool(torch.isfinite(got).all()),
                      f"K2 M={m_} K={k} N={n} splits={sp}: kernel outside "
                      f"N*2^-24*(|gd|@|wd|^T) of plain (max abs {err}, worst "
                      f"diff/tol {share})")
                check(torch.equal(got, again), f"K2 M={m_} K={k} N={n} "
                      f"splits={sp}: two calls on the same inputs differ")
                t = time_ms(torch, lambda: km.
                            timefloats_matmul_transposed_quantized(
                                *a, cfg=cfg_tf, splits=sp), reps=10)
                sweep.append((sp, t, share, err))
            ms = next(t for sp, t, _, _ in sweep if sp == rule)
            share = max(x for _, _, x, _ in sweep)
            err = max(e for _, _, _, e in sweep)
            plain = time_ms(torch, lambda: km.
                            timefloats_matmul_transposed_plain(*a), reps=5,
                            warmup=1)
            lib = time_ms(torch, lambda: torch.matmul(
                tf.dequantize_input(qg, n), tf.dequantize_weight(qw, k).T),
                reps=5, warmup=1)
            bf16 = time_ms(torch, lambda: torch.matmul(
                tf.dequantize_input(qg, n, torch.bfloat16),
                tf.dequantize_weight(qw, k, torch.bfloat16).T), reps=5,
                warmup=1)
            nbytes, nops = k2_traffic(m_, n, k)
            b_ms, b_by = bound(nbytes, nops, BF16_FLOPS_PER_S)
            print(f"K2 M={m_} K={k:4d} N={n:6d} D={d} splits={rule} (rule) "
                  f"bitwise_repeat=True max_abs={err:.3e} worst_diff/tol="
                  f"{share:.3e} ms={ms:.4f} plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"share_of_bound={b_ms / ms:.4f} launches_per_step={count}",
                  flush=True)
            print(f"K2 M={m_} K={k:4d} N={n:6d} ms by splits " + " ".join(
                f"{sp}:{t:.4f}" for sp, t, _, _ in sweep)
                + " worst_diff/tol by splits "
                + " ".join(f"{sp}:{x:.3e}" for sp, _, x, _ in sweep)
                + f"; information only: bf16 dequantize + bf16 matmul "
                f"{bf16:.4f} ms", flush=True)
            tot["ms"] += count * ms
            tot["plain_ms"] += count * plain
            tot["library_ms"] += count * lib
            tot["bf16_ms"] += count * bf16
            tot["bytes"] += count * nbytes
            tot["ops"] += count * nops
        b_ms, b_by = bound(tot["bytes"], tot["ops"], BF16_FLOPS_PER_S)
        print(f"K2 per {what} ({train_launches(c_)[1]} launches): "
              f"ms={tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
              f"library_ms={tot['library_ms']:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}) share_of_bound={b_ms / tot['ms']:.4f} "
              f"worst_diff/tol={worst_share:.3e}; information only: bf16 "
              f"dequantize + bf16 matmul {tot['bf16_ms']:.4f} ms", flush=True)
        recs.append({
            "name": f"K2 timefloats_matmul_transposed ({what})",
            "route": "cuda",
            "source": "src/repro_torch/csrc/timefloats_matmul_transposed.cu",
            "replaces": "src/repro/kernels/timefloats_matmul.py:132",
            "max_abs_err": worst_err, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tot["library_ms"]})
    return recs


K3_BLOCKS = (4, 8, 16)         # blocks (one cluster) per row, swept


def k3_hold(torch, ks, lg, noise, temps, what: str, want=None) -> None:
    """K3 at every cluster size against its plain version, bitwise, and
    against ``want`` where the case fixes the tokens."""
    plain = ks.sample_plain(lg, noise, temps)
    for p in K3_BLOCKS:
        got = ks.sample(lg, noise, temps, blocks_per_row=p)
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"K3 {what} blocks_per_row={p}: "
              f"kernel {got.tolist()} != plain {plain.tolist()}")
    if want is not None:
        check(plain.tolist() == want, f"K3 {what}: tokens {plain.tolist()} "
              f"!= {want}")


def k3_edges(torch, rnd, ks, seed: int, s: int, v: int) -> int:
    """Hold K3 bitwise at (s, v) on the cases a row cut over a cluster can
    get wrong; returns how many cases were held."""
    gen = torch.Generator(device="cuda").manual_seed(seed + s * v)
    temps = torch.tensor([0.0, 0.8, 1.0, 0.0][:s], device="cuda")
    lg = (torch.randn(s, v, generator=gen, device="cuda") * 4).round() / 4
    noise = (rnd.gumbel(rnd.fold_in(rnd.PRNGKey(seed, "cuda"), torch.arange(
        s, device="cuda")), (v,)) * 2).round() / 2
    held = 0
    # Greedy and temperature rows mixed, coarse values: ties are common.
    k3_hold(torch, ks, lg, noise, temps, f"S={s} V={v} mixed")
    held += 1
    # An exact tie straddling each slice boundary of every cluster size.
    top = 1.0e4
    for p in K3_BLOCKS:
        for b in range(1, p):
            x, z, want = lg.clone(), noise.clone(), []
            for r in range(s):
                e = ks.row_slices(v, p, r)[b][0]
                e = min(max(e, 1), v - 1)
                x[r, e - 1] = x[r, e] = top
                z[r, e - 1] = z[r, e] = 0.0
                want.append(e - 1)
            k3_hold(torch, ks, x, z, temps, f"S={s} V={v} tie at the "
                    f"{b}-th of {p} slice boundaries", want)
            held += 1
    # A tie between index 0 and V-1, an all -inf row, a NaN row.
    x = lg.clone()
    x[0, 0] = x[0, v - 1] = top
    want = [0]
    if s > 1:
        x[1] = float("-inf")
        want.append(0)
    if s > 2:
        x[2, v // 2] = float("nan")
        want.append(v)
    want += [None] * (s - len(want))
    z = noise.clone()
    z[0, 0] = z[0, v - 1] = 0.0
    k3_hold(torch, ks, x, z, temps, f"S={s} V={v} first/last tie, -inf and "
            f"NaN rows")
    got = ks.sample_plain(x, z, temps).tolist()
    check(all(w is None or g == w for g, w in zip(got, want)),
          f"K3 S={s} V={v} edges: tokens {got}, expected {want}")
    return held + 1


def phase_k3(torch, cfg, seed: int, mla_vocab: int) -> dict:
    from repro_torch import random as rnd
    from repro_torch.kernels import sampling as ks

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    s, v = 4, cfg.vocab_size
    lg = (torch.randn(s, v, generator=gen, device="cuda") * 4).round() / 4
    noise = (rnd.gumbel(rnd.fold_in(rnd.PRNGKey(seed, "cuda"), torch.arange(
        s, device="cuda")), (v,)) * 2).round() / 2
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
    held = {(s_, v_): k3_edges(torch, rnd, ks, seed, s_, v_) for s_, v_ in (
        (4, v), (4, mla_vocab), (1, v), (3, v + 1), (4, 301))}
    print("K3 bitwise at every cluster size " + str(K3_BLOCKS) + ": " +
          ", ".join(f"(S={s_}, V={v_}) {n} cases" for (s_, v_), n
                    in held.items()), flush=True)
    # The sweep over cluster sizes, and the record at the wrapper's default,
    # on this phase's (4, V) case (2 temperature rows) and at deepseek-v3's
    # vocabulary.
    lib_by_v = {}
    for v_ in (v, mla_vocab):
        x = (torch.randn(s, v_, generator=gen, device="cuda") * 4).round() / 4
        z = rnd.gumbel(rnd.fold_in(rnd.PRNGKey(seed, "cuda"), torch.arange(
            s, device="cuda")), (v_,))
        if v_ == v:
            x, z = lg, noise
        times = {p: time_ms(torch, lambda: ks.sample(
            x, z, temps, blocks_per_row=p), reps=50) for p in K3_BLOCKS}
        lib_by_v[v_] = time_ms(torch, lambda: torch.argmax(x, dim=-1),
                               reps=50)
        best = min(times, key=times.get)
        print(f"K3 S={s} V={v_} ms by blocks_per_row " + " ".join(
            f"{p}:{t:.4f}" for p, t in times.items()) + f"; fastest {best}, "
            f"picked {ks.cluster_blocks(x.device)} (of "
            f"{ks.CLUSTER_CHOICES}, by cudaOccupancyMaxActiveClusters); "
            f"library_ms(argmax)="
            f"{lib_by_v[v_]:.4f}", flush=True)
    ms = time_ms(torch, lambda: ks.sample(lg, noise, temps), reps=50)
    plain = time_ms(torch, lambda: ks.sample_plain(lg, noise, temps), reps=20)
    lib = lib_by_v[v]
    # lg is read once; noise only for the temperature rows (greedy rows
    # never touch it, in the kernel or in the function); temps in, tokens
    # out.
    hot = int((temps > 0).sum().item())
    b_ms, b_by = bound(lg.numel() * 4 + hot * v * 4 + s * 4 + s * 4, 0.0)
    greedy_ms, _ = bound(lg.numel() * 4 + s * 4 + s * 4, 0.0)
    print(f"K3 S={s} V={v} temperature_rows={hot} bitwise=True "
          f"tokens={got.tolist()} blocks_per_row={ks.cluster_blocks(lg.device)} "
          f"ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms(argmax)={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"share_of_bound={b_ms / ms:.4f} "
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


def k4_small_case(torch, gen, b, t, page, hkv, g, dk, dv, dtype):
    """tests/test_torch_paged_attn.py's construction on the card: f32 q,
    a random permutation of page ids, trash entries past each row's
    extent, a length-0 row and a single-page row."""
    n_pages = b * t + 2
    q = torch.randn(b, hkv * g, dk, generator=gen, device="cuda")
    kpool = torch.randn(n_pages, page, hkv, dk, generator=gen,
                        device="cuda").to(dtype)
    vpool = torch.randn(n_pages, page, hkv, dv, generator=gen,
                        device="cuda").to(dtype)
    lens = torch.randint(0, t * page + 1, (b,), generator=gen,
                         device="cuda", dtype=torch.int32)
    lens[0] = 0
    if b > 1:
        lens[1] = min(page, t * page)
    ids = torch.randperm(n_pages - 1, generator=gen, device="cuda")[:b * t]
    pt = (ids + 1).to(torch.int32).reshape(b, t)
    live = (lens.to(torch.int64) + page - 1) // page
    pt[torch.arange(t, device="cuda")[None, :] >= live[:, None]] = 0
    return q, kpool, vpool, pt, lens


def verify_table(torch, gen, n_pages: int, n_tab: int):
    """The chain verify's rows (``models/attention.verify_rows``) over an
    ``n_tab``-page table: slot b's pending position n0[b] (a fresh slot,
    one whose chain overhangs the table, one crossing a page, a random one)
    and its SPEC_K + 1 rows of lengths n0[b] + 1 .. n0[b] + SPEC_K + 1
    clamped to the table's extent, each row reading the slot's table.
    Returns the (VERIFY_ROWS, n_tab) table, the row lengths and the
    slots' live positions (each slot's longest row)."""
    cap = n_tab * PAGE
    rnd = int(torch.randint(0, cap, (1,), generator=gen,
                            device="cuda").item())
    n0 = torch.tensor([0, max(cap - 3, 0), (PAGE - 3) % cap, rnd],
                      dtype=torch.int64, device="cuda")
    j = torch.arange(SPEC_K + 1, device="cuda")
    lens = torch.clamp_max(n0[:, None] + 1 + j[None, :], cap)
    ids = torch.randperm(n_pages - 1, generator=gen,
                         device="cuda")[:SLOTS * n_tab]
    pt = (ids + 1).to(torch.int32).reshape(SLOTS, n_tab)
    live = (lens[:, -1] + PAGE - 1) // PAGE
    pt[torch.arange(n_tab, device="cuda")[None, :] >= live[:, None]] = 0
    return (pt.repeat_interleave(SPEC_K + 1, dim=0),
            lens.reshape(-1).to(torch.int32), int(lens[:, -1].sum().item()))


def one_launch(torch, fn, what: str) -> None:
    """Gate: one call of ``fn`` is one device launch, as the profiler sees
    the device."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"{what} profiler: {len(on_device)} device launch(es) in one "
          f"call: {on_device}", flush=True)
    check(len(on_device) == 1, f"{what}: {len(on_device)} device launches "
          f"in one call (expected 1): {on_device}")


def k4_hold(torch, kpa, case, ns: int, what: str) -> tuple[float, bool]:
    """K4 against its plain version (gate K4_TOL of max(1, |plain|),
    finite, length-0 rows exactly 0) and bitwise equal on two calls.
    Returns (relative error, bitwise)."""
    q, kpool, vpool, pt, lens = case
    dk = q.shape[-1]
    got = kpa.paged_decode_attention(q, kpool, vpool, pt, lens, n_splits=ns)
    again = kpa.paged_decode_attention(q, kpool, vpool, pt, lens,
                                       n_splits=ns)
    want = kpa._combine(*kpa._gqa_plain(
        q, kpool, vpool, pt, lens, scale=1.0 / math.sqrt(dk),
        n_splits=kpa._norm_splits(ns, pt.shape[1],
                                  page_size=kpool.shape[1],
                                  heads=q.shape[1], head_dim=dk)))
    torch.cuda.synchronize()
    err = ((got - want).abs().max()
           / want.abs().max().clamp_min(1.0)).item()
    check(err <= K4_TOL and bool(torch.isfinite(got).all())
          and bool((got[lens == 0] == 0).all()),
          f"K4 {what} n_splits={ns}: max rel {err} > {K4_TOL} or a "
          "length-0 row not exactly 0")
    check(torch.equal(got, again), f"K4 {what} n_splits={ns}: two calls "
          "differ")
    return err, torch.equal(got, want)


# tests/test_torch_paged_attn.py's GQA_CASES (b, t, page, hkv, g, dk, dv,
# pool dtype, n_splits), and one whose 24- and 40-byte rows are not 16-byte
# multiples (G = 3): the kernel stages those with loads, not cp.async.
K4_SMALL = ((2, 4, 8, 2, 2, 16, 16, "float32", 4),
            (1, 1, 4, 1, 1, 8, 8, "float32", 1),
            (3, 2, 16, 1, 4, 32, 16, "bfloat16", 2),
            (2, 8, 4, 4, 1, 16, 32, "bfloat16", 8),
            (3, 4, 8, 2, 2, 32, 32, "float32", 2),
            (2, 4, 8, 2, 3, 12, 20, "bfloat16", 2))
# The earlier two-kernel K4 (split kernel + combine kernel) at the 8-page
# cap, per launch, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
K4_TWO_KERNEL_MS = "0.0197-0.0199"


def verify_pattern(torch, what: str, heads: int, dim: int, gen, make,
                   hold, call, plain, library, n_pages: int, live_bytes,
                   faster: bool = False) -> int:
    """K4 or K5 at the chain verify's row pattern (:func:`verify_table`):
    at every cap of VERIFY_CAPS and n_splits of K4_SPLITS within the
    kernel's tolerance of its plain version (bitwise reported) and two
    calls equal, one launch a call; the n_splits sweep, whose winner at
    each cap is the record ``p{PAGE}_h{heads}_d{dim}_r{VERIFY_ROWS}_t{cap}``
    (K5's record) and summed over the caps the record without ``_t`` (K4's);
    at every cap the kernel at the split count the engine's lookup picks
    beside the library call (with ``faster``, gated faster); at the 8-page
    cap the kernel, plain, library and bound times (the bound counts each
    slot's live pages once, however many of its rows read them).
    ``make(pt, lens)`` builds the operands on the phase's pools. Returns
    the summed winner."""
    from repro_torch.kernels import paged_attn as kpa

    times = {ns: 0.0 for ns in K4_SPLITS}
    worst, exact, vcases, picked = 0.0, True, {}, {}
    for n_tab in VERIFY_CAPS:
        pt, lens, live = verify_table(torch, gen, n_pages, n_tab)
        case = make(pt, lens)
        for ns in K4_SPLITS:
            err, same = hold(case, ns, f"verify rows={VERIFY_ROWS} "
                             f"cap={n_tab}")
            worst, exact = max(worst, err), exact and same
        row, by_ns = [], {}
        for ns in K4_SPLITS:
            t = by_ns[ns] = time_ms(torch, lambda: call(case, ns), reps=50)
            times[ns] += t
            row.append(f"{ns}:{t:.4f}")
        lib = time_ms(torch, library(case), reps=50)
        ns = kpa._norm_splits(None, n_tab, page_size=PAGE, heads=heads,
                              head_dim=dim, rows=VERIFY_ROWS)
        picked[n_tab] = (ns, by_ns[ns], lib)
        print(f"{what} verify rows={VERIFY_ROWS} cap={n_tab:2d} pages "
              f"lengths={lens.tolist()} ms by n_splits {' '.join(row)}; "
              f"winner {min(by_ns, key=by_ns.get)}; the lookup's n_splits={ns} "
              f"ms={by_ns[ns]:.4f} library_ms={lib:.4f} "
              f"({lib / by_ns[ns]:.2f}x)", flush=True)
        vcases[n_tab] = (case, live)
    best = min(K4_SPLITS, key=lambda n: times[n])
    print(f"{what} verify rows={VERIFY_ROWS}: bitwise={exact} max "
          f"|diff|/max(1,|plain|) {worst:.3e} at caps {VERIFY_CAPS} x n_splits "
          f"{K4_SPLITS}; two calls equal; n_splits winner summed over the "
          f"caps {best}", flush=True)
    if faster:
        check(all(t < lib for _, t, lib in picked.values()),
              f"{what} verify rows={VERIFY_ROWS}: slower than the library "
              f"at a cap: {picked}")
    case, live = vcases[8]
    one_launch(torch, lambda: call(case, best),
               f"{what} verify rows={VERIFY_ROWS}")
    ms = time_ms(torch, lambda: call(case, best), reps=50)
    plain_ms = time_ms(torch, lambda: plain(case, best), reps=10)
    lib = time_ms(torch, library(case), reps=50)
    nbytes, ops, peak = live_bytes(case, live)
    b_ms, b_by = bound(nbytes, ops, peak)
    print(f"{what} verify rows={VERIFY_ROWS} cap=8 pages n_splits={best} "
          f"slots' live positions={live} KiB={nbytes / 1024:.1f} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by}) share_of_bound={b_ms / ms:.4f}; "
          f"at the lookup's n_splits={picked[8][0]} ms={picked[8][1]:.4f}",
          flush=True)
    return best


def phase_k4(torch, cfg, seed: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attn as kpa

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    hkv, d = cfg.n_kv_heads, cfg.resolved_head_dim
    times = {ns: 0.0 for ns in K4_SPLITS}
    worst, exact, cases, lib_by_cap = 0.0, True, {}, {}

    def library(case):
        q, kpool, vpool, pt, lens = case
        rows, s_len = pt.shape[0], pt.shape[1] * PAGE
        mask = (torch.arange(s_len, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]

        def run():
            k = kpool[pt].reshape(rows, s_len, hkv, d).transpose(1, 2)
            v = vpool[pt].reshape(rows, s_len, hkv, d).transpose(1, 2)
            return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        return run

    for n_tab in K4_CAPS:
        case = k4_case(torch, cfg, gen, n_tab)
        q, kpool, vpool, pt, lens = case
        for ns in K4_SPLITS:
            err, same = k4_hold(torch, kpa, case, ns, f"cap={n_tab}")
            worst, exact = max(worst, err), exact and same
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
        lib_by_cap[n_tab] = time_ms(torch, library(case), reps=50)
        print(f"K4 cap={n_tab:2d} pages lengths={lens.tolist()} ms by "
              f"n_splits {' '.join(row)}; library_ms(2 gathers + sdpa)="
              f"{lib_by_cap[n_tab]:.4f}", flush=True)
        cases[n_tab] = case
    ns_best = min(K4_SPLITS, key=lambda n: times[n])
    for shape in K4_SMALL:
        b, t, page, hkv_s, g, dk, dv, dtype, ns = shape
        case = k4_small_case(torch, gen, b, t, page, hkv_s, g, dk, dv,
                             getattr(torch, dtype))
        err, same = k4_hold(torch, kpa, case, ns, f"shape={shape}")
        worst, exact = max(worst, err), exact and same
    print(f"K4 n_splits winner over caps {K4_CAPS}: {ns_best} (key "
          f"p{PAGE}_h{cfg.n_heads}_d{d}_r{SLOTS}); bitwise={exact} max "
          f"|diff|/max(1,|plain|) {worst:.3e} (tolerance {K4_TOL}) at caps "
          f"{K4_CAPS} x n_splits {K4_SPLITS} and {len(K4_SMALL)} small "
          "shapes; two calls equal", flush=True)

    # Each cap at the winner beside the library composition.
    faster = True
    for n_tab, case in cases.items():
        ns = kpa._norm_splits(ns_best, n_tab, page_size=PAGE,
                              heads=cfg.n_heads, head_dim=d)
        t = time_ms(torch, lambda: kpa.paged_decode_attention(
            *case, n_splits=ns), reps=50)
        faster = faster and t < lib_by_cap[n_tab]
        print(f"K4 cap={n_tab:2d} n_splits={ns} ms={t:.4f} library_ms="
              f"{lib_by_cap[n_tab]:.4f} ({lib_by_cap[n_tab] / t:.2f}x)",
              flush=True)

    q, kpool, vpool, pt, lens = cases[8]   # the paged drain's usual cap
    one_launch(torch, lambda: kpa.paged_decode_attention(
        q, kpool, vpool, pt, lens, n_splits=ns_best), "K4")

    ms = time_ms(torch, lambda: kpa.paged_decode_attention(
        q, kpool, vpool, pt, lens, n_splits=ns_best), reps=50)
    plain = time_ms(torch, lambda: kpa._combine(*kpa._gqa_plain(
        q, kpool, vpool, pt, lens, scale=1.0 / math.sqrt(d),
        n_splits=ns_best)),
        reps=10)
    lib = time_ms(torch, library(cases[8]), reps=50)
    live = int(lens.sum().item())
    nbytes = (live * hkv * 2 * d * kpool.element_size() + q.numel() * 2
              + SLOTS * cfg.n_heads * d * 4 + pt.numel() * 4 + SLOTS * 4)
    b_ms, b_by = bound(nbytes, 4.0 * live * cfg.n_heads * d,
                       BF16_FLOPS_PER_S)
    verify_pattern(torch, "K4", cfg.n_heads, d, gen,
        lambda pt, lens: (torch.randn(VERIFY_ROWS, cfg.n_heads, d,
                                      generator=gen, device="cuda"
                                      ).bfloat16(), kpool, vpool, pt, lens),
        hold=lambda case, ns, what: k4_hold(torch, kpa, case, ns, what),
        call=lambda case, ns: kpa.paged_decode_attention(*case, n_splits=ns),
        plain=lambda case, ns: kpa._combine(*kpa._gqa_plain(
            *case, scale=1.0 / math.sqrt(d), n_splits=ns)),
        library=library, n_pages=kpool.shape[0],
        live_bytes=lambda case, live: (
            live * hkv * 2 * d * kpool.element_size() + case[0].numel() * 2
            + VERIFY_ROWS * cfg.n_heads * d * 4 + case[3].numel() * 4
            + VERIFY_ROWS * 4,
            4.0 * int(case[4].sum().item()) * cfg.n_heads * d,
            BF16_FLOPS_PER_S))
    per = cfg.n_layers
    print(f"K4 cap=8 pages n_splits={ns_best} live_positions={live} "
          f"KiB_live={nbytes / 1024:.1f} ms={ms:.4f} "
          f"(two-kernel design: {K4_TWO_KERNEL_MS}) "
          f"plain_ms={plain:.4f} "
          f"library_ms(2 gathers + sdpa, 3 calls)={lib:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by}) share_of_bound={b_ms / ms:.4f} "
          f"launches_per_decode_step={per}; per decode step ms="
          f"{per * ms:.4f} plain_ms={per * plain:.4f} "
          f"library_ms={per * lib:.4f} bound_ms={per * b_ms:.5f}; "
          f"faster than the library at every cap: {faster}",
          flush=True)
    return {"name": f"K4 paged_decode_attention (one decode step: {per} "
                    "launches, 8-page cap)",
            "route": "cuda", "source": "src/repro_torch/csrc/paged_attn_gqa.cu",
            "replaces": "src/repro/kernels/paged_attn.py:172",
            "max_abs_err": worst, "ms": per * ms, "plain_ms": per * plain,
            "bound_ms": per * b_ms, "bound_by": b_by,
            "library_ms": per * lib}


def phase_hw(torch, seed: int) -> None:
    """The paper's edge MLP in exact mode on the card against the CPU, its
    in-situ training, the twin's projection of its step and the
    full-width placements (module docstring, 7a)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.timefloats_mlp import CONFIG as mlp
    from repro_torch.core import float8
    from repro_torch.core import timefloats as tf
    from repro_torch.data.synthetic import classification_data
    from repro_torch.hw import mapper
    from repro_torch.hw import schedule as hs

    dims = (mlp.in_dim, *mlp.hidden, mlp.n_classes)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x_all, y_all = classification_data(gen, 1024 + 512, mlp.in_dim,
                                       mlp.n_classes, margin=0.35)
    ws = [torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
          for k, n in zip(dims[:-1], dims[1:])]
    x = x_all[:mlp.batch]
    g = torch.randn((mlp.batch, mlp.n_classes), generator=gen,
                    device="cuda")

    def fwd(ws, x):
        h = x
        for i, w in enumerate(ws):
            h = tf.linear(h, w, mlp.tf)
            if i + 1 < len(ws):
                h = torch.relu(h)
        return h

    # (a) forward and backward, the card against the CPU, bitwise.
    outs = {}
    for dev in ("cuda", "cpu"):
        wd = [w.to(dev, copy=True).requires_grad_() for w in ws]
        xd = x.to(dev, copy=True).requires_grad_()
        if dev == "cuda":
            with tf.op_census() as events:
                y = fwd(wd, xd)
        else:
            y = fwd(wd, xd)
        y.backward(g.to(dev))
        outs[dev] = [t.detach().cpu() for t in (y, xd.grad, *(
            w.grad for w in wd))]
    same = [torch.equal(a, b) for a, b in zip(outs["cuda"], outs["cpu"])]
    print(f"hw: edge MLP {'-'.join(map(str, dims))} at batch {mlp.batch}, "
          f"mode={mlp.tf.mode}: forward and backward on the card bitwise "
          f"equal to the CPU's: y {same[0]}, dx {same[1]}, dW "
          f"{same[2:]}", flush=True)
    check(all(same), "hw: exact mode on the card differs from the CPU")
    check(bool(torch.isfinite(outs["cuda"][0]).all()), "hw: y not finite")

    # In-situ SGD: weights on the E4M4 grid, stochastic rounding.
    x_ev, y_ev = x_all[1024:], y_all[1024:].long()
    wi = [float8.quantize_scaled(w, generator=gen) for w in ws]

    def held_out(ws):
        with torch.no_grad():
            lg = fwd(ws, x_ev)
        return (float(torch.nn.functional.cross_entropy(lg, y_ev)),
                float((lg.argmax(-1) == y_ev).float().mean()))

    loss0, acc0 = held_out(wi)
    t0 = time.monotonic()
    for step in range(HW_STEPS):
        idx = torch.randint(0, 1024, (mlp.batch,), generator=gen,
                            device="cuda")
        wg = [w.requires_grad_() for w in wi]
        loss = torch.nn.functional.cross_entropy(fwd(wg, x_all[idx]),
                                                 y_all[idx].long())
        grads = torch.autograd.grad(loss, wg)
        with torch.no_grad():
            wi = [float8.quantize_scaled(w - HW_LR * gw, generator=gen)
                  for w, gw in zip(wg, grads)]
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.monotonic() - t0) / HW_STEPS
    loss1, acc1 = held_out(wi)
    print(f"hw: {HW_STEPS} in-situ SGD steps (lr {HW_LR}, E4M4 weights, "
          f"stochastic rounding) at {step_ms:.1f} ms a step: held-out loss "
          f"{loss0:.4f} -> {loss1:.4f}, accuracy {acc0:.3f} -> {acc1:.3f}",
          flush=True)
    check(math.isfinite(loss1) and loss1 < loss0,
          f"hw: the in-situ loss did not fall ({loss0} -> {loss1})")

    # (b) the twin's projection of that step, from the card's census.
    meta = hs.capture_census(hs.edge_mlp_forward, ws, x, mlp.tf)
    check(sorted(events) == sorted(meta), f"hw: the card forward's census "
          f"{events} is not the meta trace's {meta}")
    pl, sched = hs.edge_mlp_schedule(mlp, events=events)
    tops = sched.read.hardware_tops_per_watt
    print(f"hw: twin of one training step: {pl.tiles} tiles, "
          f"{sched.read.chunks} chunk reads ({len(events)} forward reads "
          f"+ backward), hardware TOPS/W {tops:.4f} (paper 22.1), effective "
          f"{sched.read.effective_tops_per_watt:.4f}; energy "
          f"{sched.energy_pj * 1e-6:.4f} uJ (reads "
          f"{sched.read.energy_pj * 1e-6:.4f}, writes "
          f"{sched.write_energy_pj * 1e-6:.4f}), {sched.cells_written} cell "
          f"writes, latency bound {sched.latency_ns * 1e-3:.3f} us",
          flush=True)
    check(abs(tops - 22.1) / 22.1 < 0.01,
          f"hw: the twin projects {tops} TOPS/W, not 22.1 within 1 %")

    # (c) the twin at full width, shape-only.
    for arch in ("qwen3-0.6b", "deepseek-v3-671b", "kimi-k2-1t-a32b"):
        cfg = get_config(arch)
        t0 = time.monotonic()
        p = mapper.map_model(cfg)
        tok = hs.per_token_forward_cost(p, cfg)
        print(f"hw: {arch} at full width: {p.tiles} tiles, {p.macros} "
              f"macros, utilization {p.utilization:.6f}, "
              f"{p.cells_used / 1e9:.3f}e9 cells, by rule {p.by_rule()}; "
              f"forward {tok.energy_pj * 1e-6:.3f} uJ a token "
              f"({tok.chunks} chunk reads); mapped in "
              f"{1e3 * (time.monotonic() - t0):.1f} ms", flush=True)
        check(p.tiles > 0 and 0 < p.utilization <= 1, f"hw: {arch} placement")


def hold_energy(what: str, eng, done, cfg) -> dict:
    """A fresh engine's energy books after one drain: per-request pJ
    conserved (the requests' shares plus the idle remainder make the
    total, so the prefix credit, booked outside both, stays out of it)
    and the wear book's read chunks the executed tokens times the
    per-token census. Returns the telemetry."""
    from repro_torch.hw.schedule import per_token_forward_cost
    from repro_torch.serve.request import percentile

    hw = eng.hw_telemetry()
    check(hw is not None, f"{what}: the engine keeps no energy books")
    req = math.fsum(f.energy_pj for f in done)
    total, idle = hw["total_pj"], hw["idle_pj"]
    wear = eng._hw.wear
    per_tok = per_token_forward_cost(wear.placement, cfg).chunks
    tokens = hw["prefill_read_tokens"] + hw["decode_read_tokens"]
    pj_tok = percentile([f.pj_per_token for f in done], 50)
    print(f"{what}: energy books: total {total * 1e-6:.4f} uJ = requests "
          f"{req * 1e-6:.4f} + idle {idle * 1e-6:.4f}; pJ/token p50 "
          f"{pj_tok:.1f}; slot utilization {hw['slot_utilization']:.3f}; "
          f"prefix credit {hw['prefix_saved_pj'] * 1e-6:.4f} uJ over "
          f"{hw['prefix_hits']:g} hits; tile read chunks "
          f"{wear.reads_sum:.6g} = {tokens:g} tokens x {per_tok}",
          flush=True)
    check(all(f.energy_pj > 0 for f in done), f"{what}: a request without "
          "energy")
    check(abs(req + idle - total) <= ENERGY_RTOL * total,
          f"{what}: requests {req} + idle {idle} != total {total}")
    check(abs(wear.reads_sum - tokens * per_tok)
          <= ENERGY_RTOL * tokens * per_tok,
          f"{what}: wear reads {wear.reads_sum} != {tokens} x {per_tok}")
    return hw


def cost_drain(torch, params, cfg, seed: int) -> None:
    """The serve phase's requests, ``COST_NEW`` new tokens each, through an
    eager engine with ``sched="cost"``: every request finishes, every
    admission is the head of the scheduler's cost order at its step, and
    the first one the host-side recomputation of that order (projected
    pJ, then arrival)."""
    from repro_torch.hw.schedule import AdmissionCost
    from repro_torch.serve.engine import Engine

    eng = Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN, seed=seed,
                 sched="cost", graphs=False)
    reqs = _requests(cfg, seed)
    for r in reqs:
        r.max_new_tokens = COST_NEW
    picks, heads = [], []
    pick = eng.sched.pick

    def logged(queue, n_free, tracker, try_reserve=None):
        order = [queue[i].uid for i in eng.sched._order(queue)]
        got = pick(queue, n_free, tracker, try_reserve)
        picks.append([r.uid for r, _ in got])
        heads.append(order[:len(got)])
        return got

    eng.sched.pick = logged
    cost = AdmissionCost.for_model(params, cfg)
    want = sorted(range(len(reqs)), key=lambda u: (cost.request_score(
        len(reqs[u].prompt), COST_NEW), u))[:SLOTS]
    for r in reqs:
        eng.submit(r)
    t0 = time.monotonic()
    done = eng.run_until_drained()
    print(f"serve: cost-policy drain ({cost.token_pj:.1f} pJ a token) in "
          f"{time.monotonic() - t0:.2f}s: admissions {[p for p in picks if p]}"
          f", first by host-side cost {want}", flush=True)
    check(sorted(f.uid for f in done) == list(range(len(reqs)))
          and all(len(f.tokens) == COST_NEW for f in done),
          "serve: the cost-policy drain did not finish every request")
    check(picks == heads, f"serve: cost admissions {picks} are not the "
          f"heads of the cost order {heads}")
    check(picks[0] == want, f"serve: first cost admission {picks[0]}, "
          f"host-side order {want}")


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


def _drain(torch, params, cfg, seed: int, eng=None, **engine_kw):
    """Drain the serve phase's requests through a new dense engine (the
    engine's default prefill buckets), or through ``eng`` again."""
    from repro_torch.serve.engine import Engine

    if eng is None:
        eng = Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN, seed=seed,
                     **engine_kw)
    for r in _requests(cfg, seed):
        eng.submit(r)
    torch.cuda.synchronize()
    t0, c0 = time.monotonic(), time.process_time()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    cpu = time.process_time() - c0   # this process's CPU seconds, all threads
    eng.last_done = done             # for the energy gates
    return eng, {f.uid: [int(t) for t in f.tokens] for f in done}, wall, cpu


# -- CUDA graphs: every serving phase's kernel drain replays captured steps
# (the engine's default on the card) and is held against an eager drain.

def release(torch) -> None:
    """Free what dead engines hold: their graphs and memory pools (an
    engine a test double patched sits in a reference cycle until a
    collection)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def graph_note(what: str, eng, torch) -> None:
    """Print the step graphs ``eng`` captured, their capture seconds, the
    seconds of the eager warm-up steps before them, and the peak device
    memory since the last reset."""
    g = eng.graphs
    print(f"{what}: graphs={'on' if g.capture else 'off'} step callables="
          f"{len(g.counts)} capture_s={sum(g.capture_s.values()):.2f} ("
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(g.capture_s.items()))
          + f") after warm-up steps of {sum(g.warm_s.values()):.2f}s "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}",
          flush=True)


def snap(eng) -> tuple:
    """(captures, steps, host transfers, chunk waves) of an engine after a
    drain."""
    return eng.graphs.capture, eng.steps, eng.host_transfers, eng.chunk_waves


def hold_graphs(what: str, graph: tuple, eager: tuple) -> None:
    """A graph drain against an eager drain of the same engine
    configuration, each (:func:`snap`, streams, launches by kernel):
    identical streams, equal launches of every kernel, the same steps and
    host transfers, one transfer a decode step (a step() that runs only a
    chunk wave transfers without decoding)."""
    ((gc, g_steps, g_tr, g_cw), gs, gl), ((ec, e_steps, e_tr, _), es, el) = (
        graph, eager)
    check(gc and not ec, f"{what}: the graph drain must capture and the "
          "eager one not")
    same = sum(gs.get(u) == es.get(u) for u in es)
    print(f"{what}: graph drain against the eager drain: identical streams "
          f"{same}/{len(es)}; launches {gl} vs {el}; steps {g_steps} vs "
          f"{e_steps}; host_transfers {g_tr} vs {e_tr}", flush=True)
    check(gs == es, f"{what}: graph and eager streams differ")
    check(gl == el, f"{what}: launches differ: graphs {gl}, eager {el}")
    check(g_steps == e_steps and g_tr == e_tr
          and g_steps <= g_tr <= g_steps + g_cw,
          f"{what}: host transfers are not one a step")


def digest(streams: dict) -> str:
    """A short hash of a drain's streams, to compare drains across runs."""
    import hashlib

    return hashlib.sha256(json.dumps(sorted(streams.items())).encode()
                          ).hexdigest()[:16]


def step_times(what: str, steps: list) -> None:
    """Median wall ms of a drain's steps with and without a chunk wave (the
    step's one host copy ends each, so a step's wall is its device work
    plus what the host adds)."""
    import statistics

    for wave, label in ((True, "chunk-wave steps"), (False, "other steps")):
        ts = [1e3 * t for t, w in steps if w == wave]
        if ts:
            print(f"{what}: {label} median wall_ms={statistics.median(ts):.1f}"
                  f" (n={len(ts)}, min {min(ts):.1f}, max {max(ts):.1f})",
                  flush=True)


def hold_warm(what: str, eng, redrain) -> None:
    """Drain the same requests through ``eng`` again: nothing new may be
    captured. On a paged engine the radix tree now holds the prompts' pages,
    so the suffixes shorten and a prefill bucket the first drain never
    reached may be captured; a third drain must then capture nothing."""
    first = eng.compile_cache_stats()
    redrain()
    second = eng.compile_cache_stats()
    added = sorted(k for k in second if second[k] != first.get(k))
    buckets = [k for k in added if k != "prefill_total"]
    third = None
    if eng.paged and added and all(k.startswith("prefill[")
                                   for k in buckets):
        redrain()
        third = eng.compile_cache_stats()
    print(f"{what}: second drain on the same engine captured {added or 'nothing'}"
          + ("" if third is None else
             f"; a third captured "
             f"{sorted(k for k in third if third[k] != second.get(k)) or 'nothing'}")
          + f"; {second['prefill_total']} prefill and "
          f"{second['decode_total']} decode graphs", flush=True)
    check(not added or (third is not None and third == second),
          f"{what}: a warm drain captured {added}")


def span_kinds(tr) -> dict:
    """{span kind: (count, host seconds)} of a tracer's finished spans; a
    kind is the name up to its first ``[`` (``prefill.wave[64]`` and
    ``compile[decode_and_sample]`` count as ``prefill.wave`` and
    ``compile``)."""
    out: dict = {}
    for e in tr.events:
        if e.phase == "X":
            n, t = out.get(e.name.split("[")[0], (0, 0.0))
            out[e.name.split("[")[0]] = (n + 1, t + e.t1 - e.t0)
    return out


def hold_trace(what: str, eng, tr, hm=None, table: bool = False) -> dict:
    """The obs gates on a traced drain's engine: its trace and metrics
    written (``.json``) to a temporary directory, ``validate_trace`` (the
    required serving phases, nothing dropped, the pJ folds equal to
    ``hw_telemetry()`` exactly) and, with a health monitor, its report
    embedded and ``validate_health`` (alerts on tracked series, the SLO
    burn re-derived from the exported gauges) empty, and the in-process
    ``obs_report --validate`` returning 0; one ``host_transfer`` span a
    host transfer, one decode span a decode launch, one ``compile[...]``
    span a step graph captured, one ``pool.evict`` instant an eviction
    (evicted pages summed). Prints each span kind's count and host
    seconds (and, with ``table``, obs_report's summary). Returns the span
    kinds."""
    import contextlib
    import io

    from repro_torch.launch import obs_report
    from repro_torch.obs import export
    from repro_torch.obs.health import export_slo_gauges

    t0 = time.monotonic()
    meta = {"hw": eng.hw_telemetry()}
    if hm is not None:
        rep = hm.report(slos=eng.slos, metrics=eng.metrics)
        export_slo_gauges(eng.metrics, rep.slos)
        meta["health"] = rep.to_dict()
    with tempfile.TemporaryDirectory() as d:
        tpath = os.path.join(d, "trace.json")
        mpath = os.path.join(d, "metrics.json")
        export.write_metrics(mpath, eng.metrics)
        export.write_chrome_trace(tpath, tr, metadata=meta)
        with open(tpath) as f:
            payload = json.load(f)
        with open(mpath) as f:
            mdict = json.load(f)
        problems = export.validate_trace(payload)
        if hm is not None:
            problems += export.validate_health(payload, mdict)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = obs_report.main([tpath, "--metrics", mpath, "--validate"])
    kinds = span_kinds(tr)
    names = [e.name for e in tr.events]
    evicted = sum(e.args["evicted"] for e in tr.events
                  if e.name == "pool.evict")
    counts = {"host_transfer": (kinds["host_transfer"][0],
                                eng.host_transfers),
              "decode_and_*": (sum(n.startswith("decode_and_")
                                   for n in names), eng.decode_launches),
              "compile[...]": (kinds.get("compile", (0,))[0],
                               sum(eng.graphs.counts.values())),
              "pool.evict": (evicted, int(eng.stats().get(
                  "radix_evictions", 0)))}
    report = out.getvalue().splitlines()
    if table:   # obs_report's span table, up to its compile spans
        start = next(i for i, ln in enumerate(report)
                     if ln.startswith("span"))
        for ln in report[start:]:
            if ln.startswith(("recompiles", "hw twin", "health", "--")):
                break
            print(f"{what}: obs_report: {ln}", flush=True)
    print(f"{what}: trace of {len(tr.events)} events ({tr.dropped} "
          f"dropped), validate_trace {problems or 'ok'}, obs_report "
          f"--validate rc={rc} ({report[-1] if report else ''}); spans by "
          f"kind (count, host s): " + ", ".join(
              f"{k} {n} {t:.4f}" for k, (n, t) in sorted(kinds.items()))
          + "; counted against the engine: " + ", ".join(
              f"{k} {a}/{b}" for k, (a, b) in counts.items())
          + (f"; health: {len(hm.alerts)} alerts over {len(hm.series)} "
             f"series, SLOs " + ", ".join(
                 f"{s['name']} burn {s['burn_rate']:.3g}"
                 for s in meta["health"]["slos"]) if hm is not None else "")
          + f"; checked in {time.monotonic() - t0:.2f}s", flush=True)
    check(not problems, f"{what}: trace problems {problems}")
    check(rc == 0, f"{what}: obs_report --validate returned {rc}")
    check(tr.open_spans == 0 and tr.dropped == 0,
          f"{what}: open spans {tr.open_spans}, dropped {tr.dropped}")
    for k, (a, b) in counts.items():
        check(a == b, f"{what}: {a} {k} in the trace, the engine counts {b}")
    return kinds


def phase_serve(torch, cfg, seed: int, params) -> dict:
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import sampling as ks
    from repro_torch.kernels import timefloats_matmul as km
    from repro_torch.models import model
    from repro_torch.obs.health import HealthMonitor, default_serve_slos
    from repro_torch.obs.trace import NOOP, Tracer

    km.timefloats_matmul_quantized.launches = 0
    ks.sample.launches = 0
    torch.cuda.reset_peak_memory_stats()
    tr = Tracer()
    hm = HealthMonitor(tracer=tr)
    eng, streams, wall, cpu = _drain(torch, params, cfg, seed, tracer=tr,
                                     health=hm, slos=default_serve_slos())
    k1, k3 = km.timefloats_matmul_quantized.launches, ks.sample.launches
    graph_note("serve", eng, torch)
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
    hold_energy("serve", eng, eng.last_done, cfg)
    hold_trace("serve", eng, tr, hm, table=True)
    again, steps0, g_snap = [], eng.steps, snap(eng)
    hold_warm("serve", eng, lambda: again.append(
        _drain(torch, params, cfg, seed, eng=eng)))
    check(again[0][1] == streams, "serve: the warm drain's streams differ")
    traced_ms = 1e3 * again[0][2] / (eng.steps - steps0)
    print(f"serve: warm drain (every step a replay) in {again[0][2]:.2f}s: "
          f"wall_ms_per_step={traced_ms:.1f}"
          f" host_cpu_share={again[0][3] / again[0][2]:.3f}", flush=True)
    # The warm drain ran traced: it captured nothing, so it added no
    # compile span, and every step's transfer and decode have their span.
    hold_trace("serve warm", eng, tr, hm)
    eng.tracer = eng.graphs.tracer = NOOP
    eng.health = None
    steps0 = eng.steps
    _, plain_streams, plain_wall, _ = _drain(torch, params, cfg, seed,
                                             eng=eng)
    check(plain_streams == streams, "serve: the untraced warm drain's "
          "streams differ")
    print(f"serve: warm drain wall_ms_per_step traced with health "
          f"{traced_ms:.2f}, untraced "
          f"{1e3 * plain_wall / (eng.steps - steps0):.2f} (information "
          "only)", flush=True)

    km.timefloats_matmul_quantized.launches = 0
    ks.sample.launches = 0
    e_eng, e_streams, e_wall, e_cpu = _drain(torch, params, cfg, seed,
                                             graphs=False)
    print(f"serve: eager drain in {e_wall:.2f}s: wall_ms_per_step="
          f"{1e3 * e_wall / e_eng.steps:.1f} host_cpu_share="
          f"{e_cpu / e_wall:.3f}", flush=True)
    hold_graphs("serve", (g_snap, streams, {"K1": k1, "K3": k3}),
                (snap(e_eng), e_streams, {
                    "K1": km.timefloats_matmul_quantized.launches,
                    "K3": ks.sample.launches}))
    del e_eng

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
    cost_drain(torch, params, cfg, seed)
    return {"K1": k1, "K3": k3}


def _paged_requests(cfg, seed: int, max_new: int = 16):
    """8 greedy requests: a shared 48-token prefix (3 pages) plus tails of
    5-60 tokens, ``max_new`` new tokens each."""
    import numpy as np

    from repro_torch.serve.request import Request

    rng = np.random.default_rng(seed + 5)
    shared = rng.integers(0, cfg.vocab_size, PREFIX).astype(np.int32)
    lo, hi = PROMPT_LENS
    lens = rng.integers(lo, hi + 1, 8)
    lens[0], lens[1] = lo, hi
    return [Request(uid=i, prompt=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)]),
        max_new_tokens=max_new) for i, n in enumerate(lens)]


def _paged_drain(torch, params, cfg, seed: int, paged: bool = True,
                 max_new: int = 16, eng=None, setup=None, **engine_kw):
    """Drain the paged phase's requests through a new engine (``setup``
    sees it first), or through ``eng`` again."""
    from repro_torch.serve.engine import Engine

    if eng is None:
        eng = Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN, seed=seed,
                     paged=paged, page_size=PAGE, min_bucket=MIN_BUCKET,
                     **engine_kw)
        if setup is not None:
            setup(eng)
    for r in _paged_requests(cfg, seed, max_new):
        eng.submit(r)
    torch.cuda.synchronize()
    t0, c0 = time.monotonic(), time.process_time()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    cpu = time.process_time() - c0
    eng.last_done = done             # for the energy gates
    return eng, {f.uid: [int(t) for t in f.tokens] for f in done}, wall, cpu


TAP_TOP = 8   # logits kept per sampled row by LogitTap


class LogitTap:
    """Keeps the top ``TAP_TOP`` logits of every row of every sampling call
    an engine makes (the engine's ``sample_tokens``, wrapped while the tap
    is entered), so that a drain's token i of request u can be looked up by
    the (tag, counter) = (uid, i) the engine sampled it under.

    On a graph drain the top-k a step computes at its capture is read from
    the graph's own tensors after each of its replays (``StepGraphs.call``
    is wrapped too). Rows are copied out of the engine's graph pool at
    once: a warm-up's tensors there may sit in blocks another graph's
    replay rewrites. The top-k stays in the captured graph (the tap keeps
    its tensors, so the graph never writes a freed block), so a drain
    that is timed afterwards is tapped on its eager twin instead."""

    def __init__(self):
        from repro_torch.serve import engine as eng_mod
        from repro_torch.serve.request import StepGraphs

        self.mod, self.real, self.calls = eng_mod, eng_mod.sample_tokens, []
        self.cls, self.real_call = StepGraphs, StepGraphs.call
        self.fresh: list = []     # (captured?, rows) of the current call
        self.captured: dict = {}  # (graphs, name) -> rows its capture made

    def __enter__(self):
        import torch

        def tapped(logits, temps, key, tags, counters):
            # Copies of the keys as the step samples them: a step advances
            # its counters in place after sampling.
            top = logits.float().topk(TAP_TOP, dim=-1)
            self.fresh.append((torch.cuda.is_current_stream_capturing(), (
                top.values, top.indices, tags.clone(), counters.clone())))
            return self.real(logits, temps, key, tags, counters)

        def call(graphs, name, fn, *host):
            out = self.real_call(graphs, name, fn, *host)
            made, self.fresh = self.fresh, []
            for captured, rows in made:
                if captured:
                    self.captured.setdefault((graphs, name), []).append(rows)
                else:   # an eager call or a capture's warm-up
                    self.calls.append(tuple(t.clone() for t in rows))
            if not made:   # a replay: it rewrote the captured rows
                self.calls.extend(tuple(t.clone() for t in rows) for rows
                                  in self.captured.get((graphs, name), ()))
            return out

        self.mod.sample_tokens = tapped
        self.cls.call = call
        return self

    def __exit__(self, *exc):
        self.mod.sample_tokens = self.real
        self.cls.call = self.real_call

    def table(self) -> dict:
        """{(uid, i): [{token id: logit} of the top ones, ...]} over every
        row sampled under that key (idle and dummy rows share keys with
        real ones)."""
        out: dict = {}
        for v, i, tg, ct in self.calls:
            v, i = v.cpu().tolist(), i.cpu().tolist()
            for r, key in enumerate(zip(tg.cpu().tolist(), ct.cpu().tolist())):
                out.setdefault(key, []).append(dict(zip(i[r], v[r])))
        return out


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _row(table: dict, uid: int, i: int, tok: int):
    """The top logits of the row that produced token ``tok`` as token i of
    request ``uid``: every request is greedy, so ``tok`` holds the row's
    largest logit (ties go to the lowest id). A chain verify samples token
    i (counter i) in every step whose chain reaches it, and emits it in
    the last of them (the counter moves past it), so past the first token
    the last such row is the one; the first token's key, (uid, 0), is
    also that of the dummy rows of later waves, so there the first."""
    rows = table.get((uid, i), [])
    for top in (reversed(rows) if i else rows):
        if tok in top and top[tok] == max(top.values()):
            return top
    return None


def _lead(top, a: int, b: int):
    """How far a row's logit for token ``a`` leads its logit for ``b``, in
    bfloat16 ulps of the former; None when b is not among the kept top."""
    if top is None or b not in top:
        return None
    return (top[a] - top[b]) / bf16_ulp(top[a])


# A near-tie flip: at a stream's first divergence each drain ranks the
# other's pick among its own top TAP_TOP and leads it by at most this many
# bfloat16 ulps of its top logit.
NEAR_TIE_ULPS = 64


def divergence_report(what: str, a: tuple, b: tuple, phase: str = "paged",
                      first_ok: bool = False) -> dict:
    """Streams of two greedy drains, ``a`` and ``b`` = (name, streams, tap
    table): how many are identical and, for each that is not, the first
    differing token, how far each drain's own pick leads the other's pick
    in its logits there (bfloat16 ulps of the top logit) and whether the two
    picks are each other's runner-up (a swap of the top two). Beside them,
    the noise: the largest gap between the two drains' top logits at any
    token before a stream's first divergence (the same history in both).
    A near-tie flip is a divergence after the first token (at any token
    with ``first_ok``, for drains whose prefills compute differently) to a
    pick the other drain ranks high, by a small lead; a broken kernel
    diverges at once and to tokens the other drain ranks low."""
    (na, sa, ta), (nb, sb, tb) = a, b
    same, noise, swaps, rows, near = 0, 0.0, 0, 0, True
    found = seen = 0   # tokens whose rows both taps hold
    for u in sorted(sa):
        d = next((i for i, (x, y) in enumerate(zip(sa[u], sb[u])) if x != y),
                 None)
        for i in range(len(sa[u]) if d is None else d):
            ea, eb = _row(ta, u, i, sa[u][i]), _row(tb, u, i, sb[u][i])
            seen += 1
            found += bool(ea and eb)
            if ea and eb:
                noise = max(noise, abs(ea[sa[u][i]] - eb[sb[u][i]])
                            / bf16_ulp(ea[sa[u][i]]))
        if d is None:
            same += 1
            continue
        x, y = sa[u][d], sb[u][d]
        ea, eb = _row(ta, u, d, x), _row(tb, u, d, y)
        la, lb = _lead(ea, x, y), _lead(eb, y, x)
        second = lambda top, t: top is not None and t in top and sorted(  # noqa: E731
            top, key=lambda k: (-top[k], k))[1] == t
        swap = second(ea, y) and second(eb, x)
        swaps += swap
        rows += 1
        near = (near and (d > 0 or first_ok) and la is not None
                and lb is not None and max(la, lb) <= NEAR_TIE_ULPS)
        fmt = lambda v: "n/a" if v is None else f"{v:.2f}"  # noqa: E731
        print(f"{phase}: {what}: uid {u} first differs at token {d} ({na} "
              f"{x}, {nb} {y}); {na}'s lead of {x} over {y} {fmt(la)}, "
              f"{nb}'s lead of {y} over {x} {fmt(lb)} bf16 ulps; top-two "
              f"swap {swap}", flush=True)
    check(found == seen, f"{phase}: {what}: the logit taps hold the rows "
          f"of only {found}/{seen} tokens")
    where = "at any token" if first_ok else "after the first token"
    print(f"{phase}: {what}: identical streams {same}/{len(sa)}; divergences"
          f" that are top-two swaps {swaps}/{rows}; all near-tie flips "
          f"({where}, within each other's top {TAP_TOP}, "
          f"leads <= {NEAR_TIE_ULPS} ulps) {near}; noise between the two "
          f"drains' top logits before divergence {noise:.2f} bf16 ulps "
          f"(both taps hold the rows of {found}/{seen} tokens)", flush=True)
    return {"same": same, "near_ties": near, "noise": noise}


EVICT_PAGES = 17      # the eviction case's pool: 16 pages and the trash page
EVICT_NEW = 8         # its new tokens per request (trimmed from 16)
# Its depth: the model's first 7 of 28 layers (cut when the chunked and
# speculative phases came, to keep the smoke near its length; the pool's
# eviction does not depend on depth).
EVICT_LAYERS = 7
# The chunked and speculative phases' depth: qwen3's first 14 of 28 layers.
# With the moe phase and both at full depth the smoke took 1192.6 s of its
# 1200 s limit on one H100 (chunked 194.0 s, spec 156.2 s); chunking and
# speculation do not depend on depth.
CHUNKED_LAYERS = SPEC_LAYERS = 14


def phase_paged_serve(torch, cfg, seed: int, params) -> dict:
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import paged as kp
    from repro_torch.kernels import paged_attn as kpa
    from repro_torch.kernels import sampling as ks
    from repro_torch.kernels import timefloats_matmul as km

    from repro_torch.obs.trace import Tracer

    counters = {"K1": km.timefloats_matmul_quantized, "K3": ks.sample,
                "K4": kpa.paged_decode_attention, "K6": kp.gather_pages}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    reset()
    torch.cuda.reset_peak_memory_stats()
    tr = Tracer()
    eng, streams, wall, cpu = _paged_drain(torch, params, cfg, seed,
                                           tracer=tr)
    launches = {k: fn.launches for k, fn in counters.items()}
    graph_note("paged", eng, torch)
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
    hw = hold_energy("paged", eng, eng.last_done, cfg)
    check(hw["prefix_hits"] > 0 and hw["prefix_saved_pj"] > 0,
          "paged: no prefix credit booked")
    kinds = hold_trace("paged", eng, tr)
    check(kinds.get("radix.match", (0,))[0] >= 8
          and kinds.get("radix.insert", (0,))[0] == 8,
          f"paged: radix spans {kinds}")
    reset()
    with LogitTap() as tap_f:   # the kernel drain's logits, on its twin
        e_eng, e_streams, e_wall, e_cpu = _paged_drain(
            torch, params, cfg, seed, graphs=False)
    print(f"paged: eager drain in {e_wall:.2f}s: wall_ms_per_step="
          f"{1e3 * e_wall / e_eng.steps:.1f} host_cpu_share="
          f"{e_cpu / e_wall:.3f}", flush=True)
    hold_graphs("paged", (snap(eng), streams, launches), (
        snap(e_eng), e_streams, {k: fn.launches for k, fn in counters.items()}))
    del e_eng
    hold_warm("paged", eng, lambda: _paged_drain(torch, params, cfg, seed,
                                                 eng=eng))
    check(eng.pool.conserved(), "paged: pool not conserved after the warm "
          "drains")

    reset()
    with dispatch.override(kernels=False), LogitTap() as tap_p:
        ref_eng, ref, ref_wall, _ = _paged_drain(torch, params, cfg, seed)
    plain_launches = {k: fn.launches for k, fn in counters.items()}
    firsts = all(streams[u][0] == ref[u][0] for u in streams)
    print(f"paged: reference drain (plain versions) in {ref_wall:.2f}s; "
          f"identical first tokens {firsts}", flush=True)
    rep = divergence_report("kernels vs plain versions",
                            ("kernels", streams, tap_f.table()),
                            ("plain", ref, tap_p.table()))
    check(firsts, "paged: first tokens differ between kernels and plain")
    check(rep["near_ties"], "paged: kernels against plain versions: a "
          "divergence that is not a near-tie flip")
    check(rep["same"] >= PAGED_MIN_SAME, f"paged: only {rep['same']}/8 "
          "streams identical")
    check(all(v == 0 for v in plain_launches.values()),
          f"paged: the plain drain launched {plain_launches}")
    check(ref_eng.pool.conserved(), "paged: plain drain's pool")

    # The reference pins the paged engine to the dense one and fused split-K
    # decode to the gather composition; drain both on the same requests.
    with LogitTap() as tap_g:
        _, gather, _, _ = _paged_drain(torch, params, cfg, seed,
                                       fused_decode=False)
    with LogitTap() as tap_d:
        _, dense, _, _ = _paged_drain(torch, params, cfg, seed, paged=False)
    rep_gd = divergence_report("gather composition vs dense engine",
                               ("gather", gather, tap_g.table()),
                               ("dense", dense, tap_d.table()))
    rep_fg = divergence_report("fused split-K vs gather composition",
                               ("fused", streams, tap_f.table()),
                               ("gather", gather, tap_g.table()))
    # The reference's bar for fused split-K against the gather composition
    # was set without TimeFloats (quant="none", bf16); run its conditions.
    cfg_none = dataclasses.replace(cfg, quant="none")
    with LogitTap() as tap_fn:
        _, fused_n, _, _ = _paged_drain(torch, params, cfg_none, seed)
    with LogitTap() as tap_gn:
        _, gather_n, _, _ = _paged_drain(torch, params, cfg_none, seed,
                                         fused_decode=False)
    rep_n = divergence_report("quant=none fused split-K vs gather "
                              "composition",
                              ("fused", fused_n, tap_fn.table()),
                              ("gather", gather_n, tap_gn.table()))
    # The reference pins the paged engine to the dense one bitwise. Its 6/8
    # bar for fused split-K against the gather composition does not hold
    # at this width and vocabulary, not even without TimeFloats: bf16
    # logits over 151936 tokens leave top-two gaps of a few ulps, which the
    # two attention algorithms' roundings flip (PERF.md, ROADMAP Queue 3).
    # What holds, and is gated, is that every divergence is such a flip.
    check(rep_gd["same"] == 8, f"paged: the gather composition agrees with "
          f"the dense engine on {rep_gd['same']}/8 streams; the reference "
          "pins them bitwise")
    for rep, what in ((rep_fg, "TimeFloats"), (rep_n, "quant=none")):
        check(rep["near_ties"], f"paged: {what} fused split-K against the "
              "gather composition: a divergence that is not a near-tie flip")

    # Eviction: a 16-page pool for 8 requests of up to 8 pages, 4 at a time,
    # through the model's first EVICT_LAYERS layers.
    cfg = dataclasses.replace(cfg, n_layers=EVICT_LAYERS)
    params = dict(params, layers=params["layers"][:EVICT_LAYERS])
    reset()
    ev_tr = Tracer()
    ev_eng, ev, _, _ = _paged_drain(torch, params, cfg, seed,
                                    max_new=EVICT_NEW, num_pages=EVICT_PAGES,
                                    tracer=ev_tr)
    ev_launches = {k: fn.launches for k, fn in counters.items()}
    with dispatch.override(kernels=False):
        ev_ref_eng, ev_ref, _, _ = _paged_drain(
            torch, params, cfg, seed, max_new=EVICT_NEW,
            num_pages=EVICT_PAGES)
    ev_st = ev_eng.stats()
    ev_same = sum(ev[u] == ev_ref.get(u) for u in ev)
    ev_firsts = sorted(ev) == sorted(ev_ref) and all(
        ev[u][0] == ev_ref[u][0] for u in ev)
    print(f"paged evict: {EVICT_LAYERS} layers, pool {EVICT_PAGES} pages, "
          f"{EVICT_NEW} new tokens: "
          + " ".join(f"{k}={ev_st[k]:g}" for k in (
              "steps", "radix_hits", "radix_evictions", "pool_pages_total",
              "pool_pages_in_use", "pool_pages_free"))
          + f"; launches {ev_launches}; identical streams against the plain "
          f"versions {ev_same}/8 (gate >= {PAGED_MIN_SAME}), first tokens "
          f"{ev_firsts}", flush=True)
    check(sorted(ev) == list(range(8))
          and all(len(t) == EVICT_NEW for t in ev.values()),
          f"paged evict: 8 requests of {EVICT_NEW} tokens")
    check(ev_st["radix_evictions"] > 0 and ev_ref_eng.stats()[
        "radix_evictions"] > 0, "paged evict: no eviction")
    check(ev_eng.pool.conserved() and ev_ref_eng.pool.conserved(),
          "paged evict: pool not conserved")
    check(not bool(ev_eng.state.cache.layers[0].pt.any()),
          "paged evict: page tables not all-trash after the drain")
    check(ev_firsts, "paged evict: first tokens differ from the plain drain")
    check(ev_same >= PAGED_MIN_SAME, f"paged evict: only {ev_same}/8 streams"
          " identical")
    hold_trace("paged evict", ev_eng, ev_tr)
    check(any(e.name == "pool.evict" for e in ev_tr.events),
          "paged evict: no pool.evict instant")
    reset()
    return launches


CHUNK = 64                     # chunk_tokens of the chunked phase
CHUNK_LONG = (150, 400)        # its long prompts' lengths


class RowCount:
    """Counts the launches of a kernel wrapper's CUDA entry by their row
    count (the first dimension of the first operand), while entered. A
    replay does not call the wrapper, so it counts eager drains only, and
    a capture while it is entered fails the smoke."""

    def __init__(self, mod, name: str):
        self.mod, self.name, self.rows = mod, name, {}

    def __enter__(self):
        import torch

        real = self.real = getattr(self.mod, self.name)

        def counted(q, *a, **kw):
            check(not torch.cuda.is_current_stream_capturing(),
                  f"RowCount({self.name}) on a graph drain")
            self.rows[q.shape[0]] = self.rows.get(q.shape[0], 0) + 1
            return real(q, *a, **kw)

        setattr(self.mod, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def _drive(torch, eng, reqs, steps=None):
    """Submit ``reqs`` and step ``eng`` until drained. Returns the streams,
    the wall and host CPU seconds, the step() calls and the most host
    transfers any one call made. ``steps`` collects each call's wall
    seconds and whether it ran a chunk wave."""
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0, c0 = time.monotonic(), time.process_time()
    done, calls, most = [], 0, 0
    while eng.active or eng._chunking or eng.queue:
        h0, w0, t1 = eng.host_transfers, eng.chunk_waves, time.monotonic()
        done.extend(eng.step())
        if steps is not None:
            steps.append((time.monotonic() - t1, eng.chunk_waves > w0))
        calls += 1
        most = max(most, eng.host_transfers - h0)
        check(calls < 10_000, "a drain did not end")
    torch.cuda.synchronize()
    return ({f.uid: [int(t) for t in f.tokens] for f in done},
            time.monotonic() - t0, time.process_time() - c0, calls, most)


def _chunk_requests(cfg, seed: int, prefix: bool):
    """8 greedy requests of 8 new tokens: 4 long prompts (CHUNK_LONG
    tokens) and 4 of PROMPT_LENS tokens, alternating; with ``prefix``
    each after the paged phase's 48-token shared prefix."""
    import numpy as np

    from repro_torch.serve.request import Request

    shared = np.random.default_rng(seed + 5).integers(
        0, cfg.vocab_size, PREFIX).astype(np.int32)
    rng = np.random.default_rng(seed + 9)
    lens = np.empty(8, np.int64)
    lens[0::2] = rng.integers(CHUNK_LONG[0], CHUNK_LONG[1] + 1, 4)
    lens[1::2] = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, 4)
    out = []
    for i, n in enumerate(lens):
        p = rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
        out.append(Request(uid=i, prompt=np.concatenate([shared, p])
                           if prefix else p, max_new_tokens=DENSE_NEW))
    return out


def _report(what: str, eng, streams: dict, wall: float, calls: int,
            most: int, launches: dict) -> dict:
    st = eng.stats()
    new = int(st["new_tokens"])
    print(f"{what}: drained {int(st['finished'])} requests, {new} tokens in "
          f"{wall:.2f}s: tok/s={new / wall:.2f} ttft_p50_s="
          f"{st['ttft_p50_s']:.4f} steps={eng.steps} step_calls={calls} "
          f"host_transfers={eng.host_transfers} (most in one step {most}) "
          f"chunk_waves={eng.chunk_waves} launches={launches}", flush=True)
    check(most <= 1, f"{what}: {most} host transfers in one step")
    return st


def phase_chunked(torch, cfg, seed: int, params) -> dict:
    """Chunked prefill at full width through the model's first
    CHUNKED_LAYERS layers: Engine(chunk_tokens=CHUNK), dense and paged,
    against the same engine unchunked (kernels in both)."""
    cfg = dataclasses.replace(cfg, n_layers=CHUNKED_LAYERS)
    params = dict(params, layers=params["layers"][:CHUNKED_LAYERS])
    from repro_torch.kernels import paged as kp
    from repro_torch.kernels import paged_attn as kpa
    from repro_torch.kernels import sampling as ks
    from repro_torch.kernels import timefloats_matmul as km
    from repro_torch.serve.engine import Engine

    counters = {"K1": km.timefloats_matmul_quantized, "K3": ks.sample,
                "K4": kpa.paged_decode_attention, "K6": kp.gather_pages}
    out = {}
    for paged in (False, True):
        mode = "paged" if paged else "dense"
        kw = dict(slots=SLOTS, max_len=MAX_LEN, seed=seed, paged=paged,
                  page_size=PAGE, min_bucket=MIN_BUCKET)
        for fn in counters.values():
            fn.launches = 0
        eng = Engine(params, cfg, chunk_tokens=CHUNK, **kw)
        k6_chunks = [0]
        run_wave = eng._run_chunk_wave

        def counted_wave(*a, run_wave=run_wave, **kw):
            k0 = kp.gather_pages.launches
            res = run_wave(*a, **kw)
            k6_chunks[0] += kp.gather_pages.launches - k0
            return res

        eng._run_chunk_wave = counted_wave
        reqs = _chunk_requests(cfg, seed, prefix=paged)
        torch.cuda.reset_peak_memory_stats()
        got, wall, _, calls, most = _drive(torch, eng, reqs)
        launches = {k: fn.launches for k, fn in counters.items()}
        st = _report(f"chunked {mode}", eng, got, wall, calls, most,
                     launches)
        graph_note(f"chunked {mode}", eng, torch)
        # The eager twin: the graph drain's gate, and the logits of the
        # chunked streams for the report against the unchunked engine.
        for fn in counters.values():
            fn.launches = 0
        e_eng = Engine(params, cfg, chunk_tokens=CHUNK, graphs=False, **kw)
        with LogitTap() as tap_c:
            e_got, e_wall, _, e_calls, e_most = _drive(
                torch, e_eng, _chunk_requests(cfg, seed, prefix=paged))
        _report(f"chunked {mode} (eager)", e_eng, e_got, e_wall, e_calls,
                e_most, {})
        hold_graphs(f"chunked {mode}", (snap(eng), got, launches), (
            snap(e_eng), e_got, {k: fn.launches for k, fn in counters.items()}))
        del e_eng
        base = Engine(params, cfg, **kw)
        with LogitTap() as tap_u:
            ref, ref_wall, _, ref_calls, ref_most = _drive(
                torch, base, _chunk_requests(cfg, seed, prefix=paged))
        _report(f"chunked {mode} (unchunked engine)", base, ref, ref_wall,
                ref_calls, ref_most, {})
        rep = divergence_report(f"{mode} chunked vs unchunked",
                                ("chunked", got, tap_c.table()),
                                ("unchunked", ref, tap_u.table()),
                                phase="chunked", first_ok=True)
        check(sorted(got) == list(range(8)) and all(
            len(t) == DENSE_NEW for t in got.values()),
            f"chunked {mode}: 8 requests of {DENSE_NEW} tokens")
        check(rep["near_ties"], f"chunked {mode}: a divergence from the "
              "unchunked engine that is not a near-tie flip")
        check(eng.chunk_waves > 0, f"chunked {mode}: no chunk wave")
        tiles: dict = {}
        for uid, off, n in eng.chunk_log:
            tiles.setdefault(uid, []).append((off, n))
        for r in reqs:
            pos = tiles.get(r.uid, [(len(r.prompt), 0)])[0][0]
            for off, n in tiles.get(r.uid, []):
                check(off == pos and 0 < n <= CHUNK,
                      f"chunked {mode}: uid {r.uid}'s chunks do not tile")
                pos += n
            check(pos == len(r.prompt), f"chunked {mode}: uid {r.uid}'s "
                  "chunks do not reach the prompt's end")
        long_uids = [r.uid for r in reqs if len(r.prompt) >= CHUNK_LONG[0]]
        check(all(u in tiles for u in long_uids),
              f"chunked {mode}: a long prompt was not chunked")
        check(launches["K1"] > 0 and launches["K3"] > 0,
              f"chunked {mode}: launches {launches}")
        if paged:
            check(st["radix_hits"] > 0, "chunked paged: no radix hit")
            check(eng.pool.conserved() and base.pool.conserved(),
                  "chunked paged: pool not conserved")
            check(not bool(eng.state.cache.layers[0].pt.any()),
                  "chunked paged: page tables not all-trash after the drain")
            check(k6_chunks[0] == 2 * cfg.n_layers * eng.chunk_waves,
                  f"chunked paged: {k6_chunks[0]} K6 launches in "
                  f"{eng.chunk_waves} chunk waves")
            print("chunked paged: " + " ".join(f"{k}={st[k]:g}" for k in (
                "radix_hits", "radix_hit_rate", "pool_pages_in_use",
                "pool_pages_free")) + f"; K6 launches on chunk waves "
                f"{k6_chunks[0]}", flush=True)
            out = launches
        warm: list = []
        hold_warm(f"chunked {mode}", eng, lambda: _drive(
            torch, eng, _chunk_requests(cfg, seed, prefix=paged),
            steps=warm))
        step_times(f"chunked {mode} warm drains (replays)", warm)
    return out


def _motif_requests(cfg, seed: int, n: int, max_new: int):
    """tests/test_spec.py's motif-tiled prompts at full vocabulary: 3 or 4
    tiles of one 8-token motif and 2 random tokens, greedy."""
    import numpy as np

    from repro_torch.serve.request import Request

    rng = np.random.default_rng(seed + 10)
    motif = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    return [Request(uid=u, prompt=np.concatenate([
        np.tile(motif, 3 + u % 2),
        rng.integers(0, cfg.vocab_size, 2).astype(np.int32)]),
        max_new_tokens=max_new) for u in range(n)]


def replay_drafts(eng, streams: dict):
    """Replace ``eng``'s ngram draft by a replay of ``streams`` (uid ->
    tokens, the spec-off drain's): each active slot proposes the next
    SPEC_K tokens of its request's stream after those it has emitted. It
    tests the accept path (several tokens a step, the rollback, scratch
    pages) where the ngram draft has nothing to offer: a model with random
    weights does not repeat itself (run 1 of this phase accepted none of
    480 ngram drafts)."""
    import numpy as np

    def build():
        draft = np.zeros((eng.slots, SPEC_K), np.int32)
        for slot, req in eng.active.items():
            nxt = streams[req.uid][len(req.generated):][:SPEC_K]
            draft[slot, :len(nxt)] = nxt
        return draft

    eng._build_drafts = build


SELF_DRAFT_MIN = 0.9   # self-draft acceptance on the card
# The self-draft drain's new tokens: the prefill's and three whole chains
# of SPEC_K + 1, so the budget cuts no chain short (a cut chain's unemitted
# drafts count as rejected). A near-tie flip between the draft's 4-row
# decode and the 20-row verify costs SPEC_K + 1 drafts (those it rejects,
# then those the budget cuts from the extra step it causes): three chains
# keep one flip above SELF_DRAFT_MIN (47 of 52), two would not (31 of
# 36, run 3 of this phase).
SELF_DRAFT_NEW = 1 + 3 * (SPEC_K + 1)


def phase_spec(torch, cfg, seed: int, params) -> dict:
    """Speculative decoding at full width through the model's first
    SPEC_LAYERS layers: a paged engine with SPEC_K-token drafts, ngram and
    then a replay of the spec-off stream, each against the same engine
    without speculation; then a dense self-draft drain."""
    cfg = dataclasses.replace(cfg, n_layers=SPEC_LAYERS)
    params = dict(params, layers=params["layers"][:SPEC_LAYERS])
    from repro_torch.kernels import paged as kp
    from repro_torch.kernels import paged_attn as kpa
    from repro_torch.kernels import sampling as ks
    from repro_torch.kernels import timefloats_matmul as km
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.spec import SpecConfig

    counters = {"K1": km.timefloats_matmul_quantized, "K3": ks.sample,
                "K4": kpa.paged_decode_attention, "K6": kp.gather_pages}
    kw = dict(slots=SLOTS, max_len=MAX_LEN, seed=seed, paged=True,
              page_size=PAGE, min_bucket=MIN_BUCKET)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]

    def summary(what, e, st_, wall_):
        # A verify step emits 1 + (accepted drafts) tokens per active slot.
        per_slot = 1.0 + SPEC_K * st_.get("spec_accept_rate", 0.0)
        print(f"{what}: steps={e.steps} tokens_per_step (all slots)="
              f"{st_['new_tokens'] / max(e.steps, 1):.3f} tokens_per_slot_"
              f"step={per_slot:.3f} tok/s={st_['new_tokens'] / wall_:.2f} "
              f"ttft_p50_s={st_['ttft_p50_s']:.4f} ({smi})", flush=True)

    base = Engine(params, cfg, **kw)
    with LogitTap() as tap_b:
        ref, ref_wall, _, ref_calls, ref_most = _drive(
            torch, base, _motif_requests(cfg, seed, 8, 16))
    summary("spec off", base, _report("spec off", base, ref, ref_wall,
                                      ref_calls, ref_most, {}), ref_wall)
    out = {}
    for draft in ("ngram", "replay"):
        what = f"spec {draft}"
        graph = None
        if draft == "ngram":
            for fn in counters.values():
                fn.launches = 0
            tr = Tracer()
            eng = Engine(params, cfg, spec=SpecConfig(k=SPEC_K), tracer=tr,
                         **kw)
            torch.cuda.reset_peak_memory_stats()
            got, wall, _, calls, most = _drive(
                torch, eng, _motif_requests(cfg, seed, 8, 16))
            launches = {k: fn.launches for k, fn in counters.items()}
            graph_note(what, eng, torch)
            summary(what, eng, _report(what, eng, got, wall, calls, most,
                                       launches), wall)
            # The verify spans' accepted/rejected pJ fold to the twin's
            # speculative split exactly (validate_trace).
            hold_trace(what, eng, tr)
            hw = eng.hw_telemetry()
            check(hw["spec_rejected_pj"] > 0, f"{what}: no rejected pJ "
                  "booked")
            graph = (snap(eng), got, launches)
            out = launches
        # The eager drain: the ngram graph drain's twin (its logits and K4
        # launches by rows are read here); the replay drain takes 8 steps,
        # where captures would outweigh replays.
        for fn in counters.values():
            fn.launches = 0
        e = Engine(params, cfg, spec=SpecConfig(k=SPEC_K), graphs=False, **kw)
        if draft == "replay":
            replay_drafts(e, ref)
        with LogitTap() as tap_s, RowCount(kpa, "_gqa_kernel") as k4_rows:
            e_got, e_wall, _, e_calls, e_most = _drive(
                torch, e, _motif_requests(cfg, seed, 8, 16))
        e_launches = {k: fn.launches for k, fn in counters.items()}
        k3_rows: dict = {}   # the engine's sampling calls, one K3 each
        for values, *_ in tap_s.calls:
            k3_rows[values.shape[0]] = k3_rows.get(values.shape[0], 0) + 1
        st = _report(f"{what} (eager)", e, e_got, e_wall, e_calls, e_most,
                     e_launches)
        summary(f"{what} (eager)", e, st, e_wall)
        print(f"{what}: accepted {int(st['spec_accepted'])} of "
              f"{int(st['spec_proposed'])} drafts (rate "
              f"{st['spec_accept_rate']:.4f}); K4 launches by rows "
              f"{k4_rows.rows}; K3 launches by rows {k3_rows}", flush=True)
        if graph is not None:
            hold_graphs(what, graph, (snap(e), e_got, e_launches))
        rep = divergence_report(f"{draft} spec on vs spec off",
                                (draft, e_got, tap_s.table()),
                                ("off", ref, tap_b.table()), phase="spec")
        check(sorted(e_got) == list(range(8)) and all(
            len(t) == 16 for t in e_got.values()),
            f"{what}: 8 requests of 16 tokens")
        check(rep["near_ties"], f"{what}: a divergence from the spec-off "
              "engine that is not a near-tie flip")
        check(k4_rows.rows.get(VERIFY_ROWS, 0) > 0
              and e_launches["K4"] == cfg.n_layers * e.steps,
              f"{what}: K4 launches {k4_rows.rows} in {e.steps} steps")
        check(k3_rows.get(VERIFY_ROWS, 0) > 0 and sum(k3_rows.values())
              == e_launches["K3"], f"{what}: K3 launches by rows {k3_rows}")
        for x in (e,) if graph is None else (e, eng):
            check(x.pool.conserved() and x.pool.pages_in_use
                  == x.radix.evictable_pages(),
                  f"{what}: scratch pages not released or the pool not "
                  "conserved")
            check(not bool(x.state.cache.layers[0].pt.any()),
                  f"{what}: page tables not all-trash after the drain")
        del e
        if draft == "replay":
            check(st["spec_accepted"] > 0, f"{what}: no draft accepted")
            continue
        warm: list = []
        hold_warm(what, eng, lambda: _drive(
            torch, eng, _motif_requests(cfg, seed, 8, 16), steps=warm))
        step_times(f"{what} warm drains (replays; 20-row verify steps)",
                   warm)
        del eng

    # The target as its own draft: every chain should be accepted; with
    # graphs (one captured verify holds the draft's chain) against eager.
    sd_kw = dict(slots=SLOTS, max_len=MAX_LEN, seed=seed,
                 min_bucket=MIN_BUCKET, spec=SpecConfig(
                     k=SPEC_K, draft="model", draft_params=params,
                     draft_cfg=cfg))
    sd_runs = {}
    for graphs in (True, False):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        sd = Engine(params, cfg, graphs=graphs, **sd_kw)
        sd_got, sd_wall, _, sd_calls, sd_most = _drive(
            torch, sd, _motif_requests(cfg, seed, 4, SELF_DRAFT_NEW))
        sd_launches = {k: fn.launches for k, fn in counters.items()}
        what = "spec self-draft" + ("" if graphs else " (eager)")
        sd_st = _report(what, sd, sd_got, sd_wall, sd_calls, sd_most,
                        sd_launches)
        graph_note(what, sd, torch)
        print(f"{what}: acceptance {sd_st['spec_accept_rate']:.4f} "
              f"({int(sd_st['spec_accepted'])}/{int(sd_st['spec_proposed'])}"
              f"; gate >= {SELF_DRAFT_MIN}) tokens_per_step="
              f"{sd_st['new_tokens'] / max(sd.steps, 1):.3f}", flush=True)
        check(sorted(sd_got) == list(range(4)), f"{what}: 4 requests")
        check(sd_st["spec_accept_rate"] >= SELF_DRAFT_MIN,
              f"{what}: acceptance {sd_st['spec_accept_rate']}")
        sd_runs[graphs] = (snap(sd), sd_got, sd_launches)
        if graphs:
            hold_warm("spec self-draft", sd, lambda: _drive(
                torch, sd, _motif_requests(cfg, seed, 4, SELF_DRAFT_NEW)))
        del sd
        release(torch)
    hold_graphs("spec self-draft", sd_runs[True], sd_runs[False])
    return out

def train_drain(torch, step_fn, state, pipe, steps: int,
                ckpt=None, ckpt_every: int = 10**9, hw_monitor=None,
                **obs):
    """``run_loop`` from ``state`` to step ``steps``; returns the final
    state and a row per step: loss, grad norm, wall and host CPU seconds,
    K1 and K2 launches (a replay adds what its capture recorded), and with
    ``hw_monitor`` the twin's step energy (uJ) and cumulative cell
    writes. ``obs`` are run_loop's tracer, metrics registry and health
    monitor."""
    from repro_torch.kernels import timefloats_matmul as km
    from repro_torch.train.trainer import LoopConfig, run_loop

    k1w, k2w = km.timefloats_matmul_quantized, \
        km.timefloats_matmul_transposed_quantized
    seen = []

    def on_metrics(step, m):
        seen.append(dict(m, k1=k1w.launches, k2=k2w.launches,
                         cpu=time.process_time()))

    k1w.launches = k2w.launches = 0
    prev = {"k1": 0, "k2": 0, "cpu": time.process_time()}
    final, _ = run_loop(state, step_fn, pipe.batch_at, LoopConfig(
        total_steps=steps, log_every=1, ckpt_every=ckpt_every,
        ckpt_dir=ckpt), on_metrics=on_metrics, hw_monitor=hw_monitor, **obs)
    rows = []
    for m in seen:
        rows.append({"loss": m["loss"], "grad_norm": m["grad_norm"],
                     "wall_s": m["step_s"], "cpu_s": m["cpu"] - prev["cpu"],
                     "K1": m["k1"] - prev["k1"], "K2": m["k2"] - prev["k2"],
                     "hw_uj": m.get("hw_step_energy_uj"),
                     "hw_writes": m.get("hw_cum_cell_writes")})
        prev = m
    return final, rows


def print_rows(what: str, rows: list) -> None:
    for i, r in enumerate(rows):
        print(f"{what}: step {i} loss {r['loss']:.6f} grad_norm "
              f"{r['grad_norm']:.6f} wall_s {r['wall_s']:.3f} host_cpu_s "
              f"{r['cpu_s']:.3f} K1_launches {r['K1']} K2_launches "
              f"{r['K2']}", flush=True)


def snapshot(torch, state, device: str):
    """Copies of a state's parameter and optimizer leaves on ``device``,
    and its generator's state: what a later step may overwrite."""
    from repro_torch import tree as tree_lib

    copy = lambda t: t.detach().to(device, copy=True)  # noqa: E731
    return state._replace(params=tree_lib.tree_map(copy, state.params),
                          opt=tree_lib.tree_map(copy, state.opt),
                          generator=state.generator.get_state())


def same_state(torch, a, b) -> bool:
    """Step, every parameter and optimizer leaf (by its bits) and the
    generator state equal; ``b`` may be a :func:`snapshot`, on any
    device."""
    from repro_torch import tree as tree_lib

    def bits(t):
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])

    gens = [g if isinstance(g, torch.Tensor) else g.get_state()
            for g in (a.generator, b.generator)]
    return a.step == b.step and torch.equal(*gens) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(bits(x.to(y.device)), bits(y))
        for x, y in zip(tree_lib.leaves((a.params, a.opt)),
                        tree_lib.leaves((b.params, b.opt))))


def step0_gates(torch, cfg, params, batch, what: str) -> None:
    """Step 0's loss bitwise and every leaf's gradient within K2_COSINE /
    K2_MAX_REL, kernels against plain versions (not counted)."""
    from repro_torch import tree as tree_lib
    from repro_torch.kernels import dispatch
    from repro_torch.train import step as tsl

    m_k, g_k = tsl.loss_and_grads(cfg, params, batch)
    with dispatch.override(kernels=False):
        m_p, g_p = tsl.loss_and_grads(cfg, params, batch)
    cos_min, rel_max = 1.0, 0.0
    for (path, a), b in zip(tree_lib.leaves_with_path(g_k),
                            tree_lib.leaves(g_p)):
        a64, b64 = a.double().flatten(), b.double().flatten()
        cos = float(a64 @ b64 / (a64.norm() * b64.norm()).clamp_min(1e-300))
        rel = float((a64 - b64).abs().max() / b64.abs().max().clamp_min(
            1e-300))
        del a64, b64
        cos_min, rel_max = min(cos_min, cos), max(rel_max, rel)
        check(cos >= K2_COSINE and rel <= K2_MAX_REL,
              f"{what}: step-0 grad {tree_lib.path_str(path)} kernels vs "
              f"plain: cosine {cos}, max rel {rel}")
    check(torch.equal(m_k["loss"], m_p["loss"]),
          f"{what}: step-0 loss {m_k['loss'].item()} != plain "
          f"{m_p['loss'].item()}")
    print(f"{what}: step-0 grads kernels vs plain: min cosine {cos_min:.9f} "
          f"(gate {K2_COSINE}), max |diff|/max|plain| {rel_max:.3e} (gate "
          f"{K2_MAX_REL}); loss bitwise {m_k['loss'].item():.6f}",
          flush=True)


def hold_train(what: str, graph: list, eager: list, k1: int, k2: int
               ) -> None:
    """A graph drain's losses and grad norms bitwise equal to its eager
    twin's, and K1/K2 launches per step equal to ``train_launches`` in
    both."""
    for arm, rows in (("graphs", graph), ("eager", eager)):
        check(all(r["K1"] == k1 and r["K2"] == k2 for r in rows),
              f"{what} ({arm}): launches per step "
              f"{[(r['K1'], r['K2']) for r in rows]}, expected {k1} K1 and "
              f"{k2} K2")
        check(all(math.isfinite(r[k]) for r in rows
                  for k in ("loss", "grad_norm")),
              f"{what} ({arm}): non-finite metrics")
    for k in ("loss", "grad_norm"):
        check([r[k] for r in graph] == [r[k] for r in eager],
              f"{what}: graph {k} {[r[k] for r in graph]} != eager "
              f"{[r[k] for r in eager]}")


def arm_note(what: str, torch, step_fn, rows: list, peak: float) -> None:
    """Wall ms and host CPU s of a drain's steps after its first (the first
    of a graph drain is the warm-up and the capture), its graphs' warm-up
    and capture seconds and its peak device memory."""
    import statistics

    g = step_fn.graphs
    later = rows[1:] or rows
    print(f"{what}: graphs={'on' if g.capture else 'off'} "
          f"step_programs={g.counts} first step wall_s "
          f"{rows[0]['wall_s']:.3f}; later steps median wall_ms="
          f"{1e3 * statistics.median(r['wall_s'] for r in later):.1f} "
          f"host_cpu_s={statistics.median(r['cpu_s'] for r in later):.3f}; "
          f"warm_up_s={sum(g.warm_s.values()):.2f} capture_s="
          f"{sum(g.capture_s.values()):.2f}; peak_mem_GB={peak / 1e9:.2f}",
          flush=True)


def peak_reset(torch) -> None:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


INSITU_STEPS = 2               # the in-situ stochastic-rounding drains
PLAIN_STEPS = 2                # the training plain-version run


def phase_train(torch, cfg, seed: int) -> dict:
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.timefloats import TFConfig
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import sampling as ks
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train import step as tsl

    opt = dict(name="adamw", lr=3e-4, warmup=1, total_steps=TRAIN_STEPS)
    tcfg = tsl.TrainConfig(optimizer=OptimizerConfig(**opt))
    t0 = time.monotonic()
    state0 = tsl.init_state(cfg, tcfg, seed, "cuda")
    pipe = DataPipeline(cfg, TRAIN_B, TRAIN_S, seed=seed, kind="lm",
                        device="cuda")
    torch.cuda.synchronize()
    print(f"train: init {cfg.name} (remat={cfg.remat}, AdamW, batch "
          f"{TRAIN_B} x {TRAIN_S}) in {time.monotonic() - t0:.1f}s",
          flush=True)
    step0_gates(torch, cfg, state0.params, pipe.batch_at(0), "train")
    k1_step, k2_step = train_launches(cfg)
    from repro_torch.hw.schedule import HwMonitor

    t0 = time.monotonic()
    monitors = [HwMonitor.for_training(state0.params, pipe.batch_at(0), cfg)
                for _ in range(2)]   # the graph drain's and its twin's
    s = monitors[0].step_schedule
    print(f"train: hw twin in {time.monotonic() - t0:.2f}s: "
          f"{monitors[0].placement.tiles} tiles, {s.read.chunks} chunk "
          f"reads, {s.energy_pj * 1e-6:.3f} uJ/step (reads "
          f"{s.read.energy_pj * 1e-6:.3f}, writes "
          f"{s.write_energy_pj * 1e-6:.3f}), {s.cells_written} cell "
          f"writes/step", flush=True)

    # The main path: the graph drain (3 steps, checkpoints at 2 and 3),
    # traced, with a metrics registry and a health monitor.
    from repro_torch.obs import export
    from repro_torch.obs.health import HealthMonitor
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    tr, reg = Tracer(), MetricsRegistry()
    hm = HealthMonitor(tracer=tr)
    with tempfile.TemporaryDirectory() as ckpt:
        peak_reset(torch)
        ks.sample.launches = 0
        t0 = time.monotonic()
        step_g = tsl.make_train_step(cfg, tcfg)
        final, rows_g = train_drain(torch, step_g, state0, pipe, TRAIN_STEPS,
                                    ckpt=ckpt, ckpt_every=2,
                                    hw_monitor=monitors[0], tracer=tr,
                                    metrics_registry=reg, health=hm)
        wall = time.monotonic() - t0
        peak_g = torch.cuda.max_memory_allocated()
        launches = {"K1": sum(r["K1"] for r in rows_g),
                    "K2": sum(r["K2"] for r in rows_g),
                    "K3": ks.sample.launches}
        check(step_g.graphs.capture and len(step_g.graphs.counts) == 1,
              f"train: step programs {step_g.graphs.counts}")
        print_rows("train (graphs)", rows_g)
        print(f"train: {TRAIN_STEPS} steps + checkpoints in {wall:.2f}s; "
              f"launches {launches}", flush=True)
        steps = [e for e in tr.events if e.name == "train.step"]
        kinds = span_kinds(tr)
        problems = export.validate_trace(export.chrome_payload(
            tr, metadata={"hw": monitors[0].summary()}), ("train.step",))
        print("train: trace spans by kind (count, host s): " + ", ".join(
            f"{k} {n} {t:.4f}" for k, (n, t) in sorted(kinds.items()))
            + f"; train_steps {reg.get('train_steps').value:g}, "
            f"train_step_s count {reg.get('train_step_s').count}, "
            f"hw_tile_writes_max {reg.get('hw_tile_writes_max').value:g}, "
            f"hw_endurance_frac {reg.get('hw_endurance_frac').value:.3g}; "
            f"health series {sorted(hm.series)}; validate_trace "
            f"{problems or 'ok'}", flush=True)
        check(len(steps) == TRAIN_STEPS and [e.args["loss"] for e in steps]
              == [r["loss"] for r in rows_g], f"train: train.step spans "
              f"{[e.args for e in steps]}")
        check(not problems and tr.open_spans == 0 and tr.dropped == 0,
              f"train: trace problems {problems}")
        check(reg.get("train_steps").value == TRAIN_STEPS
              and reg.get("train_step_s").count == TRAIN_STEPS,
              "train: registry steps")
        check(reg.get("hw_tile_writes_max").value == TRAIN_STEPS
              and any(m.labels for m in reg.collect()
                      if m.name == "hw_tile_read_chunks"),
              "train: the per-tile wear gauges")
        check(hm.series["train.step_s"].n == TRAIN_STEPS
              and list(hm.series["hw.tile_write_rate"].ring)
              == [1.0] * TRAIN_STEPS, "train: health series")
        want = snapshot(torch, final, "cuda")
        mgr = CheckpointManager(ckpt)
        check(mgr.all_steps() == [2, TRAIN_STEPS],
              f"train: checkpoints {mgr.all_steps()}")
        t0 = time.monotonic()
        back = mgr.restore(TRAIN_STEPS, final)
        same = same_state(torch, back, want)
        print(f"train: restored step {back.step} bitwise={same} in "
              f"{time.monotonic() - t0:.1f}s", flush=True)
        check(same, "train: the final checkpoint does not restore bitwise")
        del back
        # Resume: step 2's checkpoint, copied into buffers that have moved
        # on to step 3, and one more replay. It is the shape's second
        # drain, so it captures nothing.
        cap = dict(step_g.graphs.capture_s)
        resumed, rows_r = train_drain(torch, step_g, mgr.restore(2, state0),
                                      pipe, TRAIN_STEPS)
        same = same_state(torch, resumed, want) and \
            rows_r[0]["loss"] == rows_g[-1]["loss"]
        print(f"train: resumed from step 2's checkpoint: step "
              f"{resumed.step} bitwise={same} with the uninterrupted drain; "
              f"step programs {step_g.graphs.counts}, capture_s "
              f"{step_g.graphs.capture_s}", flush=True)
        check(same, "train: the drain resumed from step 2 differs")
        check(step_g.graphs.counts == {k: 1 for k in cap}
              and step_g.graphs.capture_s == cap,
              f"train: the resumed drain captured again: "
              f"{step_g.graphs.counts}")
    check(launches["K3"] == 0 and launches["K1"] == TRAIN_STEPS * k1_step
          and launches["K2"] == TRAIN_STEPS * k2_step,
          f"train: launches {launches}, expected {k1_step} K1 and "
          f"{k2_step} K2 per step")
    arm_note("train (graphs)", torch, step_g, rows_g, peak_g)
    del step_g, final, resumed
    release(torch)

    # Its eager twin, from the same initial state.
    peak_reset(torch)
    step_e = tsl.make_train_step(cfg, tcfg, graphs=False)
    final_e, rows_e = train_drain(torch, step_e, state0, pipe, TRAIN_STEPS,
                                  hw_monitor=monitors[1])
    print_rows("train (eager)", rows_e)
    books = [m.summary() for m in monitors]
    w = monitors[0].wear
    print(f"train: hw books, graphs {[r['hw_uj'] for r in rows_g]} uJ a "
          f"step, eager {[r['hw_uj'] for r in rows_e]}; cumulative cell "
          f"writes {[r['hw_writes'] for r in rows_g]}; summary {books[0]}",
          flush=True)
    check(books[0] == books[1] and [r["hw_uj"] for r in rows_g] == [
        r["hw_uj"] for r in rows_e], "train: graph replays book other "
          "energy than eager steps")
    check(w.writes_sum * monitors[0].placement.cells_written_per_update
          == books[0]["total_cell_writes"] * w.n_tiles,
          "train: the per-tile write books are not conserved")
    arm_note("train (eager)", torch, step_e, rows_e,
             torch.cuda.max_memory_allocated())
    hold_train("train", rows_g, rows_e, k1_step, k2_step)
    same = same_state(torch, final_e, want)
    print(f"train: graph drain against its eager twin: losses, grad norms "
          f"and every parameter and optimizer leaf bitwise={same}",
          flush=True)
    check(same, "train: the graph drain's state differs from the eager one")
    del step_e, final_e, want
    release(torch)

    # In-situ E4M4 updates with stochastic rounding, graphs against eager.
    tcfg_in = tsl.TrainConfig(optimizer=OptimizerConfig(
        **opt, insitu=TFConfig(), stochastic_rounding=True))
    state_in = tsl.init_state(cfg, tcfg_in, seed, "cuda")
    arms = {}
    for graphs in (None, False):
        fn = tsl.make_train_step(cfg, tcfg_in, graphs=graphs)
        fin, rows = train_drain(torch, fn, state_in, pipe, INSITU_STEPS)
        arms[graphs] = (snapshot(torch, fin, "cuda"), rows)
        del fn, fin
        release(torch)
    (snap_g, rows_gi), (snap_e, rows_ei) = arms[None], arms[False]
    same = same_state(torch, snap_g, snap_e)
    print(f"train: in-situ E4M4 with stochastic rounding, {INSITU_STEPS} "
          f"steps: losses graphs {[r['loss'] for r in rows_gi]} eager "
          f"{[r['loss'] for r in rows_ei]}; state and generator "
          f"bitwise={same}", flush=True)
    hold_train("train in-situ", rows_gi, rows_ei, k1_step, k2_step)
    check(same, "train: in-situ graph drain differs from its eager twin")
    del arms, snap_g, snap_e, state_in
    release(torch)

    # The plain versions, eagerly (step 0 bitwise, later steps close).
    with dispatch.override(kernels=False):
        _, rows_p = train_drain(torch, tsl.make_train_step(
            cfg, tcfg, graphs=False), state0, pipe, PLAIN_STEPS)
    ref = [r["loss"] for r in rows_p]
    got = [r["loss"] for r in rows_g]
    print(f"train: plain versions' losses {ref}; kernels' {got}", flush=True)
    check(all(r["K1"] == 0 and r["K2"] == 0 for r in rows_p),
          "train: the plain run launched a kernel")
    check(got[0] == ref[0], f"train: step-0 loss {got[0]} != plain {ref[0]}")
    for i, (a, b) in enumerate(zip(got, ref)):
        check(abs(a - b) <= LOSS_RTOL * abs(b),
              f"train: step {i} loss {a} vs plain {b}")
    return launches


def device_ms(torch, fn) -> tuple[float, int]:
    """Device ms and kernel launches of one call of ``fn``, as
    ``torch.profiler`` records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in ks) / 1e3,
            sum(e.count for e in ks))


# The MLA training vehicle's optimizer: SGD without momentum. AdamW's three
# 9.75 GB trees in the step's buffers, or SGD's two with momentum, beside
# the gradients and the head's quantization temporaries (a 46 GiB pool),
# do not fit in 80 GB (PERF.md §4).
MLA_TRAIN_OPT = dict(name="sgd", momentum=0.0, lr=3e-4, warmup=1,
                     total_steps=TRAIN_STEPS)


def phase_train_mla(torch, cfg, seed: int) -> dict:
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train import step as tsl

    tcfg = tsl.TrainConfig(optimizer=OptimizerConfig(**MLA_TRAIN_OPT))
    t0 = time.monotonic()
    state = tsl.init_state(cfg, tcfg, seed, "cuda")
    pipe = DataPipeline(cfg, TRAIN_B, TRAIN_S, seed=seed, kind="lm",
                        device="cuda")
    # The initial state waits on the host: beside the step's buffers and
    # the head's quantization temporaries a second copy on the card does
    # not fit (PERF.md §4). The step-0 gates use its parameters on the card.
    state0, params = tsl.on_host(state), state.params
    del state
    release(torch)
    n_params = sum(p.numel() for p in tree_lib.leaves(params))
    print(f"train_mla: init {cfg.name} cut to {cfg.n_layers} dense layer "
          f"({n_params / 1e9:.3f}e9 parameters, remat={cfg.remat}, "
          f"{MLA_TRAIN_OPT['name']} momentum {MLA_TRAIN_OPT['momentum']}, "
          f"batch {TRAIN_B} x {TRAIN_S}) in {time.monotonic() - t0:.1f}s",
          flush=True)
    step0_gates(torch, cfg, params, pipe.batch_at(0), "train_mla")
    del params
    release(torch)
    k1_step, k2_step = train_launches(cfg)

    with tempfile.TemporaryDirectory() as ckpt:
        peak_reset(torch)
        step_g = tsl.make_train_step(cfg, tcfg)
        final, rows_g = train_drain(torch, step_g, state0, pipe, TRAIN_STEPS,
                                    ckpt=ckpt)
        peak_g = torch.cuda.max_memory_allocated()
        launches = {"K1": sum(r["K1"] for r in rows_g),
                    "K2": sum(r["K2"] for r in rows_g)}
        print_rows("train_mla (graphs)", rows_g)
        want = snapshot(torch, final, "cpu")
        dev_g = device_ms(torch, lambda: step_g(final, pipe.batch_at(3)))
        t0 = time.monotonic()
        back = CheckpointManager(ckpt).restore(TRAIN_STEPS, want._replace(
            generator=final.generator))
        same = same_state(torch, back, want)
        print(f"train_mla: restored step {back.step} bitwise={same} in "
              f"{time.monotonic() - t0:.1f}s", flush=True)
        check(same, "train_mla: the final checkpoint does not restore "
              "bitwise")
        arm_note("train_mla (graphs)", torch, step_g, rows_g, peak_g)
        del back, final, step_g
        release(torch)

    peak_reset(torch)
    step_e = tsl.make_train_step(cfg, tcfg, graphs=False)
    final_e, rows_e = train_drain(torch, step_e, state0, pipe, TRAIN_STEPS)
    peak_e = torch.cuda.max_memory_allocated()
    print_rows("train_mla (eager)", rows_e)
    hold_train("train_mla", rows_g, rows_e, k1_step, k2_step)
    same = same_state(torch, final_e, want)
    print(f"train_mla: graph drain against its eager twin: losses, grad "
          f"norms and every parameter leaf bitwise={same}", flush=True)
    check(same, "train_mla: the graph drain's state differs from the eager "
          "one")
    dev_e = device_ms(torch, lambda: step_e(final_e, pipe.batch_at(3)))
    arm_note("train_mla (eager)", torch, step_e, rows_e, peak_e)
    for arm, rows, (ms, n) in (("graphs", rows_g, dev_g),
                               ("eager", rows_e, dev_e)):
        print(f"train_mla ({arm}): a fourth step's device_ms={ms:.3f} "
              f"kernel launches {n}; the drain's later steps wall_ms "
              f"{[round(1e3 * r['wall_s'], 1) for r in rows[1:]]}",
              flush=True)
    check(launches == {"K1": TRAIN_STEPS * k1_step,
                       "K2": TRAIN_STEPS * k2_step},
          f"train_mla: launches {launches}")
    return launches


def k5_case(torch, cfg, gen, n_tab: int):
    """Decode-shape MLA operands with an ``n_tab``-page table: ragged
    lengths (an empty row, a full one, a single page, a random one) and
    trash entries past each row's extent; q_rope in bf16 as ``rope``
    returns it."""
    m = cfg.mla
    p = SLOTS * (MAX_LEN // PAGE) + 1
    h, c, r = cfg.n_heads, m.kv_lora_rank, m.qk_rope_head_dim
    q_lat = torch.randn(SLOTS, h, c, generator=gen, device="cuda") * 0.05
    q_rope = torch.randn(SLOTS, h, r, generator=gen,
                         device="cuda").bfloat16()
    cpool = torch.randn(p, PAGE, c, generator=gen, device="cuda").bfloat16()
    rpool = torch.randn(p, PAGE, r, generator=gen, device="cuda").bfloat16()
    cap = n_tab * PAGE
    rnd = int(torch.randint(1, cap + 1, (1,), generator=gen,
                            device="cuda").item())
    lens = torch.tensor([0, cap, min(PAGE, cap), rnd], dtype=torch.int32,
                        device="cuda")
    ids = torch.randperm(p - 1, generator=gen, device="cuda")[:SLOTS * n_tab]
    pt = (ids + 1).to(torch.int32).reshape(SLOTS, n_tab)
    live = (lens.to(torch.int64) + PAGE - 1) // PAGE
    pt[torch.arange(n_tab, device="cuda")[None, :] >= live[:, None]] = 0
    return q_lat, q_rope, cpool, rpool, pt, lens


def k5_small_case(torch, gen, b, t, page, h, c, r, dtype):
    """tests/test_torch_mla.py's construction on the card: f32 q_lat, bf16
    q_rope, a random permutation of page ids, trash entries past each
    row's extent, a length-0 row and a single-page row."""
    n_pages = b * t + 2
    q_lat = torch.randn(b, h, c, generator=gen, device="cuda")
    q_rope = torch.randn(b, h, r, generator=gen, device="cuda").bfloat16()
    cpool = torch.randn(n_pages, page, c, generator=gen,
                        device="cuda").to(dtype)
    rpool = torch.randn(n_pages, page, r, generator=gen,
                        device="cuda").to(dtype)
    lens = torch.randint(0, t * page + 1, (b,), generator=gen,
                         device="cuda", dtype=torch.int32)
    lens[0] = 0
    if b > 1:
        lens[1] = min(page, t * page)
    ids = torch.randperm(n_pages - 1, generator=gen, device="cuda")[:b * t]
    pt = (ids + 1).to(torch.int32).reshape(b, t)
    live = (lens.to(torch.int64) + page - 1) // page
    pt[torch.arange(t, device="cuda")[None, :] >= live[:, None]] = 0
    return q_lat, q_rope, cpool, rpool, pt, lens


def k5_hold(torch, kpa, ops, scale: float, ns: int,
            what: str) -> tuple[float, bool]:
    """K5 against its plain version (gate K5_TOL of max(1, |plain|),
    finite, length-0 rows exactly 0) and bitwise equal on two calls.
    Returns (relative error, bitwise)."""
    q_lat, q_rope, cpool, rpool, pt, lens = ops
    got = kpa.paged_decode_mla(*ops, scale=scale, n_splits=ns)
    again = kpa.paged_decode_mla(*ops, scale=scale, n_splits=ns)
    want = kpa._combine(*kpa._mla_plain(
        *ops, scale=scale, n_splits=kpa._norm_splits(
            ns, pt.shape[1], page_size=cpool.shape[1], heads=q_lat.shape[1],
            head_dim=q_lat.shape[2] + q_rope.shape[2])))
    torch.cuda.synchronize()
    err = ((got - want).abs().max()
           / want.abs().max().clamp_min(1.0)).item()
    check(err <= K5_TOL and bool(torch.isfinite(got).all())
          and bool((got[lens == 0] == 0).all()),
          f"K5 {what} n_splits={ns}: max rel {err} > {K5_TOL} or a "
          "length-0 row not exactly 0")
    check(torch.equal(got, again), f"K5 {what} n_splits={ns}: two calls "
          "differ")
    return err, torch.equal(got, want)


# tests/test_torch_mla.py's MLA_CASES (b, t, page, h, c, r, pool dtype,
# n_splits), then one whose 8-byte rope rows are not 16-byte multiples (the
# kernel stages those with loads, not cp.async), one whose H = 20 is not a
# multiple of the 16 heads a block, and one with an odd latent width (q
# loaded element by element, outputs stored singly).
K5_SMALL = ((2, 4, 8, 4, 32, 16, "float32", 2),
            (3, 2, 16, 1, 64, 16, "bfloat16", 1),
            (2, 8, 4, 8, 16, 8, "bfloat16", 8),
            (1, 1, 4, 2, 8, 8, "float32", 1),
            (4, 4, 8, 16, 32, 16, "bfloat16", 4),
            (3, 4, 8, 1, 32, 8, "float32", 2),
            (2, 2, 16, 4, 16, 16, "bfloat16", 2),
            (2, 4, 8, 3, 24, 4, "bfloat16", 2),
            (3, 4, 16, 20, 64, 16, "bfloat16", 4),
            (2, 4, 8, 3, 15, 8, "float32", 2))
# The earlier two-kernel K5 (split kernel + combine kernel) at the 8-page
# cap, per launch, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
K5_TWO_KERNEL_MS = "0.0730-0.0736"


def phase_k5(torch, cfg, seed: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import paged as kp
    from repro_torch.kernels import paged_attn as kpa

    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    m = cfg.mla
    h, c, r = cfg.n_heads, m.kv_lora_rank, m.qk_rope_head_dim
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    times = {ns: 0.0 for ns in K4_SPLITS}
    worst, exact, cases, lib_by_cap = 0.0, True, {}, {}

    def library(ops, gqa: bool = False):
        """The same gathers, then one scaled_dot_product_attention: the H
        heads as query rows against one kv head (q (B,1,H,C+R), k
        (B,1,J,C+R), v = c_kv (B,1,J,C), a (B,1,1,J) length mask). With
        ``gqa`` the earlier composition instead: H heads of one query row
        with ``enable_gqa=True``, which expands the kv head H-fold."""
        q_lat, q_rope, cpool, rpool, pt, lens = ops
        rows, s_len = pt.shape[0], pt.shape[1] * PAGE
        mask = (torch.arange(s_len, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        q = torch.cat([q_lat, q_rope.float()], dim=-1)
        q = q[:, :, None, :] if gqa else q[:, None]

        def run():
            ck = cpool[pt].reshape(rows, 1, s_len, c).float()
            kr = rpool[pt].reshape(rows, 1, s_len, r).float()
            return F.scaled_dot_product_attention(
                q, torch.cat([ck, kr], dim=-1), ck, attn_mask=mask,
                scale=scale, enable_gqa=gqa)
        return run

    for n_tab in K4_CAPS:
        ops = k5_case(torch, cfg, gen, n_tab)
        lens = ops[-1]
        for ns in K4_SPLITS:
            err, same = k5_hold(torch, kpa, ops, scale, ns, f"cap={n_tab}")
            worst, exact = max(worst, err), exact and same
        if n_tab == 32:  # a covering prefix is neutral at one split
            short = lens.clamp_max(8 * PAGE)
            full = kpa.paged_decode_mla(*ops[:5], short, scale=scale,
                                        n_splits=1)
            capped = kpa.paged_decode_mla(*ops[:4], ops[4][:, :8], short,
                                          scale=scale, n_splits=1)
            torch.cuda.synchronize()
            check(torch.equal(full, capped), "K5: an 8-page prefix of a "
                  "32-page table changes the output")
            # K6 on the MLA pools (the paged prefill's gathers).
            for pool in ops[2:4]:
                check(torch.equal(kp.gather_pages(pool, ops[4]).view(
                    torch.int16), kp.gather_pages_plain(pool, ops[4]).view(
                    torch.int16)), f"K6 on an MLA pool {tuple(pool.shape)}")
        row = []
        for ns in K4_SPLITS:
            t = time_ms(torch, lambda: kpa.paged_decode_mla(
                *ops, scale=scale, n_splits=ns), reps=50)
            times[ns] += t
            row.append(f"{ns}:{t:.4f}")
        lib_by_cap[n_tab] = time_ms(torch, library(ops), reps=50)
        print(f"K5 cap={n_tab:2d} pages lengths={lens.tolist()} ms by "
              f"n_splits {' '.join(row)}; library_ms(gathers + one sdpa, "
              f"heads as query rows)={lib_by_cap[n_tab]:.4f}", flush=True)
        cases[n_tab] = ops
    ns_best = min(K4_SPLITS, key=lambda n: times[n])
    for shape in K5_SMALL:
        b, t, page, hs, cs, rs, dtype, ns = shape
        ops = k5_small_case(torch, gen, b, t, page, hs, cs, rs,
                            getattr(torch, dtype))
        err, same = k5_hold(torch, kpa, ops, 1.0 / math.sqrt(cs // 2 + rs),
                            ns, f"shape={shape}")
        worst, exact = max(worst, err), exact and same
    print(f"K5 n_splits winner over caps {K4_CAPS}: {ns_best} (key "
          f"p{PAGE}_h{h}_d{c + r}_r{SLOTS}); bitwise={exact} max "
          f"|diff|/max(1,|plain|) {worst:.3e} (tolerance {K5_TOL}) at caps "
          f"{K4_CAPS} x n_splits {K4_SPLITS} and {len(K5_SMALL)} small "
          "shapes; two calls equal; K6 bitwise on the MLA pools",
          flush=True)

    # Each cap at the winner beside the library call.
    faster = True
    for n_tab, ops in cases.items():
        ns = kpa._norm_splits(ns_best, n_tab, page_size=PAGE, heads=h,
                              head_dim=c + r)
        t = time_ms(torch, lambda: kpa.paged_decode_mla(
            *ops, scale=scale, n_splits=ns), reps=50)
        faster = faster and t < lib_by_cap[n_tab]
        print(f"K5 cap={n_tab:2d} n_splits={ns} ms={t:.4f} library_ms="
              f"{lib_by_cap[n_tab]:.4f} ({lib_by_cap[n_tab] / t:.2f}x)",
              flush=True)

    check(faster, "K5: slower than the library call at a cap (4 rows)")
    rec = cases[8]   # the paged drain's usual cap
    q_lat, q_rope, cpool, rpool, pt, lens = rec
    one_launch(torch, lambda: kpa.paged_decode_mla(
        *rec, scale=scale, n_splits=ns_best), "K5")

    ms = time_ms(torch, lambda: kpa.paged_decode_mla(
        *rec, scale=scale, n_splits=ns_best), reps=50)
    plain = time_ms(torch, lambda: kpa._combine(*kpa._mla_plain(
        *rec, scale=scale, n_splits=ns_best)), reps=10)
    lib = time_ms(torch, library(rec), reps=50)
    lib_gqa = time_ms(torch, library(rec, gqa=True), reps=20)
    # The library call computes the same function: held on the live rows.
    want = kpa._combine(*kpa._mla_plain(*rec, scale=scale,
                                        n_splits=ns_best))
    got = library(rec)()[:, 0]
    lib_err = (got - want)[lens > 0].abs().max().item()
    live = int(lens.sum().item())
    nbytes = (live * (c + r) * cpool.element_size() + q_lat.numel() * 4
              + q_rope.numel() * 2 + SLOTS * h * c * 4 + pt.numel() * 4
              + SLOTS * 4)
    b_ms, b_by = bound(nbytes, 2.0 * h * live * (c + r + c),
                       F32_FLOPS_PER_S)
    verify_pattern(torch, "K5", h, c + r, gen,
        lambda pt, lens: (
            torch.randn(VERIFY_ROWS, h, c, generator=gen,
                        device="cuda") * 0.05,
            torch.randn(VERIFY_ROWS, h, r, generator=gen,
                        device="cuda").bfloat16(), cpool, rpool, pt, lens),
        hold=lambda ops, ns, what: k5_hold(torch, kpa, ops, scale, ns, what),
        call=lambda ops, ns: kpa.paged_decode_mla(*ops, scale=scale,
                                                  n_splits=ns),
        plain=lambda ops, ns: kpa._combine(*kpa._mla_plain(
            *ops, scale=scale, n_splits=ns)),
        library=library, n_pages=cpool.shape[0], faster=True,
        live_bytes=lambda ops, live: (
            live * (c + r) * cpool.element_size() + ops[0].numel() * 4
            + ops[1].numel() * 2 + VERIFY_ROWS * h * c * 4
            + ops[4].numel() * 4 + VERIFY_ROWS * 4,
            2.0 * h * int(ops[5].sum().item()) * (c + r + c),
            F32_FLOPS_PER_S))
    per = cfg.n_layers
    print(f"K5 cap=8 pages n_splits={ns_best} live_positions={live} "
          f"KiB_moved={nbytes / 1024:.1f} ms={ms:.4f} (two-kernel design: "
          f"{K5_TWO_KERNEL_MS}) plain_ms={plain:.4f} library_ms(gathers + "
          f"one sdpa, heads as query rows; max |diff| to plain "
          f"{lib_err:.2e})={lib:.4f} bound_ms={b_ms:.5f} ({b_by}) "
          f"share_of_bound={b_ms / ms:.4f} launches_per_decode_step={per}; "
          f"per decode step ms={per * ms:.4f} plain_ms={per * plain:.4f} "
          f"library_ms={per * lib:.4f} bound_ms={per * b_ms:.5f}; faster "
          f"than the library at every cap: {faster}", flush=True)
    print(f"K5 information only: the earlier library composition (one "
          f"query row of H heads, enable_gqa=True, the kv head expanded "
          f"{h}-fold) library_ms={lib_gqa:.4f}, per decode step "
          f"{per * lib_gqa:.4f}", flush=True)
    return {"name": f"K5 paged_decode_mla (one decode step: {per} "
                    "launches, 8-page cap)",
            "route": "cuda", "source": "src/repro_torch/csrc/paged_attn_mla.cu",
            "replaces": "src/repro/kernels/paged_attn.py:288",
            "max_abs_err": worst, "ms": per * ms, "plain_ms": per * plain,
            "bound_ms": per * b_ms, "bound_by": b_by,
            "library_ms": per * lib}


def mla_k1_shapes(cfg) -> dict:
    """(K, N) of every dense call of an MLA decode step and its count:
    wq_a, wq_b, wkv_a and wo (dense_in) of the mixer, gate, up and down of
    the MLP, then the untied head. wkv_b is read by f32 einsums."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    f = cfg.moe.dense_d_ff
    per_layer = [(d, m.q_lora_rank),
                 (m.q_lora_rank, h * (m.qk_nope_head_dim
                                      + m.qk_rope_head_dim)),
                 (d, m.kv_lora_rank + m.qk_rope_head_dim),
                 (h * m.v_head_dim, d), (d, f), (d, f), (f, d)]
    shapes: dict = {}
    for kn in per_layer:
        shapes[kn] = shapes.get(kn, 0) + cfg.n_layers
    shapes[(d, cfg.vocab_size)] = 1
    return shapes


def absorption_probe(torch, params, cfg, gen) -> None:
    """MLA's absorption products at a chain verify's 20 rows against the
    same rows computed 4 at a time (a decode step's), as float32 einsums
    (the port's earlier form) and as the float64 sums it runs now: mismatched
    elements of q_lat and of the up-projection, twice each (the second
    pass after other work has moved the allocator). The float64 sums are
    gated bitwise."""
    from repro_torch.models import mla

    m = cfg.mla
    wkv_b = params["layers"][0]["mixer"]["wkv_b"]
    wk_b = wkv_b[..., :m.qk_nope_head_dim]
    wv_b = wkv_b[..., m.qk_nope_head_dim:]
    s = SPEC_K + 1
    q = torch.randn(SLOTS, s, cfg.n_heads, m.qk_nope_head_dim,
                    generator=gen, device="cuda").bfloat16()
    o = torch.randn(SLOTS, s, cfg.n_heads, m.kv_lora_rank, generator=gen,
                    device="cuda") * 0.05
    forms = {
        "float32 einsum": (
            lambda x: torch.einsum("bshn,chn->bshc", x.float(), wk_b.float()),
            lambda y: torch.einsum("bshc,chv->bshv", y, wv_b.float())),
        "float64 sums": (
            lambda x: mla.absorb_query(x, wk_b),
            lambda y: mla._exact_einsum("bshc,chv->bshv", y, wv_b.float()))}
    for name, (absorb, up) in forms.items():
        counts = []
        for _ in range(2):
            for f, x in ((absorb, q), (up, o)):
                whole = f(x)
                cols = torch.cat([f(x[:, j:j + 1]) for j in range(s)], 1)
                counts.append(int((whole != cols).sum().item()))
            pad = torch.empty(int(1e7) + 37, device="cuda")  # move the heap
        del pad
        print(f"mla: absorption probe ({name}): {SLOTS * s} rows against "
              f"{SLOTS}-row columns, mismatched elements of q_lat and of the "
              f"up-projection {counts[:2]}, again {counts[2:]} (of "
              f"{q.shape[:3].numel() * m.kv_lora_rank} and "
              f"{q.shape[:3].numel() * m.v_head_dim})", flush=True)
    check(counts == [0, 0, 0, 0], "mla: the float64 absorption sums depend "
          "on the rows a call carries")


def _mla_dense_requests(cfg, seed: int):
    """4 requests of 5-60 tokens, 8 new tokens each, uid 2 at temperature
    0.8."""
    import numpy as np

    from repro_torch.serve.request import Request

    rng = np.random.default_rng(seed + 7)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, 4)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=DENSE_NEW,
                    temperature=0.8 if i == 2 else 0.0)
            for i, n in enumerate(lens)]


def phase_mla(torch, cfg, seed: int) -> dict:
    from repro_torch import random as rnd
    from repro_torch import tree as tree_lib
    from repro_torch.core import timefloats as tf
    from repro_torch.kernels import _build, dispatch, ops
    from repro_torch.kernels import paged as kp
    from repro_torch.kernels import paged_attn as kpa
    from repro_torch.kernels import sampling as ks
    from repro_torch.kernels import timefloats_matmul as km
    from repro_torch.models import model
    from repro_torch.serve.engine import Engine

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in tree_lib.leaves(params))
    print(f"mla: init {cfg.name} ({cfg.n_layers} dense layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, FFN {cfg.moe.dense_d_ff}, "
          f"vocab {cfg.vocab_size}, {n_par / 1e9:.3f}e9 parameters) in "
          f"{time.monotonic() - t_phase:.1f}s; peak_mem_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)

    # K1 at every decode-step shape (bitwise, timed), K3 at this vocab with
    # threefry noise.
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    sms = _build.sm_count("cuda")
    cfgs = {None: cfg.tf, 4: dataclasses.replace(cfg.tf, adc_bits=4,
                                                 adc_mode="fixed")}
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "ops": 0.0}
    worst = 0.0
    for (k, n), count in mla_k1_shapes(cfg).items():
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        x = torch.randn(SLOTS, k, generator=gen, device="cuda").bfloat16()
        qx = tf.quantize_input(tf._pow2_prescale(x, cfg.tf)[0], cfg.tf)
        qw = tf.quantize_weight(tf._pow2_prescale(w, cfg.tf)[0], cfg.tf)
        a = ops.padded_operands(qx, qw)
        c, mp, np_ = a[0].shape[0], a[0].shape[1], a[2].shape[2]
        rule = km.k1_plan(mp, c, np_, sms)
        alts = k1_alternatives(km, mp, c, np_, rule)
        worst = max(worst, k1_hold(torch, km, a, cfgs, f"MLA decode M={SLOTS}"
                                   f" K={k} N={n}", alts[1:]))
        ms = time_ms(torch, lambda: km.timefloats_matmul_quantized(
            *a, cfg=cfg.tf), reps=10)
        plain = time_ms(torch, lambda: km.timefloats_matmul_plain(
            *a, cfg.tf), reps=2, warmup=1)
        lib = time_ms(torch, lambda: tf.dequantize_input(qx, k)
                      @ tf.dequantize_weight(qw, k), reps=5, warmup=1)
        sweep = {p: time_ms(torch, lambda: km.timefloats_matmul_quantized(
            *a, cfg=cfg.tf, plan=p), reps=10) for p in alts}
        nbytes, nops = k1_traffic(c, SLOTS, n)
        b_ms, b_by = bound(nbytes, nops)
        print(f"mla: K1 decode M={SLOTS} K={k:5d} N={n:6d} bitwise=True (adc "
              f"None and 4, two calls) plan={tuple(rule)} ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} bound_ms="
              f"{b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.4f} "
              f"launches_per_step={count}; ms by plan " + " ".join(
                  f"{tuple(p)}:{t:.4f}" for p, t in sweep.items()),
              flush=True)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bytes", nbytes), ("ops", nops)):
            tot[key] += count * v
        del w, qw, a
    b_ms, b_by = bound(tot["bytes"], tot["ops"])
    n_calls = sum(mla_k1_shapes(cfg).values())
    print(f"mla: K1 per decode step ({n_calls} launches): ms={tot['ms']:.4f} "
          f"plain_ms={tot['plain_ms']:.4f} library_ms={tot['library_ms']:.4f}"
          f" bound_ms={b_ms:.4f} ({b_by}) share_of_bound="
          f"{b_ms / tot['ms']:.4f}", flush=True)
    k1_rec = {"name": f"K1 timefloats_matmul (one {cfg.name} "
                      f"{cfg.n_layers}-layer decode step)",
              "route": "cuda",
              "source": "src/repro_torch/csrc/timefloats_matmul.cu",
              "replaces": "src/repro/kernels/timefloats_matmul.py:47",
              "max_abs_err": worst, "ms": tot["ms"],
              "plain_ms": tot["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": tot["library_ms"]}
    lg = torch.randn(SLOTS, cfg.vocab_size, generator=gen, device="cuda")
    temps = torch.tensor([0.0, 0.8, 1.0, 0.0], device="cuda")
    keys = ks._fold3(rnd.PRNGKey(seed, "cuda"), torch.arange(
        SLOTS, device="cuda"), torch.arange(SLOTS, device="cuda"),
        torch.ones(SLOTS, dtype=torch.int32, device="cuda"))
    noise = rnd.gumbel(keys, (cfg.vocab_size,))
    check(torch.equal(ks.sample(lg, noise, temps),
                      ks.sample_plain(lg, noise, temps)),
          f"K3 at V={cfg.vocab_size}: kernel != plain")
    torch.cuda.synchronize()
    print(f"mla: K3 bitwise at V={cfg.vocab_size} with threefry noise",
          flush=True)

    absorption_probe(torch, params, cfg, gen)
    counters = {"K1": km.timefloats_matmul_quantized, "K3": ks.sample,
                "K4": kpa.paged_decode_attention, "K5": kpa.paged_decode_mla,
                "K6": kp.gather_pages}
    waves = [0]

    def count_waves(e):
        wave = e._prefill_wave

        def counted(*a, **kw):
            waves[0] += 1
            return wave(*a, **kw)
        e._prefill_wave = counted

    def reset():
        waves[0] = 0
        for fn in counters.values():
            fn.launches = 0

    def launched():
        return {k: fn.launches for k, fn in counters.items()}

    # The K1 timings above left the head's quantization temporaries cached
    # in the allocator's default pool, where the engine's graph pool
    # cannot reuse them.
    release(torch)
    reset()
    torch.cuda.reset_peak_memory_stats()
    eng, streams, wall, cpu = _paged_drain(torch, params, cfg, seed,
                                           setup=count_waves)
    launches, n_waves = launched(), waves[0]
    graph_note("mla paged", eng, torch)
    st = eng.stats()
    new = int(st["new_tokens"])
    print(f"mla paged: drained {int(st['finished'])} requests, {new} tokens "
          f"in {wall:.2f}s: tok/s={new / wall:.2f} "
          f"wall_ms_per_step={1e3 * wall / eng.steps:.1f} "
          f"host_cpu_ms_per_step={1e3 * cpu / eng.steps:.1f} "
          f"host_cpu_share={cpu / wall:.3f} "
          f"ttft_p50_s={st['ttft_p50_s']:.4f} steps={eng.steps} "
          f"prefill_waves={n_waves} host_transfers={eng.host_transfers} "
          f"launches={launches} peak_mem_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    print("mla paged: " + " ".join(f"{k}={st[k]:g}" for k in (
        "radix_hits", "radix_hit_rate", "radix_nodes", "radix_evictions",
        "pool_pages_total", "pool_pages_in_use", "pool_pages_free")),
        flush=True)
    layers = cfg.n_layers
    check(sorted(streams) == list(range(8))
          and all(len(t) == 16 for t in streams.values()),
          "mla paged: 8 requests of 16 tokens")
    check(launches["K5"] == layers * eng.steps and launches["K4"] == 0,
          f"mla paged: {launches['K5']} K5 launches in {eng.steps} steps")
    check(n_waves > 0 and launches["K6"] == 2 * layers * n_waves,
          f"mla paged: {launches['K6']} K6 launches in {n_waves} waves")
    check(launches["K1"] > 0 and launches["K3"] > 0,
          f"mla paged: launches {launches}")
    check(st["radix_hits"] >= 1, "mla paged: no radix hit")
    check(eng.pool.conserved(), "mla paged: pool not conserved")
    check(not bool(eng.state.cache.layers[0].pt.any()),
          "mla paged: page tables not all-trash after the drain")
    g_eng, k_steps = (snap(eng), streams, launches), eng.steps
    hold_warm("mla paged", eng, lambda: _paged_drain(torch, params, cfg,
                                                     seed, eng=eng))
    # One engine's graphs at a time: their shared pool holds the head's
    # quantization temporaries, as large as an eager step's.
    del eng
    release(torch)
    reset()
    torch.cuda.reset_peak_memory_stats()
    with LogitTap() as tap_k:   # the kernel drain's logits, on its twin
        e_eng, e_streams, e_wall, _ = _paged_drain(torch, params, cfg, seed,
                                                   graphs=False)
    print(f"mla paged: eager drain in {e_wall:.2f}s: wall_ms_per_step="
          f"{1e3 * e_wall / e_eng.steps:.1f} peak_mem_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    hold_graphs("mla paged", g_eng, (snap(e_eng), e_streams, launched()))
    del e_eng, g_eng
    reset()
    with dispatch.override(kernels=False):
        ref_eng, ref, ref_wall, _ = _paged_drain(torch, params, cfg, seed,
                                                 graphs=False)
    plain_launches = launched()
    same = sorted(u for u in streams if u in ref and streams[u] == ref[u])
    firsts = sorted(streams) == sorted(ref) and all(
        streams[u][0] == ref[u][0] for u in streams)
    print(f"mla paged: reference drain (plain versions) in {ref_wall:.2f}s;"
          f" identical streams {len(same)}/8 (gate >= {PAGED_MIN_SAME}); "
          f"identical first tokens {firsts}", flush=True)
    for u in sorted(set(streams) - set(same)):
        step = next((i for i, (a, b) in enumerate(zip(streams[u],
                                                      ref.get(u, [])))
                     if a != b), None)
        print(f"mla paged: uid {u} first differs at token {step}",
              flush=True)
    check(firsts, "mla paged: first tokens differ between kernels and plain")
    check(len(same) >= PAGED_MIN_SAME, f"mla paged: only {len(same)}/8 "
          "streams identical")
    check(ref_eng.pool.conserved(), "mla paged: plain drain's pool")
    check(all(v == 0 for v in plain_launches.values()),
          f"mla paged: the plain drain launched {plain_launches}")
    del ref_eng
    release(torch)

    # The same requests, speculative (ngram, SPEC_K) and chunked together,
    # against the kernel drain above, with graphs and then eagerly.
    from repro_torch.serve.spec import SpecConfig

    sc_kw = dict(spec=SpecConfig(k=SPEC_K), chunk_tokens=MLA_CHUNK)
    reset()
    torch.cuda.reset_peak_memory_stats()
    sc_eng, sc, sc_wall, _ = _paged_drain(torch, params, cfg, seed, **sc_kw)
    sc_launches = launched()
    sc_st = sc_eng.stats()
    graph_note("mla spec+chunked", sc_eng, torch)
    print(f"mla spec+chunked: drained {int(sc_st['finished'])} requests in "
          f"{sc_wall:.2f}s: tok/s={sc_st['new_tokens'] / sc_wall:.2f} "
          f"steps={sc_eng.steps} (kernel drain {k_steps}) "
          f"chunk_waves={sc_eng.chunk_waves} accepted "
          f"{int(sc_st['spec_accepted'])} of {int(sc_st['spec_proposed'])} "
          f"drafts; launches={sc_launches}; peak_mem_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}; streams digest "
          f"{digest(sc)}", flush=True)
    check(sorted(sc) == list(range(8)) and all(
        len(t) == 16 for t in sc.values()),
        "mla spec+chunked: 8 requests of 16 tokens")
    check(sc_launches["K5"] == layers * sc_eng.steps,
          f"mla spec+chunked: {sc_launches['K5']} K5 launches in "
          f"{sc_eng.steps} steps")
    check(sc_eng.chunk_waves > 0, "mla spec+chunked: no chunk wave")
    check(sc_eng.pool.conserved() and sc_eng.pool.pages_in_use
          == sc_eng.radix.evictable_pages(),
          "mla spec+chunked: pool not conserved")
    check(torch.cuda.max_memory_allocated() < 80e9,
          "mla spec+chunked: peak device memory >= 80 GB")
    g_sc = (snap(sc_eng), sc, sc_launches)
    hold_warm("mla spec+chunked", sc_eng, lambda: _paged_drain(
        torch, params, cfg, seed, eng=sc_eng))
    del sc_eng
    release(torch)
    # Its eager twin, drained after every other drain of this phase: the
    # graph drain's gate (identical streams), and the logits and K5
    # launches by rows of the spec+chunked streams.
    reset()
    with LogitTap() as tap_sc, RowCount(kpa, "_mla_kernel") as k5_rows:
        e_sc_eng, e_sc, e_sc_wall, _ = _paged_drain(
            torch, params, cfg, seed, graphs=False, **sc_kw)
    print(f"mla spec+chunked: eager drain in {e_sc_wall:.2f}s; K5 launches "
          f"by rows {k5_rows.rows}", flush=True)
    hold_graphs("mla spec+chunked", g_sc, (snap(e_sc_eng), e_sc,
                                           launched()))
    check(k5_rows.rows.get(VERIFY_ROWS, 0) > 0
          and sum(k5_rows.rows.values()) == layers * e_sc_eng.steps,
          f"mla spec+chunked: K5 launches {k5_rows.rows} in "
          f"{e_sc_eng.steps} steps")
    rep_sc = divergence_report("spec+chunked vs the kernel drain",
                               ("spec+chunked", e_sc, tap_sc.table()),
                               ("kernels", streams, tap_k.table()),
                               phase="mla", first_ok=True)
    check(rep_sc["near_ties"], "mla spec+chunked: a divergence from the "
          "kernel drain that is not a near-tie flip")
    check(rep_sc["same"] >= MLA_SPEC_CHUNKED_SAME,
          f"mla spec+chunked: {rep_sc['same']}/8 streams equal the kernel "
          f"drain's (gate >= {MLA_SPEC_CHUNKED_SAME})")
    del e_sc_eng, g_sc
    release(torch)

    def dense_drain(**kw):
        e = Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN, seed=seed,
                   min_bucket=MIN_BUCKET, **kw)
        for req in _mla_dense_requests(cfg, seed):
            e.submit(req)
        t0 = time.monotonic()
        out = {f.uid: [int(t) for t in f.tokens]
               for f in e.run_until_drained()}
        torch.cuda.synchronize()
        return e, out, time.monotonic() - t0

    reset()
    d_eng, dense, d_wall = dense_drain()
    d_launches = launched()
    graph_note("mla dense", d_eng, torch)
    del d_eng
    release(torch)
    with dispatch.override(kernels=False):
        _, d_ref, d_ref_wall = dense_drain(graphs=False)
    print(f"mla dense: drained 4 requests ({DENSE_NEW} new tokens, uid 2 "
          f"at temperature 0.8) in {d_wall:.2f}s, launches={d_launches}; "
          f"plain versions in {d_ref_wall:.2f}s; streams identical="
          f"{dense == d_ref}; peak_mem_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    check(sorted(dense) == list(range(4))
          and all(len(t) == DENSE_NEW for t in dense.values()),
          "mla dense: 4 requests of 8 tokens")
    check(dense == d_ref, "mla dense: kernel and plain drains differ")
    check(d_launches["K1"] > 0 and d_launches["K3"] > 0
          and d_launches["K5"] == 0, f"mla dense: launches {d_launches}")
    print(f"mla: phase in {time.monotonic() - t_phase:.1f}s", flush=True)
    return launches, k1_rec


# The MoE vehicle: deepseek-v3 cut in depth to its three dense layers and
# its first MoE layer (256 routed experts, top-8, one shared expert), every
# published width, parameters in bf16 as the reference sets them at this
# scale (15.11e9 parameters: 30.2 GB).
MOE_LAYERS = 4
MOE_NEW = 8                    # new tokens per request of the MoE drains


def _moe_requests(cfg, seed: int):
    """4 greedy requests of 5-60 tokens, ``MOE_NEW`` new tokens each."""
    import numpy as np

    from repro_torch.serve.request import Request

    rng = np.random.default_rng(seed + 11)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, SLOTS)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=MOE_NEW)
            for i, n in enumerate(lens)]


def _moe_drain(torch, params, cfg, seed: int, eng=None, drafts=None,
               **engine_kw):
    """Drain the MoE requests through a new paged engine, or ``eng``;
    a speculative engine's drafts replay ``drafts`` (uid -> stream)."""
    from repro_torch.serve.engine import Engine

    if eng is None:
        eng = Engine(params, cfg, slots=SLOTS, max_len=MAX_LEN, seed=seed,
                     paged=True, page_size=PAGE, min_bucket=MIN_BUCKET,
                     **engine_kw)
    if drafts is not None:
        replay_drafts(eng, drafts)
    for r in _moe_requests(cfg, seed):
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    return eng, {f.uid: [int(t) for t in f.tokens] for f in done}, \
        time.monotonic() - t0


class MoeTap:
    """Records, while entered, every MoE dispatch that routes all of its
    tokens (a decode step's, token_mask None; or a verify's, drop-free):
    (tokens, drop_free, dropped_frac). It reads the device, so it runs on
    eager drains only (a capture while it is entered fails the smoke)."""

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.mod, self.calls = moe, []
        real = self.real = moe._moe_tokens

        def tapped(params, xf, cfg, token_mask=None, drop_free=False):
            y, aux = real(params, xf, cfg, token_mask=token_mask,
                          drop_free=drop_free)
            if token_mask is None:
                check(not torch.cuda.is_current_stream_capturing(),
                      "MoeTap on a graph drain")
                self.calls.append((xf.shape[0], drop_free,
                                   float(aux["dropped_frac"])))
            return y, aux

        moe._moe_tokens = tapped
        return self

    def __exit__(self, *exc):
        self.mod._moe_tokens = self.real

    def hold(self, what: str, k: int, verify: bool) -> None:
        """No assignment dropped at decode or verify, and some seen at
        the verify (``verify``: a speculative drain, every step a verify)
        or at decode: kept assignments equal tokens x top_k."""
        dec = [c for c in self.calls if not c[1]]
        ver = [c for c in self.calls if c[1]]
        kept = sum(t * k - round(df * t * k) for t, _, df in self.calls)
        print(f"{what}: MoE dispatches at decode {len(dec)} (tokens "
              f"{sorted({c[0] for c in dec})}), at verify {len(ver)} "
              f"(tokens {sorted({c[0] for c in ver})}); dropped_frac max "
              f"{max((c[2] for c in self.calls), default=0.0)}; kept "
              f"assignments {kept} of {sum(t * k for t, _, _ in self.calls)}",
              flush=True)
        check(bool(ver) if verify else bool(dec), f"{what}: no MoE "
              f"dispatch seen at {'verify' if verify else 'decode'}")
        check(all(df == 0.0 for _, _, df in self.calls),
              f"{what}: an assignment dropped at decode or verify")


def moe_k1(torch, cfg, params, gen) -> dict:
    """K1 over a group of experts at the MoE layer's shapes (wg, wu, wd at
    the decode capacity, a 4 x 64-token prefill's and a chain verify's),
    bitwise against its plain version and, expert by expert, against the
    2-D launch; timed at the decode capacity. Returns the kernels' record
    of one decode step's expert launches."""
    from repro_torch.core import timefloats as tf
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import timefloats_matmul as km
    from repro_torch.models import moe

    mo = cfg.moe
    lp = params["layers"][mo.first_k_dense]["ffn"]
    # A verify routes drop-free: each expert's capacity is its token count.
    caps = {"decode": moe.capacity(SLOTS, cfg),
            "prefill": moe.capacity(SLOTS * MIN_BUCKET, cfg),
            "verify": VERIFY_ROWS}
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "ops": 0.0}
    launches = 0
    for name in ("wg", "wu", "wd"):
        w = lp[name]
        e_dim, k, n = w.shape
        groups = tf.expert_groups(e_dim, k, n)
        g = groups[0]
        pw = tf.prepare_weight_experts(w[g], cfg.tf)
        for what, m in caps.items():
            x = (torch.randn(g.stop - g.start, m, k, generator=gen,
                             device="cuda") * 0.5).bfloat16()
            px = tf.prepare_input_experts(x, cfg.tf)
            a = ops.padded_expert_operands(px.q, pw.q)
            qx, sx, qw, sw = a
            got = km.timefloats_matmul_experts(*a, cfg=cfg.tf)
            again = km.timefloats_matmul_experts(*a, cfg=cfg.tf)
            want = km.timefloats_matmul_experts_plain(*a, cfg.tf)
            flat = torch.stack([km.timefloats_matmul_quantized(
                qx[e], sx[e], qw[e], sw[e], cfg=cfg.tf)
                for e in range(qx.shape[0])])
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K1 experts {name} {what} M={m}: "
                  "kernel != plain")
            check(torch.equal(got, again) and torch.equal(got, flat),
                  f"K1 experts {name} {what}: two calls or the 2-D launches "
                  "differ")
            c, mp = qx.shape[1], qx.shape[2]
            plan = km.k1_plan(mp, c, n, _build.sm_count("cuda"),
                              experts=qx.shape[0])
            if what != "decode":
                print(f"moe: K1 experts {name} {what} M={m} (group of "
                      f"{qx.shape[0]}) bitwise against plain and the 2-D "
                      f"launches, plan={tuple(plan)}", flush=True)
                continue
            ms = time_ms(torch, lambda: km.timefloats_matmul_experts(
                *a, cfg=cfg.tf), reps=10)
            plain = time_ms(torch, lambda: km.timefloats_matmul_experts_plain(
                *a, cfg.tf), reps=2, warmup=1)
            lib = time_ms(torch, lambda: tf.dequantize_input(px.q, k)
                          @ tf.dequantize_weight(pw.q, k), reps=5, warmup=1)
            nb, no = k1_traffic(c, m, n)
            nb, no = nb * qx.shape[0], no * qx.shape[0]
            b_ms, b_by = bound(nb, no)
            print(f"moe: K1 experts {name} {what} M={m} K={k} N={n} group of "
                  f"{qx.shape[0]} bitwise against plain and the 2-D launches,"
                  f" plan={tuple(plan)} ms={ms:.4f} plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"share_of_bound={b_ms / ms:.4f} launches_per_step="
                  f"{len(groups)}", flush=True)
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib), ("bytes", nb), ("ops", no)):
                tot[key] += len(groups) * v
            launches += len(groups)
        del pw, x, px, a
    b_ms, b_by = bound(tot["bytes"], tot["ops"])
    print(f"moe: K1 experts per decode step ({launches} launches over "
          f"{mo.num_experts} experts): ms={tot['ms']:.4f} plain_ms="
          f"{tot['plain_ms']:.4f} library_ms={tot['library_ms']:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound="
          f"{b_ms / tot['ms']:.4f}", flush=True)
    return {"name": f"K1 timefloats_matmul over experts (one {cfg.name} "
                    f"MoE layer's decode step, {launches} launches)",
            "route": "cuda",
            "source": "src/repro_torch/csrc/timefloats_matmul.cu",
            "replaces": "src/repro/kernels/timefloats_matmul.py:47",
            "max_abs_err": 0.0, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tot["library_ms"]}


def moe_block_hold(torch, cfg, params, gen) -> None:
    """One MoE block (MLA mixer, router, dispatch, experts, shared expert,
    combine) of one decode step, and the block's MoE layer at a chain
    verify's VERIFY_ROWS tokens (drop-free), kernels against plain
    versions: each within K5_TOL of max(1, |plain|) (bitwise reported),
    with no assignment dropped."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import model, moe

    lp = params["layers"][cfg.moe.first_k_dense]
    x = torch.randn(SLOTS, 1, cfg.d_model, generator=gen,
                    device="cuda").bfloat16()
    xv = torch.randn(SLOTS, SPEC_K + 1, cfg.d_model, generator=gen,
                     device="cuda").bfloat16()
    pos = torch.full((SLOTS, 1), 7, dtype=torch.int32, device="cuda")
    lengths = torch.full((SLOTS,), 8, dtype=torch.int32, device="cuda")

    def decode_block():
        cache = model._layer_cache(cfg, SLOTS, 64, "cuda")
        g = torch.Generator(device="cuda").manual_seed(3)
        for buf in cache:
            buf.copy_(torch.randn(buf.shape, generator=g, device="cuda"))
        with torch.no_grad():
            y, _, aux = model.block_apply("moe", lp, x, cfg, positions=pos,
                                          cache=cache, lengths=lengths)
        return y, aux

    def verify_layer():
        with torch.no_grad():
            return moe.moe_apply(lp["ffn"], xv, cfg, drop_free=True)

    for what, run in ((f"one MoE block of a decode step ({SLOTS} tokens)",
                       decode_block),
                      (f"the MoE layer of a verify ({VERIFY_ROWS} tokens, "
                       "drop-free)", verify_layer)):
        t0 = time.monotonic()
        y, aux = run()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        with dispatch.override(kernels=False):
            yp, auxp = run()
        torch.cuda.synchronize()
        t2 = time.monotonic()
        diff = float((y.float() - yp.float()).abs().max().item())
        scale = max(1.0, float(yp.float().abs().max().item()))
        print(f"moe: {what}: kernels {t1 - t0:.2f}s, plain versions "
              f"{t2 - t1:.2f}s; bitwise {torch.equal(y, yp)}, max |diff| "
              f"{diff:.3g} of scale {scale:.3g}; dropped_frac "
              f"{float(aux['dropped_frac'])} / {float(auxp['dropped_frac'])}",
              flush=True)
        check(diff <= K5_TOL * scale, f"moe: {what}: the kernels and plain "
              "versions differ")
        check(float(aux["dropped_frac"]) == 0.0
              and float(auxp["dropped_frac"]) == 0.0,
              f"moe: {what}: an assignment dropped")


def phase_moe(torch, cfg, seed: int) -> tuple:
    import numpy as np

    from repro_torch import tree as tree_lib
    from repro_torch.kernels import paged as kp
    from repro_torch.kernels import paged_attn as kpa
    from repro_torch.kernels import sampling as ks
    from repro_torch.kernels import timefloats_matmul as km
    from repro_torch.models import model
    from repro_torch.serve.spec import SpecConfig

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in tree_lib.leaves(params))
    mo = cfg.moe
    print(f"moe: init {cfg.name} ({cfg.n_layers} layers {cfg.layer_kinds()},"
          f" {mo.num_experts} experts top-{mo.top_k} of width {mo.d_expert}, "
          f"{mo.num_shared} shared; {n_par / 1e9:.3f}e9 {cfg.param_dtype} "
          f"parameters) in {time.monotonic() - t_phase:.1f}s; memory_GB="
          f"{torch.cuda.memory_allocated() / 1e9:.2f} peak_mem_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    rec = moe_k1(torch, cfg, params, gen)
    moe_block_hold(torch, cfg, params, gen)
    release(torch)

    counters = {"K1": km.timefloats_matmul_quantized,
                "K1e": km.timefloats_matmul_experts, "K3": ks.sample,
                "K4": kpa.paged_decode_attention, "K5": kpa.paged_decode_mla,
                "K6": kp.gather_pages}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def launched():
        return {k: fn.launches for k, fn in counters.items()}

    layers = cfg.n_layers
    reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng, streams, wall = _moe_drain(torch, params, cfg, seed)
    launches = launched()
    graph_note("moe paged", eng, torch)
    print(f"moe paged: drained {len(streams)} requests in {wall:.2f}s, "
          f"steps={eng.steps} launches={launches}", flush=True)
    check(sorted(streams) == list(range(SLOTS)) and all(
        len(t) == MOE_NEW for t in streams.values()),
        f"moe paged: {SLOTS} requests of {MOE_NEW} tokens")
    check(launches["K5"] == layers * eng.steps and launches["K6"] > 0
          and launches["K1"] > 0 and launches["K1e"] > 0
          and launches["K3"] > 0 and launches["K4"] == 0,
          f"moe paged: launches {launches} in {eng.steps} steps")
    g_eng = (snap(eng), streams, launches)
    hold_warm("moe paged", eng, lambda: _moe_drain(torch, params, cfg, seed,
                                                   eng=eng))
    del eng
    release(torch)
    reset()
    with LogitTap() as tap_k, MoeTap() as mtap:
        e_eng, e_streams, e_wall = _moe_drain(torch, params, cfg, seed,
                                              graphs=False)
    print(f"moe paged: eager drain in {e_wall:.2f}s: wall_ms_per_step="
          f"{1e3 * e_wall / e_eng.steps:.1f}", flush=True)
    hold_graphs("moe paged", g_eng, (snap(e_eng), e_streams, launched()))
    mtap.hold("moe paged", mo.top_k, verify=False)
    del e_eng
    release(torch)
    print(f"moe: paged drains in {time.monotonic() - t0:.1f}s", flush=True)

    # The speculative drains replay the paged drain's streams as drafts:
    # the ngram draft is never accepted on random weights (0 of 112 in
    # this phase's first runs), and then only a verify's first row would
    # reach a stream.
    sc_kw = dict(spec=SpecConfig(k=SPEC_K), chunk_tokens=MLA_CHUNK,
                 drafts=streams)
    t0 = time.monotonic()
    reset()
    sc_eng, sc, sc_wall = _moe_drain(torch, params, cfg, seed, **sc_kw)
    sc_launches = launched()
    sc_st = sc_eng.stats()
    graph_note("moe spec+chunked", sc_eng, torch)
    print(f"moe spec+chunked: drained in {sc_wall:.2f}s: steps="
          f"{sc_eng.steps} chunk_waves={sc_eng.chunk_waves} accepted "
          f"{int(sc_st['spec_accepted'])} of {int(sc_st['spec_proposed'])} "
          f"drafts; launches={sc_launches}; streams digest {digest(sc)}",
          flush=True)
    check(sc_eng.chunk_waves > 0 and sc_launches["K5"] == layers
          * sc_eng.steps, f"moe spec+chunked: launches {sc_launches}")
    check(sc_eng.pool.conserved(), "moe spec+chunked: pool not conserved")
    check(sc_st["spec_accepted"] > 0, "moe spec+chunked: no draft accepted")
    g_sc = (snap(sc_eng), sc, sc_launches)
    del sc_eng
    release(torch)
    reset()
    with LogitTap() as tap_sc, MoeTap() as stap, RowCount(
            kpa, "_mla_kernel") as k5_rows:
        e_sc_eng, e_sc, _ = _moe_drain(torch, params, cfg, seed,
                                       graphs=False, **sc_kw)
    hold_graphs("moe spec+chunked", g_sc, (snap(e_sc_eng), e_sc, launched()))
    stap.hold("moe spec+chunked", mo.top_k, verify=True)
    check(k5_rows.rows.get(VERIFY_ROWS, 0) > 0, "moe spec+chunked: K5 "
          f"launches by rows {k5_rows.rows}")
    rep = divergence_report("spec+chunked vs the paged drain",
                            ("spec+chunked", e_sc, tap_sc.table()),
                            ("paged", e_streams, tap_k.table()),
                            phase="moe", first_ok=True)
    check(rep["near_ties"], "moe spec+chunked: a divergence from the paged "
          "drain that is not a near-tie flip")
    del e_sc_eng, g_sc
    release(torch)
    print(f"moe: spec+chunked drains in {time.monotonic() - t0:.1f}s",
          flush=True)

    # One decode step's device time by operator, SLOTS rows of 40 tokens.
    cache = model.init_paged_cache(cfg, SLOTS, MAX_LEN, page_size=PAGE,
                                   num_pages=SLOTS * 4 + 1, device="cuda")
    rows = np.zeros((SLOTS, MAX_LEN // PAGE), np.int32)
    rows[:, :4] = np.arange(1, SLOTS * 4 + 1).reshape(SLOTS, 4)
    cache = model.set_page_rows(cache, np.arange(SLOTS), rows)
    cache = cache._replace(lengths=torch.full((SLOTS,), 40, dtype=torch.int32,
                                              device="cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (SLOTS, 1), generator=gen,
                           device="cuda")
    reset()
    with torch.no_grad():
        model.decode_step(params, cache, tokens, cfg, kv_cap=64)
        step_launches = launched()
        ms, n_k = device_ms(torch, lambda: model.decode_step(
            params, cache, tokens, cfg, kv_cap=64))
    print(f"moe: one eager decode step ({SLOTS} rows of 40 tokens): "
          f"device_ms={ms:.3f} kernel launches={n_k}; wrapper launches "
          f"{step_launches} (K1 over experts: {step_launches['K1e']}); by "
          "operator: launch/profile_decode.py", flush=True)
    print(f"moe: phase peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" in {time.monotonic() - t_phase:.1f}s", flush=True)
    return launches, rec


FAILED_CAPTURE = """
import sys
import numpy as np
import torch
sys.path.insert(0, "src")
from repro_torch.serve.request import StepGraphs, launch_counters
g = StepGraphs("cuda", capture=True)
calls = []
def fn(x):
    calls.append(1)
    return (x * float(x.sum().item()),)   # a host sync: capture refuses it
try:
    g.call("sync", fn, np.ones(4, np.float32))
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0][:120])
    assert "sync" not in g.counts and len(calls) == 2, (g.counts, calls)
    assert all(f.launches == 0 for f in launch_counters())
    print("ok")
"""


def phase_graphs() -> None:
    """A capture that fails raises, in a process of its own: the step is
    not counted and not run eagerly in its place (its function ran twice,
    the warm-up and the refused capture)."""
    run = subprocess.run([sys.executable, "-c", FAILED_CAPTURE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    print("graphs: a failed capture: " + " | ".join(
        run.stdout.strip().splitlines()), flush=True)
    check(run.returncode == 0 and run.stdout.strip().endswith("ok"),
          f"graphs: a failed capture did not raise as it should: "
          f"{run.stderr.strip()[-400:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases, in the "
                    "script's order (default: all; the kernels' record then "
                    "lists only the kernels held)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"--phases: choose from {','.join(PHASES)}")

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
    print(f"build: K1, K2, K3, K4, K5 and K6 built from "
          f"src/repro_torch/csrc in {secs:.1f}s", flush=True)

    # Host seconds of the twin's census traces (meta tensors), per phase.
    from repro_torch.hw import schedule as hw_schedule

    census_s = [0.0]
    capture = hw_schedule.capture_census

    def timed_capture(*a, **kw):
        t0 = time.monotonic()
        try:
            return capture(*a, **kw)
        finally:
            census_s[0] += time.monotonic() - t0

    hw_schedule.capture_census = timed_capture

    cfg = get_config("qwen3-0.6b", tf=TFConfig(mode="pallas"))
    cfg_mla = get_config("deepseek-v3-671b", n_layers=MLA_LAYERS,
                         tf=TFConfig(mode="pallas"))
    cfg_mla_train = get_config("deepseek-v3-671b", n_layers=MLA_TRAIN_LAYERS,
                               tf=TFConfig(mode="pallas"))
    cfg_moe = get_config("deepseek-v3-671b", n_layers=MOE_LAYERS,
                         param_dtype="bfloat16", tf=TFConfig(mode="pallas"))
    recs, launches = {}, {}

    def timed(name, fn, *a):
        t0, c0 = time.monotonic(), census_s[0]
        out = fn(*a)
        release(torch)
        print(f"phase {name}: {time.monotonic() - t0:.1f}s (census traces "
              f"{census_s[0] - c0:.2f}s)", flush=True)
        return out

    try:
        if "k1" in phases:
            (recs["K1 decode"], recs["K1 train"],
             recs["K1 mla train"]) = timed("k1", phase_k1, torch, cfg,
                                           args.seed, cfg_mla_train)
        if "k2" in phases:
            recs["K2"], recs["K2 mla"] = timed("k2", phase_k2, torch, cfg,
                                               args.seed, cfg_mla_train)
        if "k3" in phases:
            recs["K3"] = timed("k3", phase_k3, torch, cfg, args.seed,
                               cfg_mla.vocab_size)
        if "k6" in phases:
            recs["K6"] = timed("k6", phase_k6, torch, cfg, args.seed)
        if "k4" in phases:
            recs["K4"] = timed("k4", phase_k4, torch, cfg, args.seed)
        if "k5" in phases:
            recs["K5"] = timed("k5", phase_k5, torch, cfg_mla, args.seed)
        if "hw" in phases:
            timed("hw", phase_hw, torch, args.seed)
        serving = ("serve", phase_serve), ("paged", phase_paged_serve), (
            "chunked", phase_chunked), ("spec", phase_spec)
        if phases & {name for name, _ in serving}:
            t0 = time.monotonic()
            params = model.init(cfg, args.seed, device="cuda")
            torch.cuda.synchronize()
            print(f"serve: init {cfg.name} ({cfg.n_layers} layers, d_model "
                  f"{cfg.d_model}, vocab {cfg.vocab_size}) in "
                  f"{time.monotonic() - t0:.1f}s", flush=True)
            for name, fn in serving:
                if name in phases:
                    launches[name] = timed(name, fn, torch, cfg, args.seed,
                                           params)
            del params
            release(torch)
        if "train" in phases:
            launches["train"] = timed("train", phase_train, torch, cfg,
                                      args.seed)
        if "mla" in phases:
            launches["mla"], recs["K1 mla"] = timed(
                "mla", phase_mla, torch, cfg_mla, args.seed)
        if "moe" in phases:
            launches["moe"], recs["K1 moe"] = timed(
                "moe", phase_moe, torch, cfg_moe, args.seed)
        if "train_mla" in phases:
            launches["train_mla"] = timed("train_mla", phase_train_mla, torch,
                                          cfg_mla_train, args.seed)
        if phases & ({name for name, _ in serving} | {"mla", "moe"}):
            timed("graphs", phase_graphs)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    # Each record's launches are counted on the main path's run that uses
    # the kernel: the dense drain (K1's decode record, K3), the paged drain
    # (K4, K6), the training run (K1's training record, K2), the MLA paged
    # drain (K5, and K1's record at the deepseek-v3 shapes), the MoE paged
    # drain (K1's launches over experts), the MLA training drain (K1's and
    # K2's records at its shapes).
    for rec, run, key in (("K1 decode", "serve", "K1"), ("K3", "serve", "K3"),
                          ("K1 train", "train", "K1"), ("K2", "train", "K2"),
                          ("K4", "paged", "K4"), ("K6", "paged", "K6"),
                          ("K5", "mla", "K5"), ("K1 mla", "mla", "K1"),
                          ("K1 moe", "moe", "K1e"),
                          ("K1 mla train", "train_mla", "K1"),
                          ("K2 mla", "train_mla", "K2")):
        if rec in recs:
            recs[rec]["launches"] = launches.get(run, {}).get(key)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"total: {time.monotonic() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in recs.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
