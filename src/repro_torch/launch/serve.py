"""Serving launcher (port of ``repro.launch.serve``): bring up the fused
engine on a model config, drain a synthetic request stream, and print the
throughput and latency report and, on a paged engine, the pool and radix
counters.

    PYTHONPATH=src python -m repro_torch.launch.serve --paged --prefix-len 48

runs full-width qwen3-0.6b on the card; ``--device cpu --reduced`` runs
the reduced config on the CPU, where every kernel's plain version runs.
The request stream from ``--seed`` is the reference launcher's: prompts of
4 to min(64, max_len / 2) tokens, each after ``--prefix-len`` shared
tokens. The reference's ``--engine legacy``, ``--chunk-tokens``,
``--sched cost``, ``--spec``, tracing, metrics, health and wear options
wait for the slices that port them.
"""
import argparse
import dataclasses
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--quant", default="timefloats",
                    choices=["timefloats", "none"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="paged cache pool + radix prefix cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="shared system-prompt tokens prepended to every "
                         "request (exercises the radix prefix cache)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.core.timefloats import TFConfig
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.request import Request, percentile

    # The plain K1 takes each chunk's integer dot as an f32 matmul, exact
    # only without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch, tf=TFConfig(mode="pallas"))
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, quant=args.quant)
    device = torch.device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"device {where}; arch={args.arch} reduced={args.reduced} "
          f"quant={args.quant} layers={cfg.n_layers} slots={args.slots} "
          f"paged={args.paged}", flush=True)

    params = M.init(cfg, args.seed, device=device)
    eng = Engine(params, cfg, slots=args.slots, max_len=args.max_len,
                 seed=args.seed, paged=args.paged, page_size=args.page_size,
                 device=device)
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab_size,
                          size=args.prefix_len).astype(np.int32)
    rng.integers(0, cfg.vocab_size, size=8)  # the reference's spec motif
    for uid in range(args.requests):
        plen = int(rng.integers(4, min(64, args.max_len // 2)))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        if args.prefix_len:
            prompt = np.concatenate([shared, prompt])
        eng.submit(Request(uid=uid, prompt=prompt,
                           max_new_tokens=args.max_new,
                           temperature=args.temperature))
    t0 = time.time()
    done = eng.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    new_tokens = sum(len(f.tokens) for f in done)
    print(f"served {len(done)}/{args.requests} requests, {new_tokens} tokens "
          f"in {dt:.1f}s ({new_tokens / max(dt, 1e-9):.1f} tok/s)")
    lats = [f.latency_s for f in done if f.latency_s > 0]
    ttfts = [f.ttft_s for f in done if f.ttft_s > 0]
    print(f"latency p50 {percentile(lats, 50):.2f}s p95 "
          f"{percentile(lats, 95):.2f}s | ttft p50 "
          f"{percentile(ttfts, 50):.2f}s p95 {percentile(ttfts, 95):.2f}s | "
          f"steps {eng.steps} | host transfers {eng.host_transfers}")
    if args.paged:
        st = eng.stats()
        conserved = eng.pool.conserved()
        print(f"paged: hit rate {st['radix_hit_rate']:.1%} "
              f"({int(st['radix_hits'])} hits), pool "
              f"{int(st['pool_pages_in_use'])} used + "
              f"{int(st['pool_pages_free'])} free / "
              f"{int(st['pool_pages_total'])} pages, "
              f"{int(st['radix_nodes'])} radix nodes, "
              f"{int(st['radix_evictions'])} evictions, "
              f"conserved={conserved}")
        if not conserved:
            return 1
        if args.prefix_len and not st["radix_hit_rate"] > 0:
            return 1
    return 0 if len(done) == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
