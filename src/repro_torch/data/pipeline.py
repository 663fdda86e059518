"""Deterministic batches (port of ``repro.data.pipeline``).

``DataPipeline.batch_at(step)`` is a pure function of ``(seed, step)``: a
restart replays the exact stream from the resumed step, the data half of
the fault-tolerance story. Batches are drawn on ``device`` directly. The
reference's background prefetch thread and its batch sharding are not
ported: one card has no mesh, and a batch is a few kernel launches.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data import synthetic

_MASK64 = (1 << 64) - 1


def _mix(seed: int, step: int) -> int:
    """A 64-bit generator seed from (seed, step) (splitmix64 finalizer), so
    nearby seeds and steps give unrelated streams."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class DataPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 seed: int = 0, kind: str = "markov", device="cuda"):
        if kind not in ("markov", "lm"):
            raise ValueError(f"unknown data kind {kind!r}")
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed, self.kind, self.device = seed, kind, torch.device(device)
        self._table = None
        if kind == "markov":
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_mix(seed ^ 0x5EED, 0))
            self._table = synthetic.markov_table(cfg.vocab_size, gen)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_mix(self.seed, step))
        if self.kind == "markov":
            return synthetic.markov_batch(self.cfg, self.batch, self.seq,
                                          gen, self._table)
        return synthetic.lm_batch(self.cfg, self.batch, self.seq, gen)
