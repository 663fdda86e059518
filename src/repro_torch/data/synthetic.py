"""Deterministic synthetic LM data (port of ``repro.data.synthetic``).

- ``lm_batch``: uniform random tokens (shape and throughput runs).
- ``markov_batch``: an order-1 Markov chain over a fixed random transition
  table, so training losses can fall.
- ``classification_data``: gaussian blobs for the paper-scale edge MLP.

Every draw comes from a ``torch.Generator``: a generator seeded from
(seed, step) determines a batch, which is what makes a restart replay the
same stream. The numbers differ from the reference's ``jax.random`` draws;
parity tests feed the reference's batches through numpy instead.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig

Tensor = torch.Tensor


def _require_text(cfg: ModelConfig) -> None:
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(f"{cfg.family} batches are not ported yet")


def _split(toks: Tensor, b: int, s: int) -> Dict[str, Tensor]:
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": torch.ones((b, s), dtype=torch.float32,
                               device=toks.device)}


def lm_batch(cfg: ModelConfig, b: int, s: int,
             generator: torch.Generator) -> Dict[str, Tensor]:
    _require_text(cfg)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=generator,
                         dtype=torch.int32, device=generator.device)
    return _split(toks, b, s)


def markov_table(vocab: int, generator: torch.Generator,
                 concentration: float = 0.3) -> Tensor:
    logits = torch.randn((vocab, vocab), generator=generator,
                         device=generator.device) / concentration
    return torch.softmax(logits, dim=-1)


def markov_batch(cfg: ModelConfig, b: int, s: int,
                 generator: torch.Generator, table: Tensor
                 ) -> Dict[str, Tensor]:
    """Chains of ``s + 1`` tokens from uniform starts; each next token is
    drawn from its predecessor's row, as the reference's categorical over
    ``log(table + 1e-9)`` draws it."""
    _require_text(cfg)
    vocab = table.shape[0]
    tok = torch.randint(0, vocab, (b,), generator=generator,
                        device=generator.device)
    seq = [tok]
    for _ in range(s):
        tok = torch.multinomial(table[tok] + 1e-9, 1,
                                generator=generator)[:, 0]
        seq.append(tok)
    return _split(torch.stack(seq, dim=1).to(torch.int32), b, s)


def classification_data(generator: torch.Generator, n: int, in_dim: int,
                        n_classes: int, margin: float = 1.0
                        ) -> tuple[Tensor, Tensor]:
    """Linearly-separable-ish gaussian blobs for the paper-scale MLP
    (``configs/timefloats_mlp.py``): class centers ~ N(0, margin^2), each
    point its class center plus N(0, 0.25) noise. Returns (x (n, in_dim)
    f32, labels (n,) int32) on the generator's device."""
    dev = generator.device
    centers = torch.randn((n_classes, in_dim), generator=generator,
                          device=dev) * margin
    labels = torch.randint(0, n_classes, (n,), generator=generator,
                           dtype=torch.int32, device=dev)
    x = centers[labels.long()] + torch.randn((n, in_dim), generator=generator,
                                             device=dev) * 0.5
    return x, labels
