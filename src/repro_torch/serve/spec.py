"""Speculative decoding on the serving engine (port of ``repro.serve.spec``,
DESIGN.md §12).

A draft proposes a depth-K token chain per active slot; the target scores
the whole chain in one batched ``model.verify_step`` call against the live
(dense or paged) cache, and the longest accepted prefix plus the target's
own "bonus" token is emitted in one step. With temperature-0 requests the
spec-on token stream equals the non-spec engine's stream: speculation
changes how many steps a drain takes, not its tokens.

Two draft sources: ``ngram`` (host prompt-lookup: the continuation of the
most recent earlier occurrence of the current suffix n-gram in prompt +
generated) and ``model`` (a small draft model whose K ``decode_step``s run
inside the engine's fused step, against a dense draft cache that mirrors
the target's admissions).

The proposers and the acceptance rule live here, engine-independent:
:func:`propose_ngram`, :func:`sequential_oracle`, :class:`TokenTree`,
:func:`accept_tree` and :func:`greedy_continuation` are host Python;
:func:`chain_accept` is the device rule and runs on the device of its
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Engine speculation knobs (``Engine(spec=SpecConfig(...))``).

    ``k`` is the draft depth: each step verifies k+1 positions (pending
    token + k drafts) and emits 1..k+1 tokens. ``draft`` picks the
    proposer; ``"model"`` also needs ``draft_params``/``draft_cfg`` (an
    attention-family config sharing the target's vocab). ``ngram_max`` is
    the longest suffix n-gram the prompt-lookup draft tries to match."""

    k: int = 4
    draft: str = "ngram"
    ngram_max: int = 4
    draft_params: Any = None
    draft_cfg: Any = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("spec.k must be >= 1")
        if self.draft not in ("ngram", "model"):
            raise ValueError(f"unknown draft {self.draft!r}")
        if self.draft == "model" and (self.draft_params is None
                                      or self.draft_cfg is None):
            raise ValueError("draft='model' needs draft_params + draft_cfg")


def propose_ngram(history: Sequence[int], k: int,
                  max_n: int = 4) -> np.ndarray:
    """Prompt-lookup draft: find the most recent EARLIER occurrence of the
    history's suffix n-gram (longest n first, n <= ``max_n``) and propose
    the k tokens that followed it; fall back to repeating the last token.
    Host numpy: the proposal rides the step's input upload."""
    h = np.asarray(history, dtype=np.int64).reshape(-1)
    length = int(h.shape[0])
    if length == 0:
        return np.zeros((k,), np.int32)
    # A constant tail of max_n + 1 tokens: the longest-n match lands one
    # position back and continues with the same token, as the scan would.
    if length > max_n and (h[length - max_n - 1:] == h[-1]).all():
        return np.full((k,), h[-1], np.int32)
    for n in range(min(max_n, length - 1), 0, -1):
        pat = h[length - n:]
        win = np.lib.stride_tricks.sliding_window_view(h[: length - 1], n)
        hits = np.nonzero((win == pat).all(axis=1))[0]
        if hits.size:
            i = int(hits[-1])  # most recent
            cont = h[i + n: i + n + k]
            if cont.size < k:
                cont = np.concatenate(
                    [cont, np.full(k - cont.size, h[-1], np.int64)])
            return cont.astype(np.int32)
    return np.full((k,), h[-1], np.int32)


def chain_accept(greedy: Tensor, draft: Tensor, remaining: Tensor,
                 lengths0: Tensor, *, max_len: int, eos: Optional[int]
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """Device-side longest-accepted-prefix rule for a depth-K chain.

    ``greedy (B, K+1)`` is the target's pick at every chain position
    (position j scores the prefix [pending, d_1..d_j]); ``draft (B, K)``
    the proposals; ``remaining``/``lengths0`` the pre-verify budget and
    committed length. Returns ``(emit (B, K+1) bool, e (B,) int32,
    done (B,) bool)``: the chain positions a sequential greedy engine
    would have emitted (draft j+1 accepted iff it equals greedy j; emission
    stops at the first budget / cache-full / eos hit, the non-spec step's
    done predicate applied per emission), their count (>= 1), and whether
    the last emitted token finished the request."""
    k1 = greedy.shape[1]
    match = (draft == greedy[:, :-1]).to(torch.int32)    # d_{j+1} == g_j
    acc = torch.cumprod(match, dim=1).sum(dim=1)         # (B,) in [0, K]
    j = torch.arange(k1, dtype=torch.int32, device=greedy.device)[None, :]
    stop = (((remaining[:, None] - (j + 1)) <= 0)
            | ((lengths0[:, None] + j + 1) >= (max_len - 1)))
    if eos is not None:
        stop = stop | (greedy == eos)
    s32 = stop.to(torch.int32)
    before = torch.cumsum(s32, dim=1) - s32
    emit = (j <= acc[:, None]) & (before == 0)
    e = emit.sum(dim=1).to(torch.int32)
    done = (emit & stop).any(dim=1)
    return emit, e, done


def sequential_oracle(draft: Sequence[int], greedy: Sequence[int],
                      remaining: int, length0: int, max_len: int,
                      eos: Optional[int] = None) -> Tuple[List[int], bool]:
    """Host reference for :func:`chain_accept`: replay the chain as the
    sequential greedy engine would, emitting greedy[j] while every earlier
    draft matched and no earlier emission hit a stop. Returns (emitted
    tokens, done)."""
    out: List[int] = []
    for j, g in enumerate(greedy):
        if j > 0 and int(draft[j - 1]) != int(greedy[j - 1]):
            break
        out.append(int(g))
        if (remaining - (j + 1) <= 0 or length0 + j + 1 >= max_len - 1
                or (eos is not None and int(g) == eos)):
            return out, True
    return out, False


@dataclasses.dataclass(frozen=True)
class TokenTree:
    """Draft token tree in parent-pointer form. Node i holds
    ``tokens[i]``; ``parents[i]`` is its parent (-1 = the committed
    context), and ``parents[i] < i``. A depth-K chain is ``tokens=(d_1..
    d_K), parents=(-1, 0, .., K-2)``, the shape the engine verifies."""

    tokens: Tuple[int, ...]
    parents: Tuple[int, ...]

    def __post_init__(self):
        if len(self.tokens) != len(self.parents):
            raise ValueError("tokens and parents differ in length")
        for i, p in enumerate(self.parents):
            if not -1 <= p < i:
                raise ValueError("nodes must be topologically ordered")

    @staticmethod
    def chain(tokens: Sequence[int]) -> "TokenTree":
        return TokenTree(tokens=tuple(int(t) for t in tokens),
                         parents=tuple(range(-1, len(tokens) - 1)))

    def depth(self, i: int) -> int:
        d = 0
        while i != -1:
            d += 1
            i = self.parents[i]
        return d

    def path(self, i: int) -> List[int]:
        out: List[int] = []
        while i != -1:
            out.append(i)
            i = self.parents[i]
        out.reverse()
        return out


def accept_tree(tree: TokenTree, greedy_root: int,
                greedy_nodes: Sequence[int]) -> List[int]:
    """Tree acceptance: given the target's next token after the root
    context (``greedy_root``) and after every node's path
    (``greedy_nodes[i]``), emit the tokens along the deepest fully
    accepted path plus the target's bonus token at its tip. A node is
    accepted iff its parent is and its token equals the target's pick
    after the parent's prefix; depth ties go to the lowest node index."""
    n = len(tree.tokens)
    acc = [False] * n
    depth = [0] * n
    best_i, best_d = -1, 0
    for i in range(n):
        p = tree.parents[i]
        g = greedy_root if p == -1 else int(greedy_nodes[p])
        acc[i] = (p == -1 or acc[p]) and int(tree.tokens[i]) == g
        depth[i] = 1 if p == -1 else depth[p] + 1
        if acc[i] and depth[i] > best_d:
            best_i, best_d = i, depth[i]
    emitted = [int(tree.tokens[i]) for i in tree.path(best_i)]
    bonus = greedy_root if best_i == -1 else int(greedy_nodes[best_i])
    return emitted + [bonus]


def greedy_continuation(greedy_fn, context: Sequence[int],
                        depth: int) -> List[int]:
    """Roll a deterministic next-token function ``greedy_fn(prefix) ->
    token`` forward ``depth`` tokens from ``context``: the sequential
    oracle for :func:`accept_tree`."""
    prefix = [int(t) for t in context]
    out: List[int] = []
    for _ in range(depth):
        t = int(greedy_fn(tuple(prefix)))
        out.append(t)
        prefix.append(t)
    return out
