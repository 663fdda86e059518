"""K3: fused sample-from-logits for the serving step (DESIGN.md §9).

Replaces the Pallas TPU kernel ``_sample_kernel`` / ``_sample_pallas`` of
``repro.kernels.sampling``; the CUDA source is ``csrc/sampling.cu``. The
sampling law is the reference's Gumbel-max form, one masked argmax per slot:

    categorical(lg / t)  ==  argmax(lg / t + gumbel noise)

Rows with ``t <= 0`` take the plain argmax, ties to the lowest index
(:func:`argmax_low`). The noise is an input of the kernel;
:func:`sample_tokens` draws it as the reference does, ``gumbel`` of the
per-row key ``fold_in(fold_in(fold_in(key, row), tag), counter)``
(``repro_torch.random``), so tempered streams match the reference's token
for token, as greedy ones do.

Beside the kernel: its plain version (:func:`sample_plain`), a launch
counter, ``sample.launches``, and :func:`row_slices`, the cut of a row over
the kernel's cluster of blocks, which ``chip_smoke.py`` uses to put exact
ties on every slice boundary.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import random as rnd
from repro_torch.kernels import _build, dispatch


def argmax_low(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Argmax with explicit lowest-index tie-breaking; a row holding a NaN
    returns its length, as the reference's masked min does."""
    m = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    iota = torch.arange(n, dtype=torch.int32, device=x.device).reshape(shape)
    return torch.where(x == m, iota, n).amin(dim=dim).to(torch.int32)


def sample_plain(lg: torch.Tensor, noise: torch.Tensor,
                 temps: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version. lg, noise (S, V) f32; temps (S,) f32."""
    hot = lg / temps.clamp_min(1e-6)[:, None] + noise
    return torch.where(temps > 0.0, argmax_low(hot), argmax_low(lg))


# Blocks (one thread-block cluster) per row, in order of preference: 16 was
# the fastest of 4, 8 and 16 at the serving shapes, (4, 151936) and (4,
# 129280), on the H100 (chip_smoke.py phase_k3 prints the sweep), 8 next.
# 16 is a non-portable cluster size that needs 16 free SMs in one GPC, as
# the H100 SXM has; :func:`cluster_blocks` takes the largest the card can
# place. The three give the same bits.
CLUSTER_CHOICES = (16, 8, 4)
MAX_BLOCKS_PER_ROW = 16
_PICKED: dict = {}


def pick_blocks_per_row(max_clusters) -> int:
    """The first of :data:`CLUSTER_CHOICES` of which ``max_clusters(p)``,
    the count of p-block clusters the card can hold at once, is positive."""
    for p in CLUSTER_CHOICES:
        if max_clusters(p) > 0:
            return p
    raise RuntimeError(f"no cluster of {CLUSTER_CHOICES[-1]} blocks fits "
                       "on this card")


def cluster_blocks(device) -> int:
    """K3's cluster size on ``device``, picked once per device by
    ``cudaOccupancyMaxActiveClusters`` (the ``sample_max_clusters`` entry
    point)."""
    idx = _build.device_index(device)
    if idx not in _PICKED:
        lib = _build.load("sampling")

        def max_clusters(p: int) -> int:
            n = ctypes.c_int(0)
            with torch.cuda.device(idx):
                _build.check(lib.sample_max_clusters(p, ctypes.byref(n)),
                             "sampling (cluster occupancy)")
            return n.value

        _PICKED[idx] = pick_blocks_per_row(max_clusters)
    return _PICKED[idx]


def row_slices(v: int, blocks: int, row: int = 0) -> list[tuple[int, int]]:
    """The contiguous [start, stop) of row ``row`` of an (S, V) tensor with
    a 16-byte-aligned base that each of the kernel's ``blocks`` scans, as
    ``csrc/sampling.cu``'s ``slice_edge`` cuts it. The first
    ``(-row * V) % 4`` elements precede the row's first 16-byte-aligned
    one; internal boundaries fall on aligned elements and split the row's
    aligned float4s evenly."""
    head = min((-row * v) % 4, v)
    n4 = (v - head) // 4
    edges = [0] + [head + 4 * (p * n4 // blocks)
                   for p in range(1, blocks)] + [v]
    return list(zip(edges[:-1], edges[1:]))


def sample(lg: torch.Tensor, noise: torch.Tensor, temps: torch.Tensor, *,
           blocks_per_row: int | None = None) -> torch.Tensor:
    """(S,) int32 tokens. A CUDA tensor launches K3 (or raises) with
    ``blocks_per_row`` blocks, one cluster, per row (default
    :func:`cluster_blocks` for the card); a CPU tensor runs the plain
    version."""
    if lg.ndim != 2 or noise.shape != lg.shape or temps.shape != lg.shape[:1]:
        raise ValueError(f"shapes lg {tuple(lg.shape)}, noise "
                         f"{tuple(noise.shape)}, temps {tuple(temps.shape)}:"
                         " need (S,V), (S,V), (S,)")
    if not all(t.dtype == torch.float32 for t in (lg, noise, temps)):
        raise TypeError("lg, noise and temps must be float32")
    if not dispatch.use_kernel(lg):
        return sample_plain(lg, noise, temps)
    if not all(t.is_cuda and t.device == lg.device for t in (noise, temps)):
        raise ValueError("all operands must lie on the same CUDA device")
    if not all(t.is_contiguous() for t in (lg, noise, temps)):
        raise ValueError("operands must be contiguous")
    if (lg.data_ptr() - noise.data_ptr()) % 16:
        raise ValueError("lg and noise must agree in address modulo 16 "
                         "(the kernel reads both in aligned 16-byte units)")
    if blocks_per_row is None:
        blocks_per_row = cluster_blocks(lg.device)
    if not 1 <= blocks_per_row <= MAX_BLOCKS_PER_ROW:
        raise ValueError(f"blocks_per_row {blocks_per_row}: 1 to "
                         f"{MAX_BLOCKS_PER_ROW}")
    s, v = lg.shape
    out = torch.empty((s,), dtype=torch.int32, device=lg.device)
    err = _build.load("sampling").sample_tokens(
        lg.data_ptr(), noise.data_ptr(), temps.data_ptr(), out.data_ptr(),
        s, v, blocks_per_row, _build.stream_ptr())
    _build.check(err, "sampling")
    sample.launches += 1
    return out


sample.launches = 0


def _fold3(key: torch.Tensor, slot, tag, counter) -> torch.Tensor:
    return rnd.fold_in(rnd.fold_in(rnd.fold_in(key, slot), tag), counter)


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  key: torch.Tensor, tags: torch.Tensor,
                  counters: torch.Tensor) -> torch.Tensor:
    """Greedy/temperature sampling for a decode batch on device: logits
    (S, V) float, temps (S,), the engine's raw key (2,), per-row request
    tags and sampling counters (S,). Row i's noise is ``gumbel`` of
    ``_fold3(key, i, tags[i], counters[i])``. Returns (S,) int32."""
    lg = logits.to(torch.float32).contiguous()
    s, v = lg.shape
    rows = torch.arange(s, dtype=torch.int64, device=lg.device)
    noise = rnd.gumbel(_fold3(key, rows, tags, counters), (v,))
    return sample(lg, noise, temps.to(torch.float32).contiguous())
