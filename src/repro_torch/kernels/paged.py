"""K6: the page-table gather of the paged KV pool (DESIGN.md §8):
``out[b, t] = pool[page_table[b, t]]``.

Replaces the Pallas TPU kernel ``_kernel`` / ``gather_pages_pallas`` of
``repro.kernels.paged``; the CUDA source is ``csrc/paged_gather.cu``. The
gather-then-attend paths (paged prefill waves, and decode with
``fused_decode=False``) read a row's dense view ``(B, T, page, *feat)``
through it.

Beside the kernel: its plain version (:func:`gather_pages_plain`) and a
launch counter, ``gather_pages.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, dispatch


def gather_pages_plain(pool: torch.Tensor, page_table: torch.Tensor
                       ) -> torch.Tensor:
    """The kernel's plain version: ``pool[pt]`` -> (B, T, page, *feat)."""
    return pool[page_table]


def _vec_bytes(*ptrs_and_sizes: int) -> int:
    """The widest copy unit in bytes that divides every address and size."""
    for v in (16, 8, 4, 2, 1):
        if all(x % v == 0 for x in ptrs_and_sizes):
            return v
    return 1


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """(B, T, page, *feat) gather of whole pages. A CUDA pool launches K6
    (or raises); a CPU pool runs the plain version. Page ids must lie in
    [0, P): the kernel clamps them, as the reference's gather does, and
    the plain version raises on them."""
    if page_table.ndim != 2:
        raise ValueError(f"page_table {tuple(page_table.shape)}: need (B, T)")
    if not dispatch.use_kernel(pool):
        return gather_pages_plain(pool, page_table)
    if not (page_table.is_cuda and page_table.device == pool.device):
        raise ValueError("pool and page_table must lie on the same CUDA "
                         "device")
    if page_table.dtype != torch.int32:
        raise TypeError("page_table must be int32")
    if not (pool.is_contiguous() and page_table.is_contiguous()):
        raise ValueError("pool and page_table must be contiguous")
    b, t = page_table.shape
    out = torch.empty((b, t) + tuple(pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    if out.numel() == 0:
        return out
    page_bytes = pool[0].numel() * pool.element_size()
    vec = _vec_bytes(page_bytes, pool.data_ptr(), out.data_ptr())
    err = _build.load("paged_gather").gather_pages(
        pool.data_ptr(), page_table.data_ptr(), out.data_ptr(), b * t,
        pool.shape[0], page_bytes, vec,
        _build.stream_ptr())
    _build.check(err, "paged_gather")
    gather_pages.launches += 1
    return out


gather_pages.launches = 0
