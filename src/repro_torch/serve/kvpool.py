"""Host-side page allocator for the device-resident paged KV pool
(DESIGN.md §8). A copy of ``repro.serve.kvpool``, which the port may not
import; pure Python, nothing in it changed.

The device holds one fixed inventory of ``num_pages`` pages per cache
leaf (each page stores ``page_size`` token positions); this class owns
the free list and per-page reference counts that decide which page ids a
slot's page table may point at. Page 0 is the reserved **trash page**: it
is never allocated, every unassigned page-table entry points at it, and
writes for inactive/dummy rows land there — so a freed-and-reallocated
page can never be corrupted by a stale slot.

Reference counting: ``alloc`` hands out pages at refcount 1 (the owning
slot). The radix cache retains pages it indexes; prefix-matched requests
retain the shared pages they borrow. A page returns to the free list
exactly when its refcount reaches zero — ``pages_in_use + free_pages ==
total_pages`` is the conservation invariant CI and the property tests
assert.
"""
from __future__ import annotations

from typing import Callable, List, Optional

TRASH_PAGE = 0


class PagePool:
    """Free list + refcounts over a fixed page inventory (page 0 reserved)."""

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2, "need at least one usable page besides trash"
        assert page_size >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: freshly freed pages are reused first (their old
        # contents are dead by construction — refcount hit zero).
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref: List[int] = [0] * num_pages

    # -- introspection -------------------------------------------------------
    @property
    def total_pages(self) -> int:
        """Usable pages (the trash page is bookkeeping, not capacity)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Counted from refcounts (NOT total-free) so the conservation
        invariant ``in_use + free == total`` actually detects leaks."""
        return sum(1 for r in self._ref[1:] if r > 0)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    # -- lifecycle -----------------------------------------------------------
    def alloc(self, n: int,
              evict: Optional[Callable[[int], int]] = None
              ) -> Optional[List[int]]:
        """Allocate ``n`` pages at refcount 1; ``evict(shortfall)`` (the
        radix cache's LRU pass) is consulted when the free list is short.
        Returns None — allocating nothing — if capacity still can't be
        met, so admission can leave the request queued."""
        if len(self._free) < n and evict is not None:
            evict(n - len(self._free))
        if len(self._free) < n:
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            assert self._ref[p] == 0, f"page {p} allocated while referenced"
            self._ref[p] = 1
        return out

    def retain(self, page: int) -> None:
        assert page != TRASH_PAGE, "trash page is never retained"
        assert self._ref[page] > 0, f"retain of unallocated page {page}"
        self._ref[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        assert page != TRASH_PAGE, "trash page is never released"
        assert self._ref[page] > 0, f"double free of page {page}"
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            return True
        return False

    def conserved(self) -> bool:
        """The invariant tests/CI assert after any workload."""
        no_free_refs = all(self._ref[p] == 0 for p in self._free)
        return (self.pages_in_use + self.free_pages == self.total_pages
                and no_free_refs and self._ref[TRASH_PAGE] == 0)
