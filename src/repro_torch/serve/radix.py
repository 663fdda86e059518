"""Host-side radix cache over token prefixes at page granularity
(DESIGN.md §8). A copy of ``repro.serve.radix``, which the port may not
import; pure Python, only the pool import changed.

Prefix reuse on the paged pool shares whole pages only: a page's K/V is
a pure function of the ``page_size`` tokens it covers plus everything
before them (causal attention, absolute positions), so the tree is keyed
by full-page token chunks — each node IS one page, its edge key the
page's token tuple. Matching therefore never yields a partially-shared
page, which is what lets a borrowing slot's first write position
(``skip``) always land in a page it owns exclusively.

Contract with :class:`repro_torch.serve.kvpool.PagePool`:

- ``match`` pins every matched page (``retain``) for the borrowing
  request — the engine releases them when the request leaves its slot.
- ``insert`` retains newly indexed pages on behalf of the tree (one
  reference per node). If a node for a chunk already exists — a
  concurrent identical prompt inserted first — the caller's duplicate
  page simply stays slot-private and dies with the slot; the tree never
  holds two pages for one prefix.
- ``evict`` walks LRU leaves whose page only the tree still references
  (refcount == 1) and releases them; interior nodes are never evicted
  before their children, so every cached prefix stays reachable from the
  root. The pool calls it on allocation shortfall.

Matching is capped at ``len(tokens) - 1`` so at least one prompt token
always prefills (the last position must produce the first logits).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple

from repro_torch.serve.kvpool import PagePool


class _Node:
    __slots__ = ("children", "page", "parent", "key", "last_use")

    def __init__(self, page: int, parent, key, last_use: int):
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.page = page
        self.parent = parent
        self.key = key
        self.last_use = last_use


class RadixCache:
    """Page-granular prefix tree with refcounted pages and LRU eviction."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.root = _Node(page=-1, parent=None, key=None, last_use=0)
        self.evictions = 0
        self._clock = 0  # logical LRU time — monotonic, no wall clock

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @staticmethod
    def _chunk(tokens: Sequence[int], i: int, ps: int) -> Tuple[int, ...]:
        return tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    # -- lookup --------------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest page-aligned cached prefix of ``tokens``.

        Returns ``(pages, n_matched_tokens)`` with every returned page
        pinned for the caller (release via :meth:`release` / the engine's
        slot teardown). At most ``len(tokens) - 1`` tokens match."""
        ps = self.pool.page_size
        usable = max((len(tokens) - 1) // ps, 0)
        node, pages = self.root, []
        t = self._tick()
        for i in range(usable):
            child = node.children.get(self._chunk(tokens, i, ps))
            if child is None:
                break
            child.last_use = t
            self.pool.retain(child.page)
            pages.append(child.page)
            node = child
        return pages, len(pages) * ps

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.pool.release(p)

    # -- insertion -----------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index ``pages`` (full pages covering ``tokens``, in order) under
        their token chunks; returns how many nodes were newly created (the
        tree retains exactly those pages)."""
        ps = self.pool.page_size
        assert len(tokens) == len(pages) * ps, "insert requires full pages"
        node, t, created = self.root, self._tick(), 0
        for i, page in enumerate(pages):
            key = self._chunk(tokens, i, ps)
            child = node.children.get(key)
            if child is None:
                child = _Node(page=int(page), parent=node, key=key,
                              last_use=t)
                node.children[key] = child
                self.pool.retain(int(page))
                created += 1
            else:
                child.last_use = t  # duplicate page stays slot-private
            node = child
        return created

    # -- eviction ------------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evictable_pages(self) -> int:
        """Pages eviction could reclaim right now: nodes whose ENTIRE
        subtree is tree-only (refcount 1) — a node above a pinned
        descendant can never become an evictable leaf."""

        def walk(node: _Node):
            ok = self.pool.refcount(node.page) == 1
            count = 0
            for ch in node.children.values():
                ch_ok, ch_count = walk(ch)
                count += ch_count
                ok = ok and ch_ok
            return ok, count + (1 if ok else 0)

        return sum(walk(ch)[1] for ch in self.root.children.values())

    def evict(self, n: int, all_or_nothing: bool = False) -> int:
        """Free up to ``n`` pages by dropping LRU leaves nobody but the
        tree references; returns how many pages were actually freed.

        ``all_or_nothing=True`` refuses to evict anything unless the full
        shortfall is coverable — the admission path uses this so a
        request that cannot be admitted anyway does not destroy cached
        prefixes for nothing (the next requests would re-pay the very
        prefill reads the tree exists to skip)."""
        if all_or_nothing and self.evictable_pages() < n:
            return 0
        # LRU heap over current leaves; a parent enters the heap when its
        # last child is evicted. Refcounts cannot change inside this call
        # (single-threaded host), so pinned leaves are dropped, not
        # re-queued — their parents can never become leaves this pass.
        heap = [(leaf.last_use, id(leaf), leaf) for leaf in self._leaves()]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < n:
            _, _, leaf = heapq.heappop(heap)
            if self.pool.refcount(leaf.page) != 1:
                continue  # borrowed by a live slot — not evictable
            parent = leaf.parent
            del parent.children[leaf.key]
            self.pool.release(leaf.page)
            self.evictions += 1
            freed += 1
            if parent is not self.root and not parent.children:
                heapq.heappush(heap, (parent.last_use, id(parent), parent))
        return freed

    # -- introspection -------------------------------------------------------
    @property
    def nodes(self) -> int:
        n, stack = 0, list(self.root.children.values())
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n
