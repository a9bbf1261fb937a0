"""Host-side page bookkeeping for the continuous-batching serve engine.

Two small, pure-Python structures manage the device-resident page pool
that ``Model.init_page_pool`` allocates (see ``models/attention.py``):

  * :class:`PageAllocator` — a free list over page ids ``1..n_pages-1``
    with reference counts. Page 0 is the **null page**: inactive batch
    slots and unused page-table entries all point at it, so the packed
    decode gather is always in-bounds and never retraces. The allocator
    never hands out page 0.
  * :class:`PrefixTrie` — a trie over *page-sized token chunks* mapping
    prompt prefixes to the page ids that hold their K/V. Requests whose
    prompts share a prefix share those pages (each holder takes a
    refcount) instead of re-prefilling them. Sharing is at full-page
    granularity only, and a request never shares its *last* prompt
    position's page — the suffix handed to prefill is always >= 1 token
    and decode only ever appends to pages the request owns privately, so
    a shared page is written exactly once (by the request that first
    filled it) and copy-on-write never actually triggers.

Both structures are plain host state: they decide *which* page ids go
into the int32 page tables; the device only ever sees static-shape
gathers/scatters over the pool. Neither is thread-safe — the
:class:`~repro_torch.serve.engine.ServeEngine` drives them from its single
scheduler loop.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

__all__ = ["PageAllocator", "PrefixTrie", "NULL_PAGE"]

NULL_PAGE = 0


class PageAllocator:
    """Free list + refcounts over page ids ``1..n_pages-1``.

    ``alloc`` returns a page with refcount 1 (or ``None`` when exhausted);
    ``incref`` adds a holder; ``decref`` drops one and returns the page to
    the free list when the count hits zero. Counters (``allocated`` /
    ``freed`` / ``peak_used``) feed the engine's serve report.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the reserved null page), "
                f"got {n_pages}")
        self.n_pages = n_pages
        # LIFO free list: recently-freed pages are re-used first, which
        # keeps the working set of the device pool compact
        self._free = list(range(n_pages - 1, 0, -1))
        self._refs = [0] * n_pages
        self.allocated = 0
        self.freed = 0
        self.peak_used = 0

    @property
    def used(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def refcount(self, pid: int) -> int:
        return self._refs[pid]

    def alloc(self) -> int | None:
        """Take a free page (refcount 1), or ``None`` when exhausted."""
        if not self._free:
            return None
        pid = self._free.pop()
        self._refs[pid] = 1
        self.allocated += 1
        self.peak_used = max(self.peak_used, self.used)
        return pid

    def incref(self, pid: int) -> None:
        if pid == NULL_PAGE or self._refs[pid] < 1:
            raise ValueError(f"incref on unallocated page {pid}")
        self._refs[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one holder; returns True when the page was freed."""
        if pid == NULL_PAGE or self._refs[pid] < 1:
            raise ValueError(f"decref on unallocated page {pid}")
        self._refs[pid] -= 1
        if self._refs[pid] == 0:
            self._free.append(pid)
            self.freed += 1
            return True
        return False

    def stats(self) -> dict:
        return {"n_pages": self.n_pages, "used": self.used,
                "free": self.free_count, "allocated": self.allocated,
                "freed": self.freed, "peak_used": self.peak_used}

    def __repr__(self) -> str:
        return (f"PageAllocator(used={self.used}/{self.n_pages - 1} "
                f"allocated={self.allocated} freed={self.freed})")


@dataclasses.dataclass
class _TrieNode:
    """One full page of prompt tokens: chunk-keyed children + the page id
    holding this chunk's K/V, plus an LRU tick for eviction ordering."""
    page: int
    tick: int
    children: dict[tuple, "_TrieNode"] = dataclasses.field(
        default_factory=dict)


class PrefixTrie:
    """Prompt-prefix -> page-id index at full-page granularity.

    Nodes are keyed by ``page_size``-token chunks; the path from the root
    to a node spells out a prompt prefix, and each node pins (one
    refcount on) the page holding that chunk's K/V. ``match`` walks the
    longest indexed prefix of a prompt; ``insert`` indexes a freshly
    prefilled prompt's full pages so later arrivals can share them;
    ``evict`` releases least-recently-matched pages nobody else holds
    when the allocator runs dry.

    The index is valid for **one (model, params) pair** — K/V bytes are a
    function of tokens *and* weights. The engine owns exactly one trie
    per served model; on a weight update the trie must be dropped.
    """

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self._root: dict[tuple, _TrieNode] = {}
        self._tick = 0
        self._n_pages = 0
        self.match_hits = 0      # match() calls that found >= 1 page
        self.pages_matched = 0   # total pages returned by match()
        self.pages_inserted = 0
        self.pages_evicted = 0

    def __len__(self) -> int:
        """Number of pages currently indexed (== trie-held refcounts)."""
        return self._n_pages

    def _chunks(self, tokens: Sequence[int]) -> Iterator[tuple]:
        ps = self.page_size
        for i in range(len(tokens) // ps):
            yield tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    def match(self, tokens: Sequence[int],
              max_pages: int | None = None) -> list[int]:
        """Page ids of the longest indexed full-page prefix of ``tokens``.

        ``max_pages`` caps the walk — the engine passes
        ``(len(prompt) - 1) // page_size`` so the suffix handed to
        prefill keeps at least one token (the last-position logits must
        come from a real forward). Touches the matched nodes' LRU ticks.
        """
        self._tick += 1
        pids: list[int] = []
        level = self._root
        for chunk in self._chunks(tokens):
            if max_pages is not None and len(pids) >= max_pages:
                break
            node = level.get(chunk)
            if node is None:
                break
            node.tick = self._tick
            pids.append(node.page)
            level = node.children
        if pids:
            self.match_hits += 1
            self.pages_matched += len(pids)
        return pids

    def insert(self, tokens: Sequence[int], page_ids: Sequence[int],
               allocator: PageAllocator) -> int:
        """Index ``tokens``' full pages; returns how many were newly added.

        ``page_ids`` is the request's page table (covering *all* its
        prompt pages, shared first). Only the ``len(tokens) //
        page_size`` fully-covered pages are indexed — a partial last page
        will be appended to by decode, so its bytes are not a pure
        function of the prompt. Newly indexed pages take one trie-held
        refcount; chunks already present keep their existing page (the
        bytes are identical by construction).
        """
        self._tick += 1
        added = 0
        level = self._root
        for i, chunk in enumerate(self._chunks(tokens)):
            node = level.get(chunk)
            if node is None:
                pid = int(page_ids[i])
                allocator.incref(pid)
                node = _TrieNode(page=pid, tick=self._tick)
                level[chunk] = node
                added += 1
            else:
                node.tick = self._tick
            level = node.children
        self._n_pages += added
        self.pages_inserted += added
        return added

    def evict(self, allocator: PageAllocator, need: int) -> int:
        """Release up to ``need`` trie-only pages (refcount 1), LRU first.

        Only leaf nodes are candidates — dropping an interior node would
        orphan its (still-pinned) descendants from ``match``. Evicting a
        leaf can expose its parent, so the scan loops until ``need`` is
        met or nothing is evictable. Returns the number of pages freed.
        """
        freed = 0
        while freed < need:
            victim = self._find_lru_leaf(allocator)
            if victim is None:
                break
            parent, key = victim
            node = parent[key]
            del parent[key]
            allocator.decref(node.page)
            self._n_pages -= 1
            self.pages_evicted += 1
            freed += 1
        return freed

    def _find_lru_leaf(self, allocator: PageAllocator):
        """(parent-dict, chunk-key) of the oldest evictable leaf, or None."""
        best = None
        best_tick = None
        stack: list[tuple[dict, tuple, _TrieNode]] = [
            (self._root, k, n) for k, n in self._root.items()]
        while stack:
            parent, key, node = stack.pop()
            if node.children:
                stack.extend((node.children, k, n)
                             for k, n in node.children.items())
            elif allocator.refcount(node.page) == 1:
                if best_tick is None or node.tick < best_tick:
                    best, best_tick = (parent, key), node.tick
        return best

    def stats(self) -> dict:
        return {"pages": self._n_pages, "match_hits": self.match_hits,
                "pages_matched": self.pages_matched,
                "pages_inserted": self.pages_inserted,
                "pages_evicted": self.pages_evicted}

    def __repr__(self) -> str:
        return (f"PrefixTrie(pages={self._n_pages} "
                f"hits={self.match_hits} evicted={self.pages_evicted})")
