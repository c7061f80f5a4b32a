"""Host-side page pool for the paged decode cache.

One arena of ``num_pages`` fixed-size pages backs every sequence in the
engine; this pool tracks which page ids are free.  Allocation is
deterministic (lowest free id first) so engine runs are reproducible,
and all-or-nothing: a request either gets its whole page chain or
``None`` (the admission-control backpressure signal — nothing is
partially reserved).  The device never sees this structure; it only
sees the ``(batch, max_pages)`` page-table the engine builds from it.

Accounting is exactly zero-sum and aggressively checked: every page id
is either free or held by exactly one owner, double/foreign/duplicate
releases are refused loudly, and ``outstanding`` lets tests assert the
invariant after any alloc/release interleaving.
"""

from __future__ import annotations

from typing import Iterable, List, Optional


class PagePool:
    """Free-list allocator over ``num_pages`` pages of ``page_size``
    tokens."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError(
                f"PagePool needs positive sizes, got "
                f"num_pages={num_pages}, page_size={page_size}"
            )
        self.num_pages = num_pages
        self.page_size = page_size
        # descending so .pop() hands out the lowest id first
        self._free: List[int] = list(range(num_pages - 1, -1, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def outstanding(self) -> int:
        """Pages currently held by callers (zero-sum test hook)."""
        return self.num_pages - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` (ceil)."""
        return -(-n_tokens // self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages, or ``None`` (and take nothing) if fewer
        free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        return out

    def release(self, pages: Iterable[int]) -> None:
        """Return pages to the pool.

        Refuses foreign ids, pages that are already free AND duplicate
        ids within one call (the double-free check alone would miss
        those — neither copy is in the free list yet)."""
        pages = list(pages)
        seen: set = set()
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"release of foreign page id {p}")
            if p in self._free:
                raise ValueError(f"double release of page {p}")
            if p in seen:
                raise ValueError(f"duplicate page {p} in one release")
            seen.add(p)
        self._free.extend(pages)
        self._free.sort(reverse=True)

    def reserve(self, pages: Iterable[int]) -> None:
        """Mark specific page ids as held (warm-restart path: the
        engine re-claims exactly the chains its snapshot recorded).
        All-or-nothing: refuses if any id is foreign, duplicated or
        already held."""
        pages = list(pages)
        free = set(self._free)
        seen: set = set()
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"reserve of foreign page id {p}")
            if p not in free:
                raise ValueError(f"reserve of already-held page {p}")
            if p in seen:
                raise ValueError(f"duplicate page {p} in one reserve")
            seen.add(p)
        self._free = sorted(free - seen, reverse=True)
