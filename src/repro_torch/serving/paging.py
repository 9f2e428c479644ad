"""Host-side page-pool accounting for the paged KV cache (the port's own
copy of ``repro.serving.paging``; nothing imported from the reference).

The device holds one physical page pool per attention layer: every cache
leaf whose spec carries a ``"seq"`` axis is reshaped from a dense
``(batch, max_len, ...)`` row layout to ``(n_pages + 1, page_size, ...)``
pages, and a per-slot ``page_table`` of physical page indices rides
inside the cache dict.  Physical page 0 is a pinned *trash* page: free
slots and unallocated table entries point at it, so masked or frozen-row
writes land somewhere harmless and reads of it are causally invisible
behind ``kv_valid``.

This module is the host bookkeeping half: refcounts, the free list,
worst-case commitment accounting (committed pages are reserved but not
yet allocated, so ``used + committed <= total`` means a committed slot
can never fail a later allocation), and the prefix-share index that lets
admissions deduplicate common prompt pages across requests and tenants.

Prefix index keying is collision-free by construction: a published page
is keyed by the *entire* token chain from position 0 through its own
last token, not by a hash of it, so two different prompts can never
alias the same entry.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.models.layers import TRASH_PAGE


@dataclass
class TorchPagePool:
    """Refcounted fixed-size page pool with commitment accounting.

    ``total`` counts usable pages; the trash page is physical index 0
    and is never allocated.  Invariants:

    - ``used_pages + free_pages == total``
    - ``used_pages + committed <= total`` (checked by :meth:`can_reserve`),
      so every page drawn against a prior commitment is guaranteed.
    """

    total: int
    page_size: int
    committed: int = 0
    peak_used: int = 0
    requests: int = 0
    conflicts: int = 0      # admissions refused for page shortage
    shared_hits: int = 0    # pages deduplicated via the prefix index
    cow_copies: int = 0     # shared pages privatized before a write
    stalls: int = 0         # decode rows clamped waiting on a free page
    _free: list[int] = field(default_factory=list, repr=False)
    _ref: dict[int, int] = field(default_factory=dict, repr=False)
    # chain (tokens before this page) -> {page tokens -> physical page}
    _index: dict[tuple, dict[tuple, int]] = field(default_factory=dict,
                                                  repr=False)
    _published: dict[int, tuple[tuple, tuple]] = field(default_factory=dict,
                                                       repr=False)

    def __post_init__(self) -> None:
        if self.total < 1:
            raise ValueError("page pool needs at least one usable page")
        if self.page_size < 1:
            raise ValueError("page_size must be positive")
        # pop() hands out low physical indices first
        self._free = list(range(self.total, 0, -1))

    # -- capacity ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.total - len(self._free)

    @property
    def uncommitted_free(self) -> int:
        """Pages neither allocated nor promised to an admitted request."""
        return max(0, len(self._free) - self.committed)

    def pages_for_tokens(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size)

    # -- commitment (UnitPool idiom) ---------------------------------------
    def can_reserve(self, n: int) -> bool:
        return self.used_pages + self.committed + n <= self.total

    def reserve(self, n: int) -> bool:
        """Reserve ``n`` future pages; counted as a conflict on refusal."""
        self.requests += 1
        if not self.can_reserve(n):
            self.conflicts += 1
            return False
        self.committed += n
        return True

    def unreserve(self, n: int) -> None:
        if n > self.committed:
            raise ValueError(f"uncommit({n}) exceeds committed "
                             f"{self.committed}")
        self.committed -= n

    # -- allocation --------------------------------------------------------
    def take_page(self, *, reserved: bool) -> int | None:
        """Pop a free page (refcount 1).

        ``reserved=True`` draws against a prior :meth:`reserve` (guaranteed
        to succeed); ``reserved=False`` only takes pages not promised to
        anyone else, returning ``None`` — a stall — when none remain.
        """
        if reserved:
            if self.committed < 1:
                raise RuntimeError("reserved alloc without commitment")
            self.committed -= 1
        elif len(self._free) <= self.committed:
            self.stalls += 1
            return None
        if not self._free:      # unreachable when invariants hold
            raise RuntimeError("page pool free list empty despite "
                               "commitment accounting")
        page = self._free.pop()
        self._ref[page] = 1
        self.peak_used = max(self.peak_used, self.used_pages)
        return page

    def retain_page(self, page: int) -> None:
        if page == TRASH_PAGE:
            return
        self._ref[page] += 1

    def release_page(self, page: int) -> bool:
        """Drop one reference; frees (and unpublishes) at zero."""
        if page == TRASH_PAGE:
            return False
        self._ref[page] -= 1
        if self._ref[page] > 0:
            return False
        del self._ref[page]
        self.unpublish_page(page)
        self._free.append(page)
        return True

    def page_refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    # -- prefix-share index ------------------------------------------------
    def publish_page(self, chain: tuple, tokens: tuple, page: int) -> None:
        """Advertise ``page`` as holding KV for ``tokens`` after ``chain``."""
        if page == TRASH_PAGE or not tokens:
            return
        self._index.setdefault(chain, {})[tokens] = page
        self._published[page] = (chain, tokens)

    def unpublish_page(self, page: int) -> None:
        entry = self._published.pop(page, None)
        if entry is None:
            return
        chain, tokens = entry
        bucket = self._index.get(chain)
        if bucket is not None and bucket.get(tokens) == page:
            del bucket[tokens]
            if not bucket:
                del self._index[chain]

    def lookup_page(self, chain: tuple, tokens: tuple) -> int | None:
        """Exact full-page match: a published page holding ``tokens``."""
        return self._index.get(chain, {}).get(tokens)

    def lookup_covering_page(self, chain: tuple, prefix: tuple) -> int | None:
        """Partial-tail match: a published page after ``chain`` whose
        tokens *start with* ``prefix`` — i.e. it already holds correct KV
        for the borrower's entire remaining prompt (anything beyond is
        causally masked until the borrower overwrites it post-COW)."""
        if not prefix:
            return None
        n = len(prefix)
        for tokens, page in self._index.get(chain, {}).items():
            if len(tokens) >= n and tokens[:n] == prefix:
                return page
        return None

    @property
    def published_pages(self) -> int:
        return len(self._published)


# The class has its own name and the reference's name is an alias: the
# repository's static analyzer (repro.analysis.callgraph) keys classes by
# bare name, and a second class named PagePool would merge with the
# reference's and shrink the reference's audited hot path.
PagePool = TorchPagePool
