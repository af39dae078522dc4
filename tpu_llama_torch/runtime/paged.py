"""Host-side page allocator for the paged KV cache.

Port of tpu_llama/runtime/paged.py (host bookkeeping, no device code; the
port keeps its own copy).  The device side is ``models.llama.PagedKVCache``
(shared pools + page table); this module owns the free list.  Policy: FULL
RESERVATION at admission -- a request reserves every page its step budget
could touch, so decode never fails mid-flight and retirement frees
everything at once.  Page 0 is the trash page: parked (inactive) slots keep
``page_table[slot, :] == 0`` and their decode writes land there, never on a
live page.

Pages are REFERENCE-COUNTED so that a prompt-prefix snapshot can pin the
pages it covers and later restores can map them read-only into other slots'
page-table rows (prefix sharing).  Sharing is safe because decode only
appends: a slot restored at ``pos = length`` writes into the page holding
``length`` and beyond -- the boundary page is private (copied at restore,
see ``reserve_with_prefix``), every earlier page is immutable.
"""

from __future__ import annotations

import numpy as np


class PagePool:
    def __init__(self, num_pages: int, page_size: int, slots: int, max_pages_per_slot: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_slot = max_pages_per_slot
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # pop() -> 1, 2, ...
        self._refs = np.zeros(num_pages, np.int32)  # live holds per page
        self._by_slot: dict[int, list[int]] = {}
        # host mirror of the device page table
        self.table = np.zeros((slots, max_pages_per_slot), np.int32)

    # ---- queries ----
    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    def can_reserve(self, n_tokens: int) -> bool:
        n = self.pages_needed(n_tokens)
        return n <= len(self._free) and n <= self.max_pages_per_slot

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    # ---- raw page holds (prefix snapshots) ----
    def alloc_page(self) -> int | None:
        """Take one page off the free list with refcount 1 (the caller owns
        it), or None when none is free."""
        if not self._free:
            return None
        p = self._free.pop()
        self._refs[p] = 1
        return p

    def retain(self, pages) -> None:
        """Add one hold to each page (they must already be live)."""
        for p in pages:
            assert self._refs[p] > 0, f"retain of dead page {p}"
            self._refs[p] += 1

    def release_pages(self, pages) -> None:
        """Drop one hold from each page; a page reaching zero returns to the
        free list."""
        for p in pages:
            assert self._refs[p] > 0, f"double free of page {p}"
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    # ---- slot lifecycle ----
    def reserve(self, slot: int, n_tokens: int) -> np.ndarray | None:
        """Reserve pages covering positions [0, n_tokens); returns the slot's
        page-table row, or None if the pool cannot satisfy it."""
        if slot in self._by_slot:
            raise ValueError(f"slot {slot} already holds pages")
        n = self.pages_needed(n_tokens)
        if n > len(self._free) or n > self.max_pages_per_slot:
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._refs[pages] = 1
        self._by_slot[slot] = pages
        self.table[slot] = 0
        self.table[slot, :n] = pages
        return self.table[slot].copy()

    def reserve_with_prefix(self, slot: int, n_tokens: int, prefix_pages, prefix_len: int):
        """Reserve a slot whose first ``prefix_len`` positions are already in
        ``prefix_pages`` (a snapshot's pin list).  Fully covered prefix pages
        are SHARED into the row (refcount + 1); the boundary page -- the one
        position ``prefix_len`` lands in when ``prefix_len % page_size != 0``
        -- stays private to the slot (decode appends into it), so a fresh
        page is reserved for it and the caller is told to device-copy
        ``(src_page, dst_page)``.  The rest of the capacity up to
        ``n_tokens`` comes from the free list.  Returns ``(row, copies)``, or
        None if the pool cannot satisfy it."""
        if slot in self._by_slot:
            raise ValueError(f"slot {slot} already holds pages")
        n = self.pages_needed(max(n_tokens, prefix_len))
        n_shared = prefix_len // self.page_size  # full pages only
        boundary = prefix_len % self.page_size != 0
        assert len(prefix_pages) >= n_shared + (1 if boundary else 0)
        n_fresh = n - n_shared
        if n > self.max_pages_per_slot or n_fresh > len(self._free):
            return None
        shared = [int(p) for p in prefix_pages[:n_shared]]
        fresh = [self._free.pop() for _ in range(n_fresh)]
        self.retain(shared)
        self._refs[fresh] = 1
        pages = shared + fresh
        self._by_slot[slot] = pages
        self.table[slot] = 0
        self.table[slot, :len(pages)] = pages
        copies = [(int(prefix_pages[n_shared]), fresh[0])] if boundary and fresh else []
        return self.table[slot].copy(), copies

    def release(self, slot: int) -> bool:
        """Drop the slot's hold on all of its pages; True if it held any.
        Shared pages outlive the slot while a snapshot pins them."""
        pages = self._by_slot.pop(slot, None)
        if pages is None:
            return False
        self.release_pages(pages)
        self.table[slot] = 0
        return True

    def held(self, slot: int) -> int:
        return len(self._by_slot.get(slot, ()))
