"""Paged posit KV-cache: page pool, per-slot page tables, allocator.

Counterpart of ``repro.serving.kvcache`` (pure Python bookkeeping; the
device pool itself is ``Model.init_paged_cache``):

* a **page pool** — one preallocated ``[num_pages, page_size, KV, hd]``
  posit-word buffer per layer;
* **per-slot page tables** — ``slot -> [n_logical]`` int32 rows mapping
  logical cache pages to physical pool pages;
* an **allocator** with alloc-on-prefill / grow-on-decode /
  free-on-retire, surfacing pool exhaustion as :class:`PagePoolOOM` so
  the ``RequestBatcher`` can reclaim, preempt or hold admission.

Reserved pages: physical page 0 (``NULL_PAGE``) backs every unallocated
table entry and is never written, so gathers past a slot's frontier read
exact zeros; physical page 1 (``TRASH_PAGE``) is the write sink for masked
decode rows and never appears in a table.  The allocator hands out pages
``2..num_pages-1``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels.paged_decode import (NULL_PAGE, RESERVED_PAGES,
                                              TRASH_PAGE)

__all__ = ["PagePoolOOM", "PagedKVConfig", "PageAllocator", "PagedKVCache",
           "NULL_PAGE", "TRASH_PAGE", "RESERVED_PAGES"]


class PagePoolOOM(RuntimeError):
    """Page pool exhausted — the caller must backpressure or preempt."""


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Engine-facing knobs for the paged KV cache.

    ``page_size`` tokens per page (``max_len`` must be a multiple).
    ``num_pages``: total physical pages INCLUDING the two reserved ones;
    ``None`` sizes the pool for full occupancy of every slot plus
    headroom — the "never worse than dense" default; serving deployments
    shrink it to oversubscribe HBM.
    """
    page_size: int = 16
    num_pages: int | None = None

    def resolve_pages(self, batch: int, max_len: int) -> int:
        n_logical = max_len // self.page_size
        if self.num_pages is not None:
            lo = n_logical + 1 + RESERVED_PAGES  # one full slot + grow room
            if self.num_pages < lo:
                raise ValueError(
                    f"num_pages={self.num_pages} cannot hold one max_len "
                    f"request (need >= {lo})")
            return self.num_pages
        return batch * n_logical + 1 + RESERVED_PAGES


class PageAllocator:
    """Free-list allocator over physical pages ``RESERVED_PAGES..P-1``.

    Fresh pages are handed out in ascending order; freed pages are reused
    LIFO (most-recently-freed first), which keeps reuse hot and makes the
    fragmentation property tests deterministic.
    """

    def __init__(self, num_pages: int):
        if num_pages <= RESERVED_PAGES:
            raise ValueError(f"num_pages={num_pages} leaves no usable pages")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, RESERVED_PAGES - 1, -1))
        self._used: set[int] = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._used)

    def alloc(self) -> int:
        if not self._free:
            raise PagePoolOOM(
                f"page pool exhausted ({self.used_count} pages live)")
        p = self._free.pop()
        self._used.add(p)
        return p

    def free(self, page: int) -> None:
        if page < RESERVED_PAGES or page >= self.num_pages:
            raise ValueError(f"page {page} outside allocatable range")
        if page not in self._used:
            raise ValueError(f"double free of page {page}")
        self._used.remove(page)
        self._free.append(page)


class PagedKVCache:
    """Host-side page tables + allocator for ``batch`` serving slots.

    The device pool itself lives in the engine's cache pytree; this class
    owns the mapping.  ``table_device()`` materializes the current table
    as a tensor (cached until the mapping changes) for the decode
    step's gather/scatter.
    """

    def __init__(self, batch: int, max_len: int, page_size: int,
                 num_pages: int):
        if max_len % page_size:
            raise ValueError(f"max_len={max_len} not a multiple of "
                             f"page_size={page_size}")
        self.batch = batch
        self.max_len = max_len
        self.page_size = page_size
        self.n_logical = max_len // page_size
        self.alloc = PageAllocator(num_pages)
        self.table = np.full((batch, self.n_logical), NULL_PAGE, np.int32)
        self._slot_pages: list[list[int]] = [[] for _ in range(batch)]
        self.peak_pages = 0
        self._dev_table = None

    # -- mapping mutations --------------------------------------------------
    def _dirty(self):
        self._dev_table = None
        self.peak_pages = max(self.peak_pages, self.alloc.used_count)

    def alloc_slot(self, slot: int, n_pages: int) -> list[int]:
        """Allocate ``n_pages`` for a fresh request in ``slot``.

        Admission headroom rule: unless the request already spans the full
        ``max_len``, one extra free page must remain after allocation so
        the request can take at least one decode-growth step — otherwise a
        fully-admitted pool could deadlock with every slot needing growth.
        Raises :class:`PagePoolOOM` (state unchanged) when that fails.
        """
        if not 0 <= slot < self.batch:
            raise ValueError(f"slot {slot} out of range")
        if self._slot_pages[slot]:
            raise ValueError(f"slot {slot} already holds pages")
        if not 1 <= n_pages <= self.n_logical:
            raise ValueError(f"n_pages={n_pages} not in [1, {self.n_logical}]")
        headroom = 0 if n_pages == self.n_logical else 1
        if self.alloc.free_count < n_pages + headroom:
            raise PagePoolOOM(
                f"need {n_pages}+{headroom} pages, {self.alloc.free_count} free")
        pages = [self.alloc.alloc() for _ in range(n_pages)]
        self._slot_pages[slot] = pages
        self.table[slot, :n_pages] = pages
        self._dirty()
        return pages

    def grow_slot(self, slot: int) -> int:
        """Append one physical page to ``slot`` (decode crossed a page
        boundary).  Raises :class:`PagePoolOOM` when the pool is dry —
        the batcher preempts a victim and retries."""
        pages = self._slot_pages[slot]
        if not pages:
            raise ValueError(f"slot {slot} holds no pages")
        if len(pages) >= self.n_logical:
            raise ValueError(f"slot {slot} already at max_len")
        p = self.alloc.alloc()
        pages.append(p)
        self.table[slot, len(pages) - 1] = p
        self._dirty()
        return p

    def free_slot(self, slot: int) -> None:
        for p in self._slot_pages[slot]:
            self.alloc.free(p)
        self._slot_pages[slot] = []
        self.table[slot, :] = NULL_PAGE
        self._dirty()

    def reset(self) -> None:
        for s in range(self.batch):
            if self._slot_pages[s]:
                self.free_slot(s)
        self.peak_pages = 0

    # -- queries ------------------------------------------------------------
    def n_pages(self, slot: int) -> int:
        return len(self._slot_pages[slot])

    def pages_of(self, slot: int) -> list[int]:
        return list(self._slot_pages[slot])

    @property
    def live_pages(self) -> int:
        return self.alloc.used_count

    def table_device(self, device="cpu"):
        """The table as an int32 tensor on ``device`` (cached until the
        mapping changes)."""
        import torch
        if self._dev_table is None or self._dev_table.device != torch.device(device):
            self._dev_table = torch.from_numpy(self.table.copy()).to(device)
        return self._dev_table

    # -- failover -----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serializable mapping state.  The pool bytes ride in the
        engine's array-tree snapshot; this is what makes them addressable
        again after a resume."""
        return {"page_size": self.page_size,
                "num_pages": self.alloc.num_pages,
                "peak_pages": self.peak_pages,
                "slot_pages": [list(p) for p in self._slot_pages]}

    def load(self, snap: dict) -> None:
        """Restore :meth:`snapshot`: every slot claims the exact physical
        pages it recorded, so the restored tables address the restored pool
        bytes unchanged.  A geometry mismatch or a page claimed twice
        raises."""
        if snap["page_size"] != self.page_size \
                or snap["num_pages"] != self.alloc.num_pages:
            raise ValueError("paged snapshot geometry mismatch")
        self.reset()
        for slot, pages in enumerate(snap["slot_pages"]):
            if not pages:
                continue
            if len(pages) > self.n_logical:
                raise ValueError(f"slot {slot} snapshot exceeds max_len")
            for p in pages:
                if p in self.alloc._used:
                    raise ValueError(f"page {p} claimed twice in snapshot")
                self.alloc._free.remove(p)
                self.alloc._used.add(p)
            self._slot_pages[slot] = list(pages)
            self.table[slot, :len(pages)] = pages
            self._dirty()
        self.peak_pages = max(self.peak_pages, snap.get("peak_pages", 0))
