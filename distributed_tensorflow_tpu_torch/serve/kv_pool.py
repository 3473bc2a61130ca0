"""KV storage for the serving engine: slot-pooled and block-paged layouts.

Counterpart of ``distributed_tensorflow_tpu/serve/kv_pool.py`` without the
page handoff surface (``export_pages``, ``snapshot_pages``,
``import_pages``). The pools are torch tensors on the engine's device; the
page tables, refcounts and free lists stay host numpy and Python lists, so
the scheduler's view of capacity never needs a device sync.

* :class:`SlotKVPool` — the monolithic layout: per-layer K/V buffers
  ``(slots, kv_heads, max_len, head_dim)``, one worst-case row per slot
  (the engine's ``page_size=0`` mode).

* :class:`PagedKVPool` — one physical pool of fixed-size pages per layer,
  ``(num_pages, kv_heads, page_size, head_dim)``, plus a per-slot page
  table ``(slots, pages_per_slot)`` of physical page ids. Physical page 0
  is the reserved TRASH page: unbound table entries point at it, masked
  lanes write into it, and nothing reads it as a key that counts.

Pages are REFCOUNTED so immutable full-prompt pages can be shared between
slots and held by the :class:`PrefixCache`: a slot's allocation holds one
reference, prefix adoption adds one per adopting slot, and the cache holds
one of its own. A page returns to the free list only at refcount zero.
Sharing is safe because writes start at the filled length ``p``, strictly
above every full prompt page (``serve/engine.py``).

The :class:`PrefixCache` keys pages by the EXACT BYTES of the token prefix
they complete, so a lookup can never adopt a colliding request's KV;
entries are LRU-evicted when the pool runs out of pages.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.models.decoding import init_cache

__all__ = [
    "SlotKVPool",
    "PagedKVPool",
    "PrefixCache",
    "InsufficientPages",
    "TRASH_PAGE",
]

# Physical page 0: never allocated, never freed, absorbs the writes of
# unbound table entries and masked lanes.
TRASH_PAGE = 0


def _page_scatter(layers, idx, rows) -> None:
    """Write ``rows`` (a list like ``layers`` of per-leaf tensors with a
    leading page axis) into the pages ``idx`` of every leaf, in place."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=layers[0]["k"].device)
    for layer, new in zip(layers, rows):
        for name, buf in layer.items():
            buf[idx] = torch.as_tensor(new[name]).to(device=buf.device, dtype=buf.dtype)


class InsufficientPages(RuntimeError):
    """Admission-time: the pool cannot back this request right now. The
    scheduler requeues the request at the head of its lane — pages free as
    in-flight requests complete, so progress is guaranteed (every active
    request holds ALL its pages up front; nothing allocates mid-decode)."""


def _bytes(layers) -> int:
    return sum(buf.numel() * buf.element_size() for layer in layers for buf in layer.values())


class SlotKVPool:
    """Fixed-capacity pooled KV buffers + free-slot bookkeeping. ``layers``
    is a list of per-layer ``{"k", "v"}`` tensors with a leading ``slots``
    axis, written in place by the engine."""

    def __init__(self, cfg, slots: int, max_len: int, device: torch.device | str = "cpu"):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.cfg = cfg
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.layers = init_cache(cfg, slots, max_len, device=device)["layers"]
        # LIFO reuse, with an O(1) companion set for the double-free check.
        self._free: list[int] = list(range(slots - 1, -1, -1))
        self._free_set: set[int] = set(self._free)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.slots

    @property
    def hbm_bytes(self) -> int:
        return _bytes(self.layers)

    @property
    def hbm_bytes_per_slot(self) -> float:
        return self.hbm_bytes / self.slots

    @property
    def bytes_per_token(self) -> float:
        return self.hbm_bytes / (self.slots * self.max_len)

    def alloc(self) -> int | None:
        """Claim a slot index, or None when the pool is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._free_set.discard(slot)
        return slot

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        if slot in self._free_set:
            raise ValueError(f"double free of slot {slot}")
        self._free.append(slot)
        self._free_set.add(slot)

    def compile_count(self) -> int:
        return 0  # the pool runs no programs of its own


class PagedKVPool:
    """Block-granular physical KV pool + per-slot page tables (host numpy).
    The engine's programs read a slot's pages through its table row and
    write the positions they fill in place."""

    def __init__(self, cfg, slots: int, max_len: int, page_size: int,
                 num_pages: int = 0, device: torch.device | str = "cpu"):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of page_size "
                f"{page_size} (fixed-shape table rows need a whole number "
                f"of pages per slot)"
            )
        self.cfg = cfg
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.pages_per_slot = max_len // page_size
        if num_pages == 0:
            # Worst case for every slot + the trash page: no oversubscription.
            num_pages = self.slots * self.pages_per_slot + 1
        if num_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"num_pages {num_pages} cannot back even one worst-case "
                f"request ({self.pages_per_slot} pages) + the trash page"
            )
        self.num_pages = int(num_pages)
        # init_cache with batch=num_pages, len=page_size IS the paged layout.
        self.layers = init_cache(cfg, self.num_pages, page_size, device=device)["layers"]
        self._free_pages: list[int] = list(range(self.num_pages - 1, 0, -1))
        self._free_page_set: set[int] = set(self._free_pages)
        self.refcount = np.zeros(self.num_pages, np.int64)
        self.refcount[TRASH_PAGE] = 1  # pinned — never allocatable
        self.page_tables = np.full((self.slots, self.pages_per_slot), TRASH_PAGE, np.int32)
        self._free_slots: list[int] = list(range(slots - 1, -1, -1))
        self._free_slot_set: set[int] = set(self._free_slots)

    # -- capacity views ---------------------------------------------------

    @property
    def num_free(self) -> int:
        """Free SLOT count (engine lane capacity; pages gate separately)."""
        return len(self._free_slots)

    @property
    def pages_free(self) -> int:
        return len(self._free_pages)

    @property
    def pages_allocatable(self) -> int:
        return self.num_pages - 1  # minus trash

    @property
    def occupancy(self) -> float:
        """PAGE occupancy — under paging, capacity is pages-free."""
        return 1.0 - self.pages_free / self.pages_allocatable

    @property
    def hbm_bytes(self) -> int:
        return _bytes(self.layers)

    @property
    def hbm_bytes_per_slot(self) -> float:
        return self.hbm_bytes / self.slots

    @property
    def bytes_per_token(self) -> float:
        """KV bytes one token position costs across all layers."""
        return self.hbm_bytes / (self.num_pages * self.page_size)

    def pages_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        return -(-(prompt_len + max_new_tokens) // self.page_size)  # ceil

    def pages_bound(self, slot: int) -> int:
        """Pages currently bound in ``slot``'s table row (TRASH excluded)."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        return int(np.count_nonzero(self.page_tables[slot] != TRASH_PAGE))

    # -- slot bookkeeping --------------------------------------------------

    def alloc(self) -> int | None:
        if not self._free_slots:
            return None
        slot = self._free_slots.pop()
        self._free_slot_set.discard(slot)
        return slot

    def free(self, slot: int) -> None:
        """Release a slot AND its page references. The table row resets to
        TRASH so a later (masked) lane write can never land in a page that
        has been handed to another slot."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        if slot in self._free_slot_set:
            raise ValueError(f"double free of slot {slot}")
        for pid in self.page_tables[slot]:
            if pid != TRASH_PAGE:
                self.decref(int(pid))
        self.page_tables[slot, :] = TRASH_PAGE
        self._free_slots.append(slot)
        self._free_slot_set.add(slot)

    # -- page bookkeeping --------------------------------------------------

    def alloc_pages(self, n: int) -> list[int] | None:
        """Claim ``n`` physical pages (refcount 1 each), or None if the
        free list is short. All-or-nothing."""
        if n > len(self._free_pages):
            return None
        pages = [self._free_pages.pop() for _ in range(n)]
        for pid in pages:
            self._free_page_set.discard(pid)
            self.refcount[pid] = 1
        return pages

    def incref(self, pid: int) -> None:
        if pid == TRASH_PAGE or not 0 < pid < self.num_pages:
            raise ValueError(f"incref of invalid page {pid}")
        if pid in self._free_page_set:
            raise ValueError(f"incref of free page {pid}")
        self.refcount[pid] += 1

    def decref(self, pid: int) -> None:
        if pid == TRASH_PAGE or not 0 < pid < self.num_pages:
            raise ValueError(f"decref of invalid page {pid}")
        if pid in self._free_page_set:
            raise ValueError(f"double free of page {pid}")
        self.refcount[pid] -= 1
        if self.refcount[pid] == 0:
            self._free_pages.append(pid)
            self._free_page_set.add(pid)

    def bind(self, slot: int, page_ids: list[int]) -> None:
        """Point ``slot``'s table at ``page_ids`` (prefix-adopted pages
        first, then the slot's own); unbound tail entries stay TRASH."""
        if len(page_ids) > self.pages_per_slot:
            raise ValueError(f"{len(page_ids)} pages > pages_per_slot {self.pages_per_slot}")
        self.page_tables[slot, :] = TRASH_PAGE
        self.page_tables[slot, : len(page_ids)] = np.asarray(page_ids, np.int32)

    def scatter_pages(self, page_ids, layer_rows) -> None:
        """Write whole pages: ``layer_rows`` per layer ``{"k", "v"}`` with a
        leading axis of ``len(page_ids)``."""
        _page_scatter(self.layers, page_ids, layer_rows)

    def compile_count(self) -> int:
        return 0  # every program lives in the engine


class PrefixCache:
    """Exact-prefix index over immutable full pages, refcounted + LRU.

    Key: the raw bytes of the token prefix a page COMPLETES (int32,
    little-endian). Value: the physical page id. The cache holds its own
    reference on every indexed page; ``match`` adds one per adopting slot,
    ``evict_for`` drops LRU entries (cache reference only)."""

    def __init__(self, pool: PagedKVPool):
        self.pool = pool
        self._entries: OrderedDict[bytes, int] = OrderedDict()
        self.tokens_matched = 0
        self.tokens_looked_up = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(prompt: np.ndarray, n_pages: int, page_size: int) -> bytes:
        return prompt[: n_pages * page_size].astype("<i4").tobytes()

    def match(self, prompt: np.ndarray, max_pages: int) -> list[int]:
        """Longest chain of cached full pages covering a prefix of
        ``prompt`` (at most ``max_pages``), each increffed for the adopting
        slot; matched entries touch LRU recency."""
        ps = self.pool.page_size
        pages: list[int] = []
        for i in range(1, max_pages + 1):
            key = self._key(prompt, i, ps)
            pid = self._entries.get(key)
            if pid is None:
                break
            self._entries.move_to_end(key)
            pages.append(pid)
        for pid in pages:
            self.pool.incref(pid)
        return pages

    def record_lookup(self, matched_tokens: int, prompt_tokens: int) -> None:
        self.tokens_matched += matched_tokens
        self.tokens_looked_up += prompt_tokens

    @property
    def hit_rate(self) -> float:
        if self.tokens_looked_up == 0:
            return 0.0
        return self.tokens_matched / self.tokens_looked_up

    def insert(self, prompt: np.ndarray, page_ids) -> None:
        """Index ``prompt``'s full pages (``page_ids[i]`` backs page ``i``).
        Already-indexed prefixes keep their existing (shared) page."""
        ps = self.pool.page_size
        n_full = min(len(page_ids), len(prompt) // ps)
        for i in range(n_full):
            key = self._key(prompt, i + 1, ps)
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            pid = int(page_ids[i])
            self.pool.incref(pid)
            self._entries[key] = pid

    def evict_for(self, pages_wanted: int) -> int:
        """Drop LRU entries until the pool could satisfy ``pages_wanted``
        (or the cache is empty). Returns entries evicted."""
        evicted = 0
        while (self.pool.pages_free < pages_wanted) and self._entries:
            _, pid = self._entries.popitem(last=False)
            self.pool.decref(pid)
            evicted += 1
        return evicted

    def clear(self) -> None:
        while self._entries:
            _, pid = self._entries.popitem(last=False)
            self.pool.decref(pid)
