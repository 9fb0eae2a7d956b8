"""Slot- and page-based KV cache management for the decode engine (port of
``repro.serving.kvcache``).

Host-side allocators (copied verbatim) track which slots/pages are live and
enforce the admission cap; device-side helpers gather/scatter per-request
cache slices so a scheduler-chosen sub-batch can be decoded without
touching delayed requests.

  * `SlotAllocator` — one contiguous ``max_len`` slot per request, a
    token-budget cap, prefix hits granted back as admission credits.
  * `PageAllocator` — fixed-size pages with per-request page tables and
    refcounted sharing; `gather_pages`/`scatter_pages` are the page-table
    twins of `gather_slots`/`scatter_slots`.

The reference's scatters return new arrays; here they write into the cache
or pool they are given, in place, and return it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig


def cache_batch_dim(cfg: ModelConfig, leaf_name: str) -> int:
    """Axis of the slot/batch dimension for each cache leaf."""
    if cfg.family == "hybrid" and leaf_name in ("conv", "state"):
        return 2  # (Ns, per, B, ...)
    return 1  # (L, B, ...) attention / ssm / encdec


def gather_slots(cfg: ModelConfig, cache: Dict, slot_idx: torch.Tensor) -> Dict:
    """Copy the slots ``slot_idx`` out of ``cache`` (each leaf's batch on
    `cache_batch_dim`) into a sub-batch cache."""
    return {name: leaf.index_select(cache_batch_dim(cfg, name), slot_idx)
            for name, leaf in cache.items()}


def scatter_slots(cfg: ModelConfig, cache: Dict, sub: Dict, slot_idx: torch.Tensor) -> Dict:
    """Write a sub-batch cache back into the slots ``slot_idx``, in place."""
    for name, leaf in cache.items():
        idx = [slice(None)] * cache_batch_dim(cfg, name)
        leaf[(*idx, slot_idx)] = sub[name]
    return cache


@dataclass
class SlotAllocator:
    """Host bookkeeping: slot ids + KV token budget (admission control).

    ``credit`` on `can_admit`/`alloc` is the prefix-cache allowance
    (`repro.serving.prefixcache`): tokens whose KV is shared with an
    already-admitted prompt don't charge the budget, so a prefix-heavy
    workload admits deeper than its raw token mass suggests. The charge is
    clamped to >= 0 and remembered per slot, keeping ``release`` symmetric.
    """

    max_slots: int
    kv_cap_tokens: int

    free: List[int] = field(default_factory=list)
    live_tokens: Dict[int, int] = field(default_factory=dict)
    # running sum of live_tokens: can_admit runs per queued request per
    # step, so it must not re-sum the live set on every call
    _used: int = field(default=0, init=False, repr=False)

    def __post_init__(self) -> None:
        self.free = list(range(self.max_slots))[::-1]
        self._used = sum(self.live_tokens.values())

    @property
    def used_tokens(self) -> int:
        return self._used

    def can_admit(self, need_tokens: int, credit: int = 0) -> bool:
        charged = max(0, need_tokens - credit)
        return bool(self.free) and self._used + charged <= self.kv_cap_tokens

    def alloc(self, need_tokens: int, credit: int = 0) -> Optional[int]:
        if not self.can_admit(need_tokens, credit):
            return None
        slot = self.free.pop()
        charged = max(0, need_tokens - credit)
        self.live_tokens[slot] = charged
        self._used += charged
        return slot

    def release(self, slot: int) -> None:
        if slot in self.live_tokens:
            self._used -= self.live_tokens.pop(slot)
            self.free.append(slot)

    def snapshot(self) -> Dict:
        # the free list is part of the state: its ORDER decides which slot
        # ids future allocs hand out, and replay/failover determinism (the
        # router's restore path) depends on reproducing exactly that
        return dict(live_tokens=dict(self.live_tokens), free=list(self.free))

    def restore(self, snap: Dict) -> None:
        self.live_tokens = dict(snap["live_tokens"])
        self._used = sum(self.live_tokens.values())
        if "free" in snap:
            self.free = list(snap["free"])
        else:  # legacy snapshot without a free list: synthesize a canonical one
            live = set(self.live_tokens)
            self.free = [s for s in range(self.max_slots) if s not in live][::-1]


def gather_pages(cfg: ModelConfig, pool: Dict, page_idx: torch.Tensor) -> Dict:
    """Assemble per-request contiguous cache views from a page pool.

    ``pool`` leaves are ``(L, n_pages, page_size, ...)``; ``page_idx`` is the
    ``(batch, pages_per_req)`` page table (pad rows/tails use the scratch
    page). Returns leaves shaped ``(L, batch, pages_per_req * page_size,
    ...)`` — exactly what `gather_slots` hands the model, so `decode_step`
    runs unchanged on top. Positions beyond a request's valid length land in
    scratch/garbage pages, which attention never reads (``kv_pos <
    kv_valid``), keeping paged logits bit-identical to slot mode.
    """
    b, p = page_idx.shape
    flat = page_idx.reshape(-1)
    out = {}
    for name, leaf in pool.items():
        if cache_batch_dim(cfg, name) != 1:
            raise ValueError(
                f"paged KV supports attention-style (L, B, T, ...) cache "
                f"leaves only; leaf {name!r} has its batch on another axis"
            )
        g = leaf.index_select(1, flat)
        out[name] = g.reshape(leaf.shape[0], b, p * leaf.shape[2], *leaf.shape[3:])
    return out


def scatter_pages(cfg: ModelConfig, pool: Dict, sub: Dict, page_idx: torch.Tensor) -> Dict:
    """Inverse of `gather_pages`: write per-request views back to the pool,
    in place.

    Shared pages appear in several rows of ``page_idx``; decode only ever
    writes at a request's *own* position (>= its private region), so every
    duplicate index carries the page's unchanged bytes and whichever
    duplicate write lands is the same value. Scratch-page duplicates hold
    garbage that nothing reads back.
    """
    b, p = page_idx.shape
    flat = page_idx.reshape(-1)
    for name, leaf in pool.items():
        ps = leaf.shape[2]
        leaf[:, flat] = sub[name].reshape(leaf.shape[0], b * p, ps, *leaf.shape[3:])
    return pool


@dataclass
class PageAllocator:
    """Host bookkeeping for a fixed-size KV page pool.

    Pages are the unit of both capacity and sharing: a request's table is
    ``[shared prefix pages..., private pages...]``; shared pages bump a
    refcount instead of copying, and a page returns to the free list only
    when its last reference drops. Used-token accounting is O(1) — the page
    is the granule, so ``used_tokens`` is just occupied pages x page size.

    ``evictor`` is the prefix cache's pressure hook: when the free list
    cannot cover an allocation the allocator asks the cache to surrender
    cold, unreferenced pages (never pages a live table still maps —
    refcount > its own retain) before giving up.
    """

    page_size: int
    n_pages: int

    free: List[int] = field(default_factory=list)
    refcount: Dict[int, int] = field(default_factory=dict)
    tables: Dict[int, List[int]] = field(default_factory=dict)  # owner -> pages
    evictor: Optional[Callable[[int], int]] = None  # want_pages -> freed_pages
    # cumulative telemetry (summary()/bench rows)
    shared_links: int = field(default=0, init=False)
    pressure_evictions: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {self.n_pages}")
        # mirror SlotAllocator: pop from the tail => page 0 handed out first
        self.free = list(range(self.n_pages))[::-1]

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def used_tokens(self) -> int:
        return (self.n_pages - len(self.free)) * self.page_size

    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(0, n_tokens) // self.page_size)

    def can_admit(self, n_tokens: int, shared: Sequence[int] = ()) -> bool:
        """Free-list check only (no eviction attempt): ``alloc_table`` may
        still succeed where this returns False by reclaiming cache pages."""
        return self.pages_needed(n_tokens) - len(shared) <= len(self.free)

    def alloc_table(
        self, owner: int, n_tokens: int, shared: Sequence[int] = ()
    ) -> Optional[List[int]]:
        """Build ``owner``'s page table for ``n_tokens`` of KV, linking
        ``shared`` prefix pages (refcount bump) and drawing the rest fresh.
        Returns None — state untouched — if even eviction can't cover it."""
        if owner in self.tables:
            raise ValueError(f"owner {owner} already holds a page table")
        need = self.pages_needed(n_tokens)
        n_fresh = need - len(shared)
        if n_fresh < 0:
            raise ValueError(
                f"{len(shared)} shared pages exceed the {need}-page need"
            )
        if n_fresh > len(self.free) and self.evictor is not None:
            self.pressure_evictions += self.evictor(n_fresh - len(self.free))
        if n_fresh > len(self.free):
            return None
        for p in shared:
            self.refcount[p] += 1
        self.shared_links += len(shared)
        table = list(shared)
        for _ in range(n_fresh):
            p = self.free.pop()
            self.refcount[p] = 1
            table.append(p)
        self.tables[owner] = table
        return list(table)

    def retain(self, page: int) -> None:
        self.refcount[page] += 1

    def release_page(self, page: int) -> None:
        rc = self.refcount[page] - 1
        if rc:
            self.refcount[page] = rc
        else:
            del self.refcount[page]
            self.free.append(page)

    def release_table(self, owner: int) -> None:
        for p in self.tables.pop(owner, ()):
            self.release_page(p)
