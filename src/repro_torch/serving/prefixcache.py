"""Hash-prefix trie over admitted prompts (prefix-cache-aware admission).

Prompts are chunked into fixed-size token blocks and each block is keyed by
a CRC32 chain hash of (parent hash, block tokens) — the vLLM-style scheme
where a block's identity embeds its whole prefix, so a plain dict of node
hashes behaves as a trie without storing token strings. Two call sites:

  * **Session admission** (`ServeSession.submit`): every admitted prompt is
    matched then inserted; the matched token count becomes the request's
    ``prefix_hit_tokens``, which (a) feeds the per-session hit accounting
    in `SessionMetrics` and (b) is granted back to the `SlotAllocator` as a
    KV token-budget *credit* — reused prefix KV doesn't charge the cap.
  * **Router affinity** (`repro_torch.serving.router`): the router keeps one
    `PrefixCache` per replica as its *own* record of which prefixes it sent
    where (a real router can't see replica internals), and the
    ``prefix-affinity`` policy routes to the replica with the longest match.

Accounting-only caches (no allocator attached) never skip compute: the
engine still prefills every token, so token outputs are invariant to the
cache (the engine-wide "policy changes timing, never tokens" contract).
*Page-mapped* caches (constructed with a `PageAllocator`) additionally bind
each node to a live KV page once a request's prefill lands (`assign_pages`),
and from then on a matched block is **real reuse**: the hit request links
the page into its own table (refcount bump) and prefill genuinely skips
those tokens. Hash collisions merge paths; with CRC32 chaining over full
prefixes they are vanishingly rare at serving scale and only perturb
accounting, never correctness (a collision could at worst alias a page of
valid KV from a different prompt — the same failure class vLLM accepts).

Capacity: ``max_blocks`` bounds the trie; over budget, least-recently-used
*leaf* nodes are evicted (interior nodes are pinned by their children, so
eviction always removes a longest suffix first — the trie never holds a
block whose prefix it has dropped). Eviction never removes nodes pinned by
in-flight requests (``pin``/`admit` with a rid, released by ``release``)
nor nodes whose page is still mapped by a live table (page refcount above
the cache's own retain) — dropping either would invalidate accounting or
tear KV out from under an admitted request. Page-mapped caches also serve
as the allocator's pressure ``evictor``: when the free list runs dry the
allocator reclaims cold unpinned cached pages before failing an admission.

See DESIGN.md §router and §kvcache.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.kvcache import PageAllocator

_ROOT = 0  # chain hash of the empty prefix

# The one default block size, shared by every constructor that builds a
# cache (`PrefixCache`, `RouterSession`) so hit rates measured anywhere are
# comparable by default; the harness overrides it for its tiny engine twins
# (`HarnessConfig.prefix_block`).
DEFAULT_PREFIX_BLOCK = 16


def _chain_hash(parent: int, block: Sequence[int]) -> int:
    """CRC32 of (parent hash ‖ block tokens): a block id that encodes its
    full prefix, so equal ids mean equal token paths (modulo collisions)."""
    data = struct.pack(f"<q{len(block)}q", parent, *[int(t) for t in block])
    h = zlib.crc32(data)
    return h if h != _ROOT else 1  # never collide with the root sentinel


@dataclass
class _Node:
    parent: int
    n_children: int = 0
    last_used: int = 0
    pins: int = 0  # in-flight requests whose admitted path crosses this node
    page: Optional[int] = None  # live KV page id (page-mapped caches only)


@dataclass
class _Pin:
    """One in-flight request's hold on the trie: the node path it admitted
    against (kept un-evictable until release) and the live pages its table
    links (the engine prices/skips exactly these)."""

    path: Tuple[int, ...]
    pages: Tuple[int, ...] = ()
    hit_tokens: int = 0


@dataclass
class PrefixCacheStats:
    """Cumulative accounting for one `PrefixCache`."""

    lookups: int = 0  # admit() calls
    hits: int = 0  # admits that matched >= 1 block
    lookup_tokens: int = 0  # full-block tokens eligible for matching
    hit_tokens: int = 0  # tokens served from the trie
    inserted_blocks: int = 0
    evicted_blocks: int = 0

    @property
    def hit_rate(self) -> float:
        """Token-weighted hit rate over everything admitted so far."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens else 0.0

    def as_dict(self) -> Dict:
        return dict(
            lookups=self.lookups,
            hits=self.hits,
            lookup_tokens=self.lookup_tokens,
            hit_tokens=self.hit_tokens,
            hit_rate=self.hit_rate,
            inserted_blocks=self.inserted_blocks,
            evicted_blocks=self.evicted_blocks,
        )


class PrefixCache:
    """Block-hashed prefix trie with LRU leaf eviction and hit accounting.

    With ``pages`` (a `PageAllocator`) the trie is *page-mapped*: nodes carry
    live page ids, matches hand back shareable pages, and the cache doubles
    as the allocator's pressure evictor. ``block`` must equal the allocator's
    page size so one trie node == one page.
    """

    def __init__(
        self,
        block: int = DEFAULT_PREFIX_BLOCK,
        max_blocks: Optional[int] = None,
        pages: Optional[PageAllocator] = None,
    ):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if max_blocks is not None and max_blocks < 1:
            raise ValueError(f"max_blocks must be >= 1 or None, got {max_blocks}")
        if pages is not None and pages.page_size != block:
            raise ValueError(
                f"page-mapped cache needs block == page_size "
                f"({block} != {pages.page_size})"
            )
        self.block = block
        self.max_blocks = max_blocks
        self.pages = pages
        if pages is not None:
            pages.evictor = self._evict_pages
        self.stats = PrefixCacheStats()
        self._nodes: Dict[int, _Node] = {}
        self._pins: Dict[int, _Pin] = {}  # rid -> in-flight hold
        self._tick = 0  # logical LRU clock (no wall time: determinism)

    def __len__(self) -> int:
        return len(self._nodes)

    # ---------------------------------------------------------------- match
    def _blocks(self, tokens: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
        b = self.block
        n_full = len(tokens) // b
        return tuple(tuple(tokens[i * b : (i + 1) * b]) for i in range(n_full))

    def match(self, tokens: Sequence[int]) -> int:
        """Longest cached prefix of ``tokens`` in whole tokens (full blocks
        only). Pure peek: no insertion, no stats, no LRU touch — safe for
        routing probes that will not land the request here."""
        h = _ROOT
        matched = 0
        for blk in self._blocks(tokens):
            h = _chain_hash(h, blk)
            if h not in self._nodes:
                break
            matched += len(blk)
        return matched

    def _max_hit_tokens(self, tokens: Sequence[int]) -> int:
        # page-mapped hits skip real compute, and prefill must still emit
        # the first decode logits — so at least one prompt token always runs
        return ((len(tokens) - 1) // self.block) * self.block if tokens else 0

    def match_pages(self, tokens: Sequence[int]) -> Tuple[int, Tuple[int, ...]]:
        """Page-backed variant of `match`: longest *live-page* prefix and the
        page ids backing it, clamped so >= 1 prompt token is left to prefill.
        Pure peek, like `match`."""
        if self.pages is None:
            return 0, ()
        cap = self._max_hit_tokens(tokens) // self.block
        h = _ROOT
        pages: List[int] = []
        for blk in self._blocks(tokens)[:cap]:
            h = _chain_hash(h, blk)
            node = self._nodes.get(h)
            if node is None or node.page is None:
                break
            pages.append(node.page)
        return len(pages) * self.block, tuple(pages)

    # ---------------------------------------------------------------- admit
    def admit(self, tokens: Sequence[int], rid: Optional[int] = None) -> Tuple[int, int]:
        """Match then insert an admitted prompt; returns ``(hit_tokens,
        eligible_tokens)`` where eligible is the full-block token count the
        lookup could at best have matched.

        ``rid`` pins the prompt's whole node path until ``release(rid)``:
        eviction must not drop blocks an in-flight request's accounting (or,
        page-mapped, its KV table) still references. Page-mapped caches
        count only live-page-backed blocks as hits (clamped to leave >= 1
        token of real prefill) and record the shared pages for
        ``shared_pages(rid)``; accounting-only caches keep the PR-5
        behaviour where any trie match is a credit.
        """
        blocks = self._blocks(tokens)
        eligible = sum(len(b) for b in blocks)
        paged = self.pages is not None
        cap = self._max_hit_tokens(tokens) // self.block if paged else len(blocks)
        self._tick += 1
        h = _ROOT
        hit = 0
        pages: List[int] = []
        path: List[int] = []
        matching = True
        for i, blk in enumerate(blocks):
            parent = h
            h = _chain_hash(h, blk)
            path.append(h)
            node = self._nodes.get(h)
            if node is not None:
                node.last_used = self._tick
                if matching:
                    if paged and (node.page is None or i >= cap):
                        matching = False
                    else:
                        hit += len(blk)
                        if paged:
                            pages.append(node.page)
                continue
            matching = False
            self._nodes[h] = _Node(parent=parent, last_used=self._tick)
            if parent != _ROOT:
                self._nodes[parent].n_children += 1
            self.stats.inserted_blocks += 1
        if rid is not None:
            self._pin_path(rid, path, pages, hit)
        s = self.stats
        s.lookups += 1
        s.lookup_tokens += eligible
        s.hit_tokens += hit
        if hit:
            s.hits += 1
        self._evict()
        return hit, eligible

    # ----------------------------------------------------------------- pins
    def _pin_path(
        self, rid: int, path: Sequence[int], pages: Sequence[int], hit: int
    ) -> None:
        if rid in self._pins:  # defensive: duplicate rids must not leak pins
            self.release(rid)
        for h in path:
            node = self._nodes.get(h)
            if node is not None:
                node.pins += 1
        self._pins[rid] = _Pin(path=tuple(path), pages=tuple(pages), hit_tokens=hit)

    def pin_match(self, tokens: Sequence[int], rid: int) -> Tuple[int, Tuple[int, ...]]:
        """Pin the live-page match *without inserting* the prompt — the
        disagg fleet probes decode-side caches at submit time, long before
        the prompt's own KV lands anywhere (insertion happens at `attach` via
        `assign_pages`, on whichever worker actually decodes it)."""
        hit, pages = self.match_pages(tokens)
        path = []
        h = _ROOT
        for blk in self._blocks(tokens)[: len(pages)]:
            h = _chain_hash(h, blk)
            path.append(h)
        self._pin_path(rid, path, pages, hit)
        return hit, pages

    def release(self, rid: int) -> None:
        """Drop ``rid``'s pins (idempotent). Called when the request leaves
        the system — completed, cancelled, or failed admission."""
        pin = self._pins.pop(rid, None)
        if pin is None:
            return
        for h in pin.path:
            node = self._nodes.get(h)
            if node is not None and node.pins > 0:
                node.pins -= 1
        self._evict()

    def shared_pages(self, rid: int) -> Tuple[int, ...]:
        """Live page ids ``rid``'s admit/pin matched, in prefix order."""
        pin = self._pins.get(rid)
        return pin.pages if pin is not None else ()

    @property
    def pinned_requests(self) -> int:
        return len(self._pins)

    # ---------------------------------------------------------------- pages
    def assign_pages(self, tokens: Sequence[int], table: Sequence[int]) -> int:
        """Bind a landed prompt's full blocks to its table's pages (called
        from `DecodeEngine.attach` once the KV is really in the pool).
        Missing nodes are inserted — on the disagg fleet the decode worker
        that receives a handoff never saw the prompt at admit time. Each
        newly bound page is retained (the cache's own reference); already
        page-backed nodes are left alone (first binding wins — the existing
        page holds identical KV by construction). Returns pages bound."""
        if self.pages is None:
            raise ValueError("assign_pages requires a page-mapped cache")
        self._tick += 1
        bound = 0
        h = _ROOT
        for blk, page in zip(self._blocks(tokens), table):  # noqa: B905 - table may exceed full prompt blocks; zip stops at the shorter
            parent = h
            h = _chain_hash(h, blk)
            node = self._nodes.get(h)
            if node is None:
                node = _Node(parent=parent, last_used=self._tick)
                self._nodes[h] = node
                if parent != _ROOT:
                    self._nodes[parent].n_children += 1
                self.stats.inserted_blocks += 1
            else:
                node.last_used = self._tick
            if node.page is None:
                node.page = page
                self.pages.retain(page)
                bound += 1
        self._evict()
        return bound

    # ---------------------------------------------------------------- merge
    def merge_from(self, other: "PrefixCache") -> int:
        """Copy every trie node of ``other`` into this cache (fleet warm-up:
        a freshly scaled-up replica inherits the survivors' affinity state so
        `prefix-affinity` routing can steer shared-prefix traffic at it from
        its first request, instead of treating it as a stranger for an entire
        cache-refill period). Chain hashes encode their full prefix, so node
        sets from caches with the same block size merge by plain dict union;
        mismatched block sizes would alias unrelated prefixes and raise.

        Returns the number of nodes actually added. Like the PR 5 credit
        design this is accounting-only — no KV bytes move — and the warmed
        trie deliberately *overstates* the newcomer's real cache so affinity
        traffic (re)builds its session cache fastest. Stats and the LRU
        clock are untouched; merged nodes enter at the LRU floor, first out
        under pressure."""
        if other.block != self.block:
            raise ValueError(
                f"cannot merge prefix caches with different block sizes "
                f"({other.block} into {self.block}); chain hashes would alias"
            )
        added = 0
        for h, node in other._nodes.items():
            if h in self._nodes:
                continue
            self._nodes[h] = _Node(parent=node.parent)
            added += 1
        if added:
            # recount children from scratch: on partial trie overlap the
            # per-node counts from either side undercount the union, and a
            # wrong zero would let eviction orphan a subtree
            for node in self._nodes.values():
                node.n_children = 0
            for node in self._nodes.values():
                if node.parent != _ROOT:
                    self._nodes[node.parent].n_children += 1
            self._evict()
        return added

    # ---------------------------------------------------------------- evict
    def _evictable(self, n: _Node) -> bool:
        # leaves only (a surviving block always has its whole prefix), never
        # pinned by an in-flight request, and never a page some live table
        # still maps (refcount above the cache's own retain)
        if n.n_children != 0 or n.pins != 0:
            return False
        if n.page is not None and self.pages is not None:
            return self.pages.refcount.get(n.page, 0) <= 1
        return True

    def _pop_victim(self, victim: int) -> None:
        node = self._nodes.pop(victim)
        if node.page is not None and self.pages is not None:
            self.pages.release_page(node.page)
        if node.parent != _ROOT:
            self._nodes[node.parent].n_children -= 1
        self.stats.evicted_blocks += 1

    def _evict(self) -> None:
        if self.max_blocks is None:
            return
        while len(self._nodes) > self.max_blocks:
            # LRU leaf: O(n) scan, fine at the block counts a replica holds
            candidates = [h for h, n in self._nodes.items() if self._evictable(n)]
            if not candidates:
                return  # everything pinned/shared: run over budget until released
            self._pop_victim(min(candidates, key=lambda h: (self._nodes[h].last_used, h)))

    def _evict_pages(self, want: int) -> int:
        """`PageAllocator` pressure hook: reclaim up to ``want`` cold cached
        pages (LRU order, same pin/refcount guards as `_evict`). Pageless
        unpinned leaves are dropped along the way — they cost no pages but
        shield page-backed parents from leaf-only eviction. Returns the page
        count actually freed."""
        freed = 0
        while freed < want:
            candidates = [h for h, n in self._nodes.items() if self._evictable(n)]
            if not candidates:
                break
            victim = min(candidates, key=lambda h: (self._nodes[h].last_used, h))
            if self._nodes[victim].page is not None:
                freed += 1
            self._pop_victim(victim)
        return freed
