"""Block-level view of the neighbour edge-list array, and the cache
models: the page-cache policies of the live ``DiskStore`` and the
trace-replay models of the storage engines.

The port's copy of the reference's ``storage/blockdev.py``:

* ``BlockTrace``/``block_trace``: a batch's touched nodes as the block
  request stream a 4 KB-granular device serves (``storage.engines``);
* ``LRUCache``: the OS page cache model, payload-less for trace replay
  (``access``) or carrying block payloads for the live store;
* ``select_pinned_blocks`` and ``PinnedCache``: the §IV-C direct-I/O
  scratchpad, the hottest blocks pinned and an LRU for the rest;
* ``OracleCache``: Belady eviction from a replayed sampler schedule
  (``storage.oracle``).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict

import numpy as np

EDGE_ENTRY_BYTES = 8    # the paper's 8-byte neighbor entries (§III-B)


@dataclasses.dataclass
class BlockTrace:
    """Per-request block extents for one batch's touched nodes."""
    first_block: np.ndarray      # (R,) int64
    n_blocks: np.ndarray         # (R,) int64 blocks per request
    total_blocks: int            # sum(n_blocks): block fetches if uncached
    unique_blocks: int
    chunk_bytes: np.ndarray      # (R,) exact neighbor-list bytes per request

    @property
    def n_requests(self) -> int:
        return int(self.first_block.shape[0])

    def raw_block_bytes(self, block_bytes: int) -> int:
        """Bytes moved when every request fetches whole blocks (Fig. 10a)."""
        return int(self.total_blocks) * block_bytes


def block_trace(g, touched_nodes: np.ndarray,
                block_bytes: int = 4096) -> BlockTrace:
    t = np.asarray(touched_nodes, np.int64)
    start = g.indptr[t] * EDGE_ENTRY_BYTES
    end = g.indptr[t + 1] * EDGE_ENTRY_BYTES
    first = start // block_bytes
    # degree-0 nodes still cost one metadata block probe
    last = np.maximum(end - 1, start) // block_bytes
    n_blocks = last - first + 1
    uniq = set()
    for f, n in zip(first, n_blocks):
        uniq.update(range(int(f), int(f + n)))
    return BlockTrace(first_block=first, n_blocks=n_blocks,
                      total_blocks=int(n_blocks.sum()),
                      unique_blocks=len(uniq),
                      chunk_bytes=np.maximum(end - start, 1))


class LRUCache:
    """O(1) LRU over block ids, with hit/miss/eviction counters: touched
    without payloads in trace replay (``access``), or carrying block
    payloads as the live store's page cache (``get``/``put``)."""

    def __init__(self, capacity_blocks: int):
        self.capacity = max(1, int(capacity_blocks))
        self._od = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def access(self, block: int) -> bool:
        """Touch a block (payload-less, trace-replay use); True on hit."""
        od = self._od
        if block in od:
            od.move_to_end(block)
            self.hits += 1
            return True
        self.misses += 1
        od[block] = None
        if len(od) > self.capacity:
            od.popitem(last=False)
            self.evictions += 1
        return False

    def access_run(self, first: int, n: int) -> int:
        """Touch blocks [first, first+n); returns the number of misses."""
        return sum(0 if self.access(first + i) else 1 for i in range(n))

    def get(self, block: int):
        """Payload for ``block`` or None on miss (counts either way)."""
        od = self._od
        if block in od:
            od.move_to_end(block)
            self.hits += 1
            return od[block]
        self.misses += 1
        return None

    def peek(self, block: int):
        """Payload if resident (touches recency, no counters): the
        post-fetch re-check of the sharded read path, where the fetch
        itself already counted."""
        od = self._od
        if block in od:
            od.move_to_end(block)
            return od[block]
        return None

    def put(self, block: int, payload) -> tuple[int, object] | None:
        """Insert a fetched block's payload, evicting the LRU block.
        Returns the evicted ``(block, payload)`` pair, or None if nothing
        was displaced."""
        od = self._od
        od[block] = payload
        od.move_to_end(block)
        if len(od) > self.capacity:
            evicted = od.popitem(last=False)
            self.evictions += 1
            return evicted
        return None


#: "never used again inside the replayed window" sentinel for oracle
#: next-use times: larger than any real batch index, and still inside
#: int64 when negated for the max-heap order.
FAR_NEXT_USE = 1 << 62


class OracleCache:
    """Belady (optimal) eviction over block ids, driven by a replayed
    sampler schedule.

    ``LRUCache``'s surface and counters, but the victim on overflow is the
    resident block whose next use (known ahead because the sampler's id
    stream is seed-deterministic and replayed a window ahead) is farthest
    away (``FAR_NEXT_USE`` if not reused inside the window): a lazy
    max-heap over ``(-next_use, seq, bid)``, FIFO among ties.

    The schedule arrives per batch in two phases (``begin_batch``): the
    batch's blocks are protected at next-use == the batch index for the
    batch's duration, and their true after-batch times apply when the
    next batch begins.  The batch is the quantum: below one batch's
    unique-block working set the residency turns over every batch and no
    batch-granular policy beats recency.  With no schedule the cache is
    FIFO; reads stay exact either way."""

    def __init__(self, capacity_blocks: int):
        self.capacity = max(1, int(capacity_blocks))
        self._data: dict[int, object] = {}   # resident payloads (ins. order)
        self._nu: dict[int, int] = {}        # scheduled next use (batch)
        self._heap: list[tuple[int, int, int]] = []  # (-next_use, seq, bid)
        self._latest: dict[int, int] = {}    # bid -> authoritative heap seq
        self._seq = 0                        # tiebreak: FIFO among ties
        self._pending: tuple[np.ndarray, np.ndarray] | None = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- schedule delivery --------------------------------------------------
    def _push(self, bid: int) -> None:
        """(Re-)insert ``bid``'s authoritative heap entry at its current
        priority; older entries of the same bid turn stale."""
        heap = self._heap
        if len(heap) > max(1024, 16 * self.capacity):
            # stale entries dominate: rebuild from the residents
            heap[:] = [(-self._next_use_of(b), s, b)
                       for b, s in self._latest.items()]
            heapq.heapify(heap)
        heapq.heappush(heap, (-self._next_use_of(bid), self._seq, bid))
        self._latest[bid] = self._seq
        self._seq += 1

    def _set(self, bid: int, next_use: int) -> None:
        if next_use >= FAR_NEXT_USE:
            self._nu.pop(bid, None)
        else:
            self._nu[bid] = next_use
        if bid in self._data:
            self._push(bid)

    def begin_batch(self, idx: int, blocks: np.ndarray,
                    next_use: np.ndarray) -> None:
        """Enter batch ``idx``: apply the previous batch's deferred
        after-batch next-use times, protect this batch's ``blocks`` at
        next-use == ``idx``, and defer their ``next_use`` (first use after
        ``idx``) to the next call."""
        if self._pending is not None:
            for b, v in zip(*self._pending):
                self._set(int(b), int(v))
        for b in blocks:
            self._set(int(b), int(idx))
        self._pending = (blocks, next_use)

    def _next_use_of(self, bid: int) -> int:
        return self._nu.get(bid, FAR_NEXT_USE)

    def _evict_one(self) -> tuple[int, object]:
        """Pop the resident block with the farthest next use, skipping
        stale heap entries (evicted blocks, superseded priorities)."""
        heap = self._heap
        while heap:
            _, seq, bid = heapq.heappop(heap)
            if bid in self._data and seq == self._latest.get(bid):
                self._latest.pop(bid, None)
                return bid, self._data.pop(bid)
        bid = next(iter(self._data))             # unreachable fallback
        self._latest.pop(bid, None)
        return bid, self._data.pop(bid)

    # -- trace-replay path --------------------------------------------------
    def access(self, block: int) -> bool:
        """Touch a block (payload-less); True on hit."""
        if block in self._data:
            self.hits += 1
            return True
        self.misses += 1
        self.put_new(block, None)
        return False

    def access_run(self, first: int, n: int) -> int:
        """Touch blocks [first, first+n); returns the number of misses."""
        return sum(0 if self.access(first + i) else 1 for i in range(n))

    # -- live-cache path (payload-carrying) ---------------------------------
    def get(self, block: int):
        """Payload for ``block`` or None on miss (counts either way)."""
        if block in self._data:
            self.hits += 1
            return self._data[block]
        self.misses += 1
        return None

    def peek(self, block: int):
        """Payload if resident, without counters (the post-fetch
        re-check of the read path)."""
        return self._data.get(block)

    def put_new(self, block: int, payload) -> tuple[int, object] | None:
        """Insert a block, evicting the farthest-next-use resident when
        full; returns the evicted ``(block, payload)`` or None."""
        evicted = None
        if block not in self._data and len(self._data) >= self.capacity:
            evicted = self._evict_one()
            self.evictions += 1
        self._data[block] = payload
        self._push(block)
        return evicted

    put = put_new

    def counters(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


def select_pinned_blocks(g, budget_blocks: int, block_bytes: int = 4096,
                         entry_bytes: int = EDGE_ENTRY_BYTES
                         ) -> dict[int, object]:
    """Greedy hottest-first pinning: walk nodes in descending degree and
    claim each one's blocks until ``budget_blocks`` is exhausted.  ``g``
    needs ``degrees()`` and ``edge_byte_range(u, entry_bytes)``.  Returns
    ``{block_id: None}`` (payloads staged later)."""
    heat_order = np.argsort(-g.degrees())
    pinned: dict[int, object] = {}
    for u in heat_order:
        lo, hi = g.edge_byte_range(int(u), entry_bytes)
        blocks = range(lo // block_bytes, max(hi - 1, lo) // block_bytes + 1)
        if len(pinned) + len(blocks) > budget_blocks:
            break
        pinned.update((b, None) for b in blocks)
    return pinned


class PinnedCache:
    """User-space scratchpad: part of the capacity (half by default)
    statically pins the hottest blocks, the rest is an app-managed LRU
    for short-term reuse (the "manually orchestrate high-locality data
    movements" runtime of §IV-C: the page cache's DRAM budget, informed
    placement, no kernel maintenance costs)."""

    def __init__(self, g, capacity_blocks: int, block_bytes: int = 4096,
                 entry_bytes: int = EDGE_ENTRY_BYTES,
                 pinned_budget: int | None = None):
        """``g`` needs ``degrees()`` and ``edge_byte_range(u,
        entry_bytes)``.  ``pinned_budget`` caps the pinned blocks (default
        half the capacity); a budget above the capacity raises, since
        pins are never evicted."""
        capacity_blocks = max(2, int(capacity_blocks))
        if pinned_budget is None:
            pinned_budget = capacity_blocks // 2
        if pinned_budget > capacity_blocks:
            raise ValueError(
                f"pinned budget {pinned_budget} exceeds cache capacity "
                f"{capacity_blocks} blocks; pins are never evicted, so "
                "shrink the pinned set or grow the cache")
        self._pinned = select_pinned_blocks(g, pinned_budget, block_bytes,
                                            entry_bytes)
        self._lru = LRUCache(capacity_blocks - len(self._pinned))
        self._pinned_hits = 0

    def access(self, block: int) -> bool:
        if block in self._pinned:
            self._pinned_hits += 1
            return True
        return self._lru.access(block)

    def access_run(self, first: int, n: int) -> int:
        return sum(0 if self.access(first + i) else 1 for i in range(n))

    @property
    def hits(self) -> int:
        return self._pinned_hits + self._lru.hits

    @property
    def misses(self) -> int:
        return self._lru.misses

    @property
    def evictions(self) -> int:
        return self._lru.evictions

    def counters(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}
