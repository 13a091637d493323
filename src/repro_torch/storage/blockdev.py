"""The page-cache policies of the live ``DiskStore``.

The port's copy of the two pieces of the reference's
``storage/blockdev.py`` that the store needs: ``LRUCache`` (the OS page
cache model, carrying block payloads) and ``select_pinned_blocks`` (the
§IV-C hottest-first pinning).  The trace-replay models and
``OracleCache`` are not part of the port yet.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

EDGE_ENTRY_BYTES = 8    # the paper's 8-byte neighbor entries (§III-B)


class LRUCache:
    """O(1) LRU over block ids whose entries carry block payloads, with
    hit/miss/eviction counters."""

    def __init__(self, capacity_blocks: int):
        self.capacity = max(1, int(capacity_blocks))
        self._od = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

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
