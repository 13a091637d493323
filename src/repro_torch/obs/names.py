"""Canonical counter keys of the out-of-core data plane.

The port's copy of the key tuples in the reference's ``obs/names.py``
that the store and the device caches emit: ``IOContext.KEYS`` is
``STORE_IO_KEYS + FAULT_KEYS`` and both device caches report
``DEVCACHE_KEYS``, so the port's counter dicts carry the reference's
leaf names and compare equal to its dicts.
"""

from __future__ import annotations

#: ``DiskStore`` per-context I/O bill (``IOContext``/``io_counters``).
STORE_IO_KEYS = ("requests", "block_fetches", "bytes_fetched", "hits",
                 "misses", "evictions")

#: Fault kinds, flat in the store; ``nest_fault_counters`` folds them
#: under ``"faults"`` at trace-assembly time.
FAULT_KEYS = ("retries", "io_errors", "short_reads", "corrupt_blocks",
              "timeouts")

#: ``DeviceArrayCache.counters()``, both tiers (features, edge blocks).
DEVCACHE_KEYS = ("hits", "misses", "evictions", "preload_rows",
                 "bytes_uploaded")
