"""The per-batch storage-access record and its I/O-counter deltas.

The port's copy of ``SampleTrace``, ``_io_snapshot``, ``_io_delta`` and
``DEFAULT_FANOUTS`` from the reference's ``core/sampler.py``: the
out-of-core loader fills a ``SampleTrace`` per batch whose ``io`` holds
the batch's measured store, device-cache and edge-cache counters.  The host samplers are not part of
the port yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_FANOUTS = (25, 10)   # paper default: 25 then 10 per layer


@dataclasses.dataclass
class SampleTrace:
    """Storage-access record of one minibatch's subgraph generation.

    ``touched_nodes``: every node whose neighbour list was read, in
    request order.  ``hops``: per-hop dense node-id arrays.
    ``subgraph_nodes``: unique node ids whose features were gathered.
    ``io``: the measured block-I/O and cache counters of the batch.
    """

    touched_nodes: np.ndarray
    hops: list[np.ndarray]
    subgraph_nodes: np.ndarray
    io: dict | None = None


def _io_fn(store):
    """The store's I/O-counter view, preferring the thread-scoped one."""
    return getattr(store, "thread_io_counters",
                   getattr(store, "io_counters", None))


def _io_snapshot(store) -> dict | None:
    counters = _io_fn(store)
    return counters() if counters is not None else None


def _io_delta(store, before: dict | None) -> dict | None:
    if before is None:
        return None
    after = _io_fn(store)()
    return {k: after[k] - before.get(k, 0) for k in after}
