"""Belady (optimal) eviction schedules from sampler replay.

The port's copy of the reference's ``storage/oracle.py``.  k-hop sampling
is seed-deterministic, so a future batch's id stream can be replayed
ahead of time without touching the live store.  Replaying a window of
``W`` batches gives, for every cache entry (feature row, edge block or
storage page), the batch index of its next use: the input of Belady's
rule, "evict the resident entry whose next use is farthest away".

``next_use_times``      next-use times over a window of id streams (one
                        lexsort).
``RawDiskReader``       the GraphStore access protocol over raw reads
                        (``DiskStore.read_indices_at``): host replay equal
                        to live sampling, with no billed page-cache
                        traffic.
``OracleReplayer``      the replay lane: a thread that computes window
                        ``w + 1``'s schedules while training consumes
                        window ``w``, and feeds each cache
                        (``oracle_feed``).
``attach_pallas_oracle`` / ``attach_host_oracle``
                        wire a loader's optimal tiers to a replayer
                        (called from ``core.loader._build_loader``).

The schedule is advisory and window-local: an entry not reused inside
the window carries ``FAR_NEXT_USE``, and a replay failure leaves the
caches without a schedule (exact LRU order), never with wrong data, since
the policy only decides which entries stay resident.  The replay lane
runs numpy and the CPU threefry only: it makes no CUDA call.  With
telemetry on, each window's replay is an ``oracle.window`` span on the
lane's track.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np

from repro_torch import rng
from repro_torch.core import sampler as sampler_mod
from repro_torch.obs import session as obs_session
from repro_torch.storage.blockdev import FAR_NEXT_USE


# ---------------------------------------------------------------------------
# next-use computation
# ---------------------------------------------------------------------------

def next_use_times(pairs):
    """Per-entry next-use times over a window of id streams.

    ``pairs`` is ``[(batch_idx, ids), ...]``, each ``ids`` the batch's
    unique entry ids.  Returns ``{batch_idx: (ids, next_use)}``, where
    ``next_use[i]`` is the first batch index after ``batch_idx`` at which
    ``ids[i]`` appears again inside the window, else ``FAR_NEXT_USE``.
    One lexsort over all (id, t) events: an event's next use is its
    successor when the successor has the same id."""
    if not pairs:
        return {}
    ts = np.concatenate([np.full(len(np.asarray(ids).reshape(-1)), t,
                                 np.int64)
                         for t, ids in pairs])
    ids = np.concatenate([np.asarray(ids, np.int64).reshape(-1)
                          for _, ids in pairs])
    n = ids.size
    out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    if n == 0:
        return {int(t): (np.asarray(i, np.int64).reshape(-1),
                         np.empty(0, np.int64)) for t, i in pairs}
    order = np.lexsort((ts, ids))
    sid, st = ids[order], ts[order]
    nxt = np.full(n, FAR_NEXT_USE, np.int64)
    same = sid[1:] == sid[:-1]
    nxt[:-1][same] = st[1:][same]
    # back to event order, then per batch
    per_event = np.empty(n, np.int64)
    per_event[order] = nxt
    off = 0
    for t, batch_ids in pairs:
        m = np.asarray(batch_ids).reshape(-1).size
        out[int(t)] = (np.asarray(batch_ids, np.int64).reshape(-1),
                       per_event[off:off + m])
        off += m
    return out


# ---------------------------------------------------------------------------
# raw replay reader (host sampler)
# ---------------------------------------------------------------------------

class RawDiskReader:
    """The GraphStore access protocol over raw positional reads: the
    semantics of ``DiskStore.gather_edges`` (deg-0 rows sample
    themselves), with neighbour values read through ``read_indices_at``
    (retry- and CRC-protected, past the page cache, billing nothing), so
    replay never changes the live store's residency or counters."""

    def __init__(self, store):
        self._store = store
        self._indptr = np.asarray(store.indptr, np.int64)

    @property
    def num_nodes(self) -> int:
        return self._store.num_nodes

    def out_degrees(self, nodes: np.ndarray) -> np.ndarray:
        n = np.asarray(nodes, np.int64)
        return (self._indptr[n + 1] - self._indptr[n]).astype(np.int64)

    def gather_edges(self, rows: np.ndarray, offsets: np.ndarray
                     ) -> np.ndarray:
        rows = np.asarray(rows, np.int64)
        off = np.asarray(offsets, np.int64)
        start = self._indptr[rows]
        deg = self._indptr[rows + 1] - start
        picked = np.broadcast_to(rows[:, None], off.shape
                                 ).astype(np.int32).copy()
        live = deg > 0
        if live.any():
            pos = start[live, None] + off[live]
            vals = np.asarray(self._store.read_indices_at(pos.reshape(-1)),
                              np.int32)
            picked[live] = vals.reshape(pos.shape)
        return picked


# ---------------------------------------------------------------------------
# the replay lane
# ---------------------------------------------------------------------------

class OracleReplayer:
    """Background replay lane computing Belady schedules a window ahead.

    ``replay_fn(idx) -> {stream_name: ids}`` replays batch ``idx``'s id
    streams (no live-store traffic); ``consumers`` maps stream names to
    the ``oracle_feed`` of the caches being scheduled.  Training calls
    ``advance(idx)`` at the head of each batch: it requests windows
    ``idx // W`` and ``idx // W + 1`` and blocks only until the current
    window's schedules are fed, so after the first window the replay
    overlaps training.

    Failures are soft: a replay error marks the window ready anyway (its
    batches get no updates and fall back to LRU order) and an ``advance``
    timeout proceeds unscheduled, each with one warning; ``stats()``
    counts both (``errors``, ``timeouts``)."""

    def __init__(self, replay_fn, consumers, *, window: int,
                 name: str = "oracle", timeout_s: float = 120.0):
        self.window = max(1, int(window))
        self._replay = replay_fn
        self._consumers = dict(consumers)
        self._timeout_s = float(timeout_s)
        self._cv = threading.Condition()
        self._queue: list[int] = []
        self._requested: set[int] = set()
        self._ready: set[int] = set()
        self._closed = False
        self._warned = False
        self._windows_built = 0
        self._batches_replayed = 0
        self._errors = 0
        self._timeouts = 0
        self._thread = threading.Thread(
            target=self._run, name=f"{name}-replay-lane", daemon=True)
        self._thread.start()

    # -- training-side API ---------------------------------------------------
    def advance(self, idx: int) -> None:
        """Make sure batch ``idx``'s window is scheduled (blocking while
        the lane catches up) and request the next window."""
        w = idx // self.window
        with self._cv:
            if self._closed:
                return
            for req in (w, w + 1):
                if req not in self._requested:
                    self._requested.add(req)
                    self._queue.append(req)
            self._cv.notify_all()
            ok = self._cv.wait_for(
                lambda: w in self._ready or self._closed,
                timeout=self._timeout_s)
            if not ok:
                self._timeouts += 1
                if not self._warned:
                    self._warned = True
                    warnings.warn(
                        f"oracle replay lane missed window {w} within "
                        f"{self._timeout_s:.0f}s; proceeding with LRU-"
                        "fallback ordering for its batches", stacklevel=2)

    def stats(self) -> dict:
        with self._cv:
            return dict(window=self.window,
                        windows_built=self._windows_built,
                        batches_replayed=self._batches_replayed,
                        errors=self._errors, timeouts=self._timeouts)

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)

    # -- lane internals ------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                w = self._queue.pop(0)
            try:
                with obs_session.trace_span("oracle.window", window=w):
                    self._compute(w)
            except Exception as e:          # soft failure: LRU order
                with self._cv:
                    self._errors += 1
                if not self._warned:
                    self._warned = True
                    warnings.warn(f"oracle replay of window {w} failed "
                                  f"({e!r}); its batches fall back to LRU "
                                  "ordering", stacklevel=2)
            with self._cv:
                self._ready.add(w)
                self._windows_built += 1
                self._cv.notify_all()

    def _compute(self, w: int) -> None:
        W = self.window
        per_stream: dict[str, list[tuple[int, np.ndarray]]] = {}
        for t in range(w * W, (w + 1) * W):
            streams = self._replay(t)
            with self._cv:
                self._batches_replayed += 1
            for nm, ids in streams.items():
                per_stream.setdefault(nm, []).append((t, ids))
        for nm, pairs in per_stream.items():
            feed = self._consumers.get(nm)
            if feed is not None:
                feed(next_use_times(pairs))


# ---------------------------------------------------------------------------
# loader wiring
# ---------------------------------------------------------------------------

def _oracle_window(spec) -> int:
    """The replay window: the largest of the spec's optimal tiers' (one
    lane serves every scheduled cache, replaying each batch once)."""
    return max((t.oracle_window for t in spec.cache_tiers
                if t.policy == "optimal"), default=0)


def attach_pallas_oracle(loader, spec):
    """Build the replay lane for a pallas loader's optimal tiers.

    Replays the kernel sampler's threefry stream (``replay_khop_jax_ids``,
    equal to both the in-memory and the edge-cached sampling, which draw
    ``randint(fold_in(key, i), frontier.shape + (f,))``) and derives up
    to three streams per batch:

    * ``features``     the unique node ids over all hops -> feature cache
    * ``edge_blocks``  the staged block pair of every expanded frontier
                       node, plus the padding pair {0, 1} -> edge cache
    * ``pages``        the store's page ids of the batch's row and edge
                       block reads -> ``DiskStore`` page cache

    The page stream bills the store for all of the batch's backing
    traffic; a device cache in front absorbs some of it, so the page
    schedule is an upper envelope of the store's true reuse.  Returns the
    attached ``OracleReplayer`` or None."""
    W = _oracle_window(spec)
    if W < 1:
        return None
    store = loader.store
    g = loader.g
    indptr = np.asarray(g.indptr, np.int64)
    ind = getattr(g, "indices", None)
    if ind is not None:
        ind_np = np.asarray(ind)

        def read_idx(pos):
            return ind_np[pos]
    else:
        read_idx = store.read_indices_at

    feat = spec.feature_cache()
    topo = spec.topology_cache()
    host = spec.host_cache_tier()
    want_feat = (loader.devcache is not None
                 and feat is not None and feat.policy == "optimal")
    want_edge = (loader.edgecache is not None
                 and topo is not None and topo.policy == "optimal")
    want_pages = (host is not None and host.policy == "optimal"
                  and hasattr(store, "replay_block_ids"))
    if not (want_feat or want_edge or want_pages):
        return None

    fanouts = loader.fanouts
    base_key = loader._key
    ec = loader.edgecache
    if ec is not None:
        block_e, max_block = ec.block_e, ec.max_block

    def replay(idx):
        targets = loader.targets(idx)
        hops = sampler_mod.replay_khop_jax_ids(
            indptr, read_idx, targets, fanouts,
            key=rng.fold_in(base_key, idx),
            rand_shape_fn=lambda fr, f: fr.shape + (f,))
        out = {}
        uniq = np.unique(np.concatenate(
            [h.reshape(-1) for h in hops]).astype(np.int64))
        if want_feat:
            out["features"] = uniq
        eb = None
        if want_edge or want_pages:
            # every expanded frontier's staged block pair + padding pair
            expanded = np.concatenate(
                [h.reshape(-1) for h in hops[:-1]]).astype(np.int64)
            b0 = np.minimum(indptr[expanded] // block_e, max_block) \
                if ec is not None else None
            if b0 is not None:
                eb = np.unique(np.concatenate([b0, b0 + 1, [0, 1]]))
        if want_edge and eb is not None:
            out["edge_blocks"] = eb
        if want_pages:
            out["pages"] = store.replay_block_ids(
                feature_nodes=uniq if loader.devcache is not None else None,
                edge_blocks=eb if ec is not None else None,
                block_e=block_e if ec is not None else None)
        return out

    consumers = {}
    if want_feat:
        consumers["features"] = loader.devcache.oracle_feed
    if want_edge:
        consumers["edge_blocks"] = ec.oracle_feed
    if want_pages:
        consumers["pages"] = store.oracle_feed
    rep = OracleReplayer(replay, consumers, window=W, name="pallas")
    loader._oracle = rep
    return rep


def attach_host_oracle(loader, spec):
    """Build the replay lane for the host backend's optimal page cache.

    Replays the numpy sampler (``replay_khop`` or ``saint_random_walk``
    over a ``RawDiskReader``: the same ids, no billed store traffic) and
    feeds the ``DiskStore`` page cache the page ids of the batch's
    neighbour-list, feature-row and label reads.  The replayer is
    attached to the store (``oracle_attach``), whose producers call
    ``oracle_advance`` per batch.  Returns the ``OracleReplayer`` or
    None."""
    from repro_torch.core.loader import batch_targets

    host = spec.host_cache_tier()
    store = loader.store
    if (host is None or host.policy != "optimal"
            or not hasattr(store, "replay_block_ids")):
        return None
    W = host.oracle_window
    if W < 1:
        return None
    raw = RawDiskReader(store)
    fanouts = loader.fanouts
    seed = loader.seed
    bs = loader.batch_size
    use_saint = loader.sampler == "saint"
    walk_length = loader.walk_length

    def replay(idx):
        targets = batch_targets(store, idx, bs, seed)
        if use_saint:
            trace = sampler_mod.saint_random_walk(
                raw, targets, walk_length, seed=seed + idx)
        else:
            trace = sampler_mod.replay_khop(
                raw, targets, fanouts, seed=seed + idx)
        pages = store.replay_block_ids(
            feature_nodes=trace.subgraph_nodes,
            edge_nodes=np.unique(trace.touched_nodes),
            label_nodes=targets)
        return {"pages": pages}

    rep = OracleReplayer(replay, {"pages": store.oracle_feed},
                         window=W, name="host")
    store.oracle_attach(rep)
    loader._oracle = None        # the store owns and drives this lane
    return rep
