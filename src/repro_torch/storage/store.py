"""GraphStore: the graph layer behind the out-of-core data plane.

The port's copy of the reference's ``storage/store.py``, in numpy and the
standard library.  Two implementations of one protocol:

* ``InMemoryStore`` wraps a ``CSRGraph`` (everything in DRAM, counters
  stay zero);
* ``DiskStore`` serves the same reads from the paged on-disk layout that
  ``save_graph`` writes (one block-aligned binary file per array plus a
  JSON manifest with one CRC32C per block), through ``os.pread`` fronted
  by a live page cache (``lru``; ``pinned``: the hottest edge blocks
  staged at open, the rest LRU; or ``optimal``: Belady eviction from a
  replayed sampler schedule, unsharded), split into lock shards, with an
  optional pread pool and a classified retry policy (``RetrySpec``).

Only the (N+1)-entry ``indptr`` stays resident; ``indices``,
``features`` and ``labels`` are read on demand in ``block_bytes`` units,
and every read bills the ``IOContext`` installed on the reading thread,
so a batch's I/O counters are exact.  The layout, the counters and the
bytes read are the reference's: a store either package writes, the other
reads.

``DiskStore.warm_nodes`` is the overlapped pipeline's frontier planner:
it pulls a future batch's probable byte ranges through the page cache on
the pread pool, billed to the store's own planner context
(``stats()["planner"]``) and never to a batch.

``faults=`` reads every block through a ``FaultInjector`` (the
reference's deterministic schedule), below the retry and verify policy;
``direct_io=True`` opens the backing files ``O_DIRECT`` where the
platform and filesystem allow it, and otherwise warns and reads buffered,
as the reference does.

Under ``optimal`` the schedule arrives through the oracle hooks
(``oracle_attach``, ``oracle_feed``, ``oracle_advance``), computed by a
replay lane (``storage.oracle``) that reads the edge array through
``read_indices_at`` (retry- and CRC-protected, bypassing the page cache
and its counters) and maps a replayed batch's reads to page ids with
``replay_block_ids``.  With telemetry on (``obs``), every block read is
a ``disk.pread`` span (``disk.retry`` after the first attempt), carrying
the batch of the ``IOContext`` it bills to.
"""

from __future__ import annotations

import contextlib
import errno
import json
import mmap
import os
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.graph import CSRGraph, read_edge_blocks
from repro_torch.obs import names as obs_names
from repro_torch.obs import session as obs_session
from repro_torch.storage.blockdev import (LRUCache, OracleCache,
                                          select_pinned_blocks)
from repro_torch.storage.faults import FaultInjector, FaultSpec
from repro_torch.storage.integrity import block_checksums, crc32c
from repro_torch.storage.specs import DEFAULT, RetrySpec, SystemSpec

MANIFEST = "manifest.json"
FORMAT = "smartsage-graphstore"
# one logical block-id namespace per backing file, so a single cache
# budget (and a single pinning policy) spans all arrays
_NS_STRIDE = 1 << 40
_ARRAY_ORDER = ("indptr", "indices", "features", "labels")
# O_DIRECT's alignment contract for offsets and lengths (logical block)
_DIRECT_IO_ALIGN = 512


@runtime_checkable
class GraphStore(Protocol):
    """Everything the data plane needs from a graph, wherever it lives."""

    name: str

    @property
    def num_nodes(self) -> int: ...

    @property
    def num_edges(self) -> int: ...

    @property
    def feat_dim(self) -> int: ...

    def degrees(self) -> np.ndarray: ...

    def out_degrees(self, nodes: np.ndarray) -> np.ndarray: ...

    def neighbors(self, u: int) -> np.ndarray: ...

    def gather_edges(self, rows, offsets) -> np.ndarray: ...

    def gather_features(self, ids) -> np.ndarray: ...

    def gather_labels(self, ids) -> np.ndarray: ...

    def gather_edge_blocks(self, blocks, block_e: int) -> np.ndarray: ...

    def io_counters(self) -> dict: ...

    def stats(self) -> dict: ...

    def to_csr(self) -> CSRGraph: ...

    def close(self) -> None: ...


class InMemoryStore:
    """``GraphStore`` over a DRAM-resident ``CSRGraph``: pure delegation,
    all I/O counters stay zero."""

    kind = "mem"

    def __init__(self, g: CSRGraph):
        self.g = g
        self.name = g.name

    @property
    def num_nodes(self) -> int:
        return self.g.num_nodes

    @property
    def num_edges(self) -> int:
        return self.g.num_edges

    @property
    def feat_dim(self) -> int:
        return self.g.feat_dim

    def degrees(self):
        return self.g.degrees()

    def out_degrees(self, nodes):
        return self.g.out_degrees(nodes)

    def neighbors(self, u):
        return self.g.neighbors(u)

    def gather_edges(self, rows, offsets):
        return self.g.gather_edges(rows, offsets)

    def gather_features(self, ids):
        return self.g.gather_features(ids)

    def gather_labels(self, ids):
        return self.g.gather_labels(ids)

    def gather_edge_blocks(self, blocks, block_e: int):
        return self.g.gather_edge_blocks(blocks, block_e)

    def io_counters(self) -> dict:
        return dict.fromkeys(IOContext.KEYS, 0)

    def stats(self) -> dict:
        return {"kind": self.kind, **self.io_counters()}

    def to_csr(self) -> CSRGraph:
        return self.g

    def close(self) -> None:
        pass


class IOContext:
    """One attribution scope for a ``DiskStore``'s I/O counters, typically
    one minibatch.  Reads performed while the context is installed
    (``DiskStore.io_attribution``) merge into it, including reads the
    store's pread pool runs on other threads on the installer's behalf.
    Fault keys are flat here; ``nest_fault_counters`` folds them into
    ``io["faults"]`` at trace assembly.  ``batch`` (set by the loader) is
    the batch index the scope's reads belong to, which pool-thread pread
    spans inherit."""

    FAULT_KEYS = obs_names.FAULT_KEYS
    KEYS = obs_names.STORE_IO_KEYS + FAULT_KEYS

    __slots__ = ("_lock", "_c", "batch")

    def __init__(self):
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self.KEYS, 0)
        self.batch: int | None = None

    def add(self, **deltas) -> None:
        with self._lock:
            c = self._c
            for k, v in deltas.items():
                c[k] += v

    def counters(self) -> dict:
        with self._lock:
            return dict(self._c)


class StoreReadError(RuntimeError):
    """A block read failed beyond the retry policy: every attempt errored,
    came back short, missed its deadline, or failed checksum
    verification."""


def nest_fault_counters(io: dict | None) -> dict | None:
    """Fold the flat fault counters of an I/O bill into ``io['faults']``,
    the shape traces expose."""
    if not io:
        return io
    faults = {k: io.pop(k) for k in IOContext.FAULT_KEYS if k in io}
    if faults:
        io["faults"] = faults
    return io


def _pad_to_block(f, block_bytes: int) -> int:
    """Zero-pad an open binary file to the next block boundary."""
    size = f.tell()
    pad = -size % block_bytes
    if pad:
        f.write(b"\0" * pad)
    return size


def save_graph(g: CSRGraph, path: str, *,
               block_bytes: int | None = None) -> dict:
    """Serialize ``g`` to the on-disk GraphStore layout.

    ``path`` becomes a directory holding one binary file per array
    (``indptr.bin`` int64, ``indices.bin`` int32, ``features.bin``
    float32 row-major, ``labels.bin`` int32), each zero-padded to a
    ``block_bytes`` boundary, plus a JSON manifest (version 2) with
    dtypes, shapes, logical byte sizes and one CRC32C per block of the
    padded file.  Returns the manifest dict."""
    block_bytes = block_bytes or DEFAULT.diskstore.block_bytes
    os.makedirs(path, exist_ok=True)
    arrays = {
        "indptr": g.indptr.astype(np.int64),
        "indices": g.indices.astype(np.int32),
    }
    if g.features is not None:
        arrays["features"] = np.ascontiguousarray(g.features, np.float32)
    if g.labels is not None:
        arrays["labels"] = g.labels.astype(np.int32)
    manifest = {
        "format": FORMAT, "version": 2, "name": g.name,
        "num_nodes": g.num_nodes, "num_edges": g.num_edges,
        "feat_dim": g.feat_dim, "block_bytes": block_bytes,
        "arrays": {},
    }
    if g.labels is not None:
        manifest["n_classes"] = int(g.labels.max()) + 1
    for key, arr in arrays.items():
        fname = f"{key}.bin"
        raw = arr.tobytes()
        padded = raw + b"\0" * (-len(raw) % block_bytes)
        with open(os.path.join(path, fname), "wb") as f:
            f.write(raw)
            nbytes = _pad_to_block(f, block_bytes)
        manifest["arrays"][key] = {
            "file": fname, "dtype": arr.dtype.name,
            "shape": list(arr.shape), "nbytes": nbytes,
            "block_crc32c": [int(c)
                             for c in block_checksums(padded, block_bytes)],
        }
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class DiskStore:
    """Out-of-core ``GraphStore``: block-granular ``pread`` behind a live
    page cache.

    Every access method resolves to byte ranges in the backing files,
    fetched in ``block_bytes`` units through one cache budget shared by
    all arrays (block ids are namespaced per file).  ``policy='lru'``
    models the OS page cache; ``policy='pinned'`` is the paper's §IV-C
    scratchpad: half the budget pins the hottest (highest-degree) edge
    blocks, preloaded at open, the rest is LRU; ``policy='optimal'`` is
    Belady eviction (``OracleCache``) fed by the oracle hooks, unsharded.
    The LRU budget is split
    into ``lock_shards`` hashed-block shards, each behind its own lock;
    the pinned set is immutable after the preload and read lock-free.
    ``io_threads > 1`` opens a pread pool: multi-range gathers split
    their ranges into block-disjoint groups read concurrently, each block
    fetched by exactly one task, and every pool read bills the context of
    the thread that submitted it.  ``verify`` checks each block read
    against the manifest's CRC32C; a failed attempt is retried under
    ``retry`` and raises ``StoreReadError`` past it.  ``faults`` injects
    the ``FaultSpec``'s scheduled failures below that policy (bit flips
    need ``verify``); ``direct_io`` reads ``O_DIRECT`` into a per-thread
    page-aligned buffer, or warns and reads buffered where it cannot
    (``stats()["direct_io"]`` says which)."""

    kind = "disk"

    def __init__(self, path: str, *, cache_mb: float | None = None,
                 policy: str | None = None, cache_blocks: int | None = None,
                 lock_shards: int | None = None,
                 io_threads: int | None = None,
                 verify: bool = False,
                 direct_io: bool = False,
                 retry: RetrySpec | None = None,
                 faults: FaultSpec | None = None,
                 spec: SystemSpec = DEFAULT):
        self.path = path
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} directory")
        self.name = self.manifest["name"]
        self.block_bytes = int(self.manifest["block_bytes"])
        self.verify = bool(verify)
        self.retry = RetrySpec() if retry is None else retry
        if faults is not None and faults.bitflip_rate > 0 and not self.verify:
            raise ValueError(
                "faults.bitflip_rate > 0 without verify=True would corrupt "
                "training data silently; open the store with verify=True")
        self._injector = (FaultInjector(faults)
                          if faults is not None and faults.storage_active
                          else None)
        self._crc: dict[str, np.ndarray] | None = None
        if self.verify:
            missing = [k for k, a in self.manifest["arrays"].items()
                       if "block_crc32c" not in a]
            if missing:
                raise ValueError(
                    f"{path}: manifest records no block checksums for "
                    f"{missing}; re-save it with save_graph() or open with "
                    "verify=False")
            self._crc = {k: np.asarray(a["block_crc32c"], np.uint32)
                         for k, a in self.manifest["arrays"].items()}
        self._fault_totals = dict.fromkeys(IOContext.FAULT_KEYS, 0)
        self.cache_mb = (spec.diskstore.cache_mb if cache_mb is None
                         else float(cache_mb))
        self.policy = policy or spec.diskstore.policy
        if self.policy not in ("lru", "pinned", "optimal"):
            raise ValueError(f"unknown cache policy {self.policy!r}; "
                             "have ('lru', 'pinned', 'optimal')")

        self._arrays = self.manifest["arrays"]
        self._ns = {k: i for i, k in enumerate(_ARRAY_ORDER)
                    if k in self._arrays}
        self._dtype = {k: np.dtype(a["dtype"])
                       for k, a in self._arrays.items()}
        self._tls = threading.local()
        self._stat_lock = threading.Lock()
        self._retired_fds: list[int] = []   # see _degrade_direct
        self._open_backing_files(direct_io)

        # the CSR row index stays resident: it is the index structure
        n = int(self.manifest["num_nodes"])
        self.indptr = np.fromfile(
            os.path.join(path, self._arrays["indptr"]["file"]),
            dtype=self._dtype["indptr"], count=n + 1)

        if cache_blocks is None:
            cache_blocks = max(4, int(self.cache_mb * (1 << 20))
                               // self.block_bytes)
        self.cache_blocks = int(cache_blocks)
        self._requests = 0
        self._block_fetches = 0
        self._bytes_fetched = 0
        self._pinned_hits = 0
        if self.policy == "pinned":
            self._pinned = select_pinned_blocks(
                _EdgeBlockIndex(self), self.cache_blocks // 2,
                self.block_bytes,
                entry_bytes=self._dtype["indices"].itemsize)
        else:
            self._pinned = {}
        lru_blocks = self.cache_blocks - len(self._pinned)
        shards = (spec.diskstore.lock_shards if lock_shards is None
                  else int(lock_shards))
        shards = max(1, min(shards, lru_blocks))
        if self.policy == "optimal":
            # Belady's victim choice needs one next-use order over the
            # whole budget: one unsharded cache behind one lock
            shards = 1
            self._shards = [OracleCache(lru_blocks)]
        else:
            per = [lru_blocks // shards
                   + (1 if i < lru_blocks % shards else 0)
                   for i in range(shards)]
            self._shards = [LRUCache(max(1, c)) for c in per]
        self._locks = [threading.Lock() for _ in range(shards)]
        self.lock_shards = shards
        self._oracle_replayer = None
        self._oracle_updates: dict[int, tuple] = {}
        self._oracle_lock = threading.Lock()
        io_threads = (spec.diskstore.io_threads if io_threads is None
                      else int(io_threads))
        if io_threads < 1:
            raise ValueError(f"io_threads must be >= 1, got {io_threads}")
        if io_threads > self.lock_shards:
            warnings.warn(
                f"io_threads={io_threads} exceeds lock_shards="
                f"{self.lock_shards}: concurrent preads will serialize on "
                "the page-cache shard locks; raise --lock-shards to match",
                stacklevel=2)
        self.io_threads = io_threads
        self._pool = (ThreadPoolExecutor(max_workers=io_threads,
                                         thread_name_prefix="diskstore-io")
                      if io_threads > 1 else None)
        self._planner_ctx = IOContext()
        self._warmed_nodes = 0
        if self._pinned:
            self._preload_pinned()

    # -- sizes ---------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return int(self.manifest["num_nodes"])

    @property
    def num_edges(self) -> int:
        return int(self.manifest["num_edges"])

    @property
    def feat_dim(self) -> int:
        return int(self.manifest["feat_dim"])

    @property
    def n_classes(self) -> int:
        return int(self.manifest.get("n_classes", 0))

    def nbytes_on_disk(self) -> int:
        """Total on-disk footprint: actual (block-padded) file sizes."""
        return sum(os.path.getsize(os.path.join(self.path, a["file"]))
                   for a in self._arrays.values())

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def out_degrees(self, nodes) -> np.ndarray:
        nodes = np.asarray(nodes, np.int64)
        return (self.indptr[nodes + 1] - self.indptr[nodes]).astype(np.int64)

    def edge_byte_range(self, u: int, entry_bytes: int | None = None
                        ) -> tuple[int, int]:
        """Byte extent of node u's neighbour list within ``indices.bin``
        (defaults to the on-disk entry width, int32 = 4 B)."""
        eb = entry_bytes or self._dtype["indices"].itemsize
        return (int(self.indptr[u]) * eb, int(self.indptr[u + 1]) * eb)

    # -- paged read path -----------------------------------------------------
    def _open_backing_files(self, direct_io: bool) -> None:
        """Open one fd per array, ``O_DIRECT`` when asked: the kernel page
        cache then stops double-buffering the store's own, and every miss
        is a device read.  Falls back to buffered reads, with one
        warning, when the platform has no ``O_DIRECT``, the block size
        breaks the 512-byte alignment, or the filesystem refuses the open
        or a probe read (tmpfs does)."""

        def open_all(extra_flags: int) -> dict:
            return {k: os.open(os.path.join(self.path, a["file"]),
                               os.O_RDONLY | extra_flags)
                    for k, a in self._arrays.items()}

        self.direct_io = False
        reason = None
        if direct_io:
            o_direct = getattr(os, "O_DIRECT", None)
            if o_direct is None:
                reason = "platform has no O_DIRECT"
            elif self.block_bytes % _DIRECT_IO_ALIGN:
                reason = (f"block_bytes={self.block_bytes} is not "
                          f"{_DIRECT_IO_ALIGN}-byte aligned")
            else:
                fds = None
                try:
                    fds = open_all(o_direct)
                    self._fd = fds
                    self.direct_io = True
                    # some filesystems accept the open and refuse the
                    # first aligned read
                    self._read_block_direct(next(iter(fds)), 0)
                except OSError as e:
                    reason = str(e)
                    self.direct_io = False
                    for fd in (fds or {}).values():
                        os.close(fd)
            if reason is not None:
                warnings.warn(
                    f"direct_io requested but unavailable ({reason}); "
                    "falling back to buffered preads", stacklevel=3)
        if not self.direct_io:
            self._fd = open_all(0)

    def _aligned_buf(self) -> mmap.mmap:
        """This thread's page-aligned read buffer (``O_DIRECT`` refuses
        unaligned user memory; the pread pool reads in parallel, so each
        thread has its own)."""
        buf = getattr(self._tls, "dio_buf", None)
        if buf is None:
            buf = mmap.mmap(-1, self.block_bytes)
            self._tls.dio_buf = buf
        return buf

    def _read_block_direct(self, key: str, block: int) -> bytes:
        buf = self._aligned_buf()
        n = os.preadv(self._fd[key], [buf], block * self.block_bytes)
        return buf[:n]

    def _degrade_direct(self, reason: str) -> None:
        """Fall back to buffered preads for good, mid-run (a filesystem
        that passed the probe may still refuse a later read).  The old
        fds stay open until ``close()``: a pool thread may still be
        reading one, and a closed fd number could be reused by a later
        open (the reference closes them here)."""
        with self._stat_lock:
            if not self.direct_io:
                return
            self.direct_io = False
            self._retired_fds.extend(self._fd.values())
            self._fd = {k: os.open(os.path.join(self.path, a["file"]),
                                   os.O_RDONLY)
                        for k, a in self._arrays.items()}
        warnings.warn(f"direct_io read refused mid-run ({reason}); "
                      "falling back to buffered preads", stacklevel=4)

    def _read_block_raw(self, key: str, block: int) -> bytes:
        if self.direct_io:
            try:
                return self._read_block_direct(key, block)
            except OSError as e:
                if e.errno != errno.EINVAL:
                    raise
                self._degrade_direct(str(e))
        return os.pread(self._fd[key], self.block_bytes,
                        block * self.block_bytes)

    def _verify_block(self, key: str, block: int, data: bytes) -> bool:
        if self._crc is None:
            return True
        return crc32c(data) == int(self._crc[key][block])

    def _count_faults(self, faults: dict) -> None:
        self._current_ctx().add(**faults)
        with self._stat_lock:
            for k, v in faults.items():
                self._fault_totals[k] += v

    def _fetch(self, key: str, block: int) -> bytes:
        """One block read under the retry policy; every path into disk
        funnels here, through the fault injector when there is one.  An
        attempt fails on OSError, a short return, a checksum mismatch
        (``verify``) or by running past ``retry.deadline_s``; failures
        are retried with deterministic backoff up to
        ``retry.max_attempts`` tries, then raise ``StoreReadError``.
        Fault counters bill the caller's ``IOContext`` plus the store
        totals."""
        r = self.retry
        faults: dict[str, int] = {}
        last: Exception | None = None
        # pread spans inherit the submitting batch through the IOContext
        # (the pool runs under the submitter's ctx); resolved once per
        # fetch, only when tracing is on
        span_batch = (self._current_ctx().batch
                      if obs_session.tracing() else None)

        def note(kind):
            faults[kind] = faults.get(kind, 0) + 1

        for attempt in range(r.max_attempts):
            t0 = time.perf_counter()
            data = None
            try:
                with obs_session.trace_span(
                        "disk.pread" if attempt == 0 else "disk.retry",
                        array=key, block=int(block), attempt=attempt,
                        batch=span_batch):
                    if self._injector is not None:
                        data = self._injector.read(
                            lambda: self._read_block_raw(key, block),
                            key, block, attempt)
                    else:
                        data = self._read_block_raw(key, block)
            except OSError as e:
                last = e
                note("io_errors")
            if data is not None:
                if len(data) != self.block_bytes:
                    last = StoreReadError(
                        f"{key} block {block}: short read "
                        f"({len(data)}/{self.block_bytes} bytes)")
                    note("short_reads")
                elif not self._verify_block(key, block, data):
                    last = StoreReadError(
                        f"{key} block {block}: CRC32C mismatch")
                    note("corrupt_blocks")
                elif time.perf_counter() - t0 > r.deadline_s:
                    last = StoreReadError(
                        f"{key} block {block}: read exceeded the "
                        f"{r.deadline_s}s deadline")
                    note("timeouts")
                else:
                    if faults:
                        self._count_faults(faults)
                    return data
            if attempt + 1 < r.max_attempts:
                note("retries")
                time.sleep(r.backoff(key, block, attempt))
        self._count_faults(faults)
        raise StoreReadError(
            f"{key} block {block}: read failed after {r.max_attempts} "
            f"attempt(s): {last}") from last

    # -- I/O attribution -----------------------------------------------------
    def make_io_context(self) -> IOContext:
        """A fresh attribution scope (see ``io_attribution``)."""
        return IOContext()

    def _current_ctx(self) -> IOContext:
        """The context this thread's reads bill to: the one installed by
        ``io_attribution``, else an implicit per-thread context."""
        ctx = getattr(self._tls, "ctx", None)
        if ctx is None:
            ctx = IOContext()
            self._tls.ctx = ctx
        return ctx

    @contextlib.contextmanager
    def io_attribution(self, ctx: IOContext):
        """Attribute this thread's reads, and any pread-pool work they fan
        out, to ``ctx`` for the duration."""
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = ctx
        try:
            yield ctx
        finally:
            self._tls.ctx = prev

    def _submit(self, fn, *args):
        """Run ``fn`` on the pread pool under the submitter's context."""
        ctx = self._current_ctx()

        def run():
            prev = getattr(self._tls, "ctx", None)
            self._tls.ctx = ctx
            try:
                return fn(*args)
            finally:
                self._tls.ctx = prev

        return self._pool.submit(run)

    def _read_range(self, key: str, lo: int, hi: int) -> bytes:
        """Bytes [lo, hi) of array ``key``, block-granular via the cache.
        Each block locks only its hash shard."""
        if hi <= lo:
            return b""
        B = self.block_bytes
        first, last = lo // B, (hi - 1) // B
        ns = self._ns[key] * _NS_STRIDE
        hits = misses = nbytes = evictions = pinned_hits = 0
        parts = []
        for blk in range(first, last + 1):
            bid = ns + blk
            data = self._pinned.get(bid)
            if data is not None:        # immutable after preload: lock-free
                pinned_hits += 1
                parts.append(data)
                continue
            s = bid % self.lock_shards
            shard = self._shards[s]
            lock = self._locks[s]
            with lock:
                data = shard.get(bid)
            if data is None:
                # fetch outside the lock: misses on unrelated blocks that
                # hash to the same shard must not serialize on disk I/O
                payload = self._fetch(key, blk)
                misses += 1
                nbytes += len(payload)
                with lock:
                    # a racing fetch of the same block may have inserted
                    # first; keep its copy (both fetches are counted)
                    data = shard.peek(bid)
                    if data is None:
                        if shard.put(bid, payload) is not None:
                            evictions += 1
                        data = payload
            else:
                hits += 1
            parts.append(data)
        with self._stat_lock:
            self._requests += 1
            self._block_fetches += misses
            self._bytes_fetched += nbytes
            self._pinned_hits += pinned_hits
        self._current_ctx().add(
            requests=1, hits=hits + pinned_hits, misses=misses,
            block_fetches=misses, bytes_fetched=nbytes, evictions=evictions)
        buf = parts[0] if len(parts) == 1 else b"".join(parts)
        off = lo - first * B
        return buf[off:off + (hi - lo)]

    def _read_array(self, key: str, lo_entry: int, hi_entry: int
                    ) -> np.ndarray:
        dt = self._dtype[key]
        raw = self._read_range(key, lo_entry * dt.itemsize,
                               hi_entry * dt.itemsize)
        return np.frombuffer(raw, dtype=dt)

    def _block_disjoint_groups(self, los: np.ndarray, his: np.ndarray,
                               max_groups: int):
        """Order the byte ranges and split them into <= ``max_groups``
        contiguous runs, cutting only between ranges that share no disk
        block, so each block is fetched by exactly one pool task.
        Returns index groups into the inputs, or None when ranges
        overlap (the caller reads serially)."""
        order = np.argsort(los, kind="stable")
        lo_s, hi_s = los[order], his[order]
        if np.any(lo_s[1:] < hi_s[:-1]):
            return None
        B = self.block_bytes
        allowed = np.flatnonzero(lo_s[1:] // B > (hi_s[:-1] - 1) // B) + 1
        k = min(max_groups, allowed.size + 1)
        if k <= 1:
            return [order]
        ideal = np.linspace(0, lo_s.size, k + 1)[1:-1]
        pos = np.unique(allowed[np.minimum(np.searchsorted(allowed, ideal),
                                           allowed.size - 1)])
        return np.split(order, pos)

    def _read_group(self, key: str, los, his, idxs) -> list:
        return [self._read_range(key, int(los[i]), int(his[i]))
                for i in idxs]

    def _read_many(self, key: str, los, his) -> list:
        """Bytes of many ranges of array ``key``, in input order; with a
        pread pool the block-disjoint groups are read concurrently."""
        los = np.asarray(los, np.int64)
        his = np.asarray(his, np.int64)
        n = los.size
        if self._pool is None or n < 2 * self.io_threads:
            return [self._read_range(key, int(lo), int(hi))
                    for lo, hi in zip(los, his)]
        groups = self._block_disjoint_groups(los, his, self.io_threads)
        if groups is None or len(groups) <= 1:
            return [self._read_range(key, int(lo), int(hi))
                    for lo, hi in zip(los, his)]
        futs = [(g, self._submit(self._read_group, key, los, his, g))
                for g in groups]
        out: list = [None] * n
        for g, f in futs:
            for i, buf in zip(g, f.result()):
                out[int(i)] = buf
        return out

    def _preload_pinned(self) -> None:
        """Load the pinned hot blocks' payloads at open.  The staging
        reads count as block fetches; the pinned dict is never mutated
        afterwards, which makes the lock-free read safe."""
        ns = self._ns["indices"] * _NS_STRIDE
        for blk in sorted(self._pinned):
            data = self._fetch("indices", blk - ns)
            self._pinned[blk] = data
            self._block_fetches += 1
            self._bytes_fetched += len(data)

    # -- GraphStore access methods -------------------------------------------
    def neighbors(self, u: int) -> np.ndarray:
        return self._read_array("indices", int(self.indptr[u]),
                                int(self.indptr[u + 1]))

    def gather_edges(self, rows, offsets) -> np.ndarray:
        """Same contract as ``CSRGraph.gather_edges``, each row's
        neighbour list fetched through the page cache."""
        rows = np.asarray(rows, np.int64)
        off = np.asarray(offsets, np.int64)
        out = np.empty(off.shape, np.int32)
        ip = self.indptr
        if self._pool is not None and rows.size >= 2 * self.io_threads:
            # one deduplicated neighbour-list read per distinct row
            dt = self._dtype["indices"]
            uniq, inverse = np.unique(rows, return_inverse=True)
            lo = ip[uniq] * dt.itemsize
            hi = ip[uniq + 1] * dt.itemsize
            nz = np.flatnonzero(hi > lo)
            bufs = self._read_many("indices", lo[nz], hi[nz])
            lists: dict[int, np.ndarray] = {
                int(j): np.frombuffer(raw, dtype=dt)
                for j, raw in zip(nz, bufs)}
            for i, u in enumerate(inverse):
                lst = lists.get(int(u))
                out[i] = lst[off[i]] if lst is not None else rows[i]
            return out
        for i, u in enumerate(rows):
            lo, hi = int(ip[u]), int(ip[u + 1])
            if hi > lo:
                out[i] = self._read_array("indices", lo, hi)[off[i]]
            else:
                out[i] = u
        return out

    def gather_features(self, ids) -> np.ndarray:
        ids = np.asarray(ids)
        if "features" not in self._arrays:
            raise ValueError(f"{self.path}: store has no feature table")
        F = self.feat_dim
        dt = self._dtype["features"]
        uniq, inverse = np.unique(ids.reshape(-1), return_inverse=True)
        lo = uniq.astype(np.int64) * (F * dt.itemsize)
        bufs = self._read_many("features", lo, lo + F * dt.itemsize)
        rows = np.empty((uniq.size, F), np.float32)
        for j, raw in enumerate(bufs):
            rows[j] = np.frombuffer(raw, dtype=dt)
        return rows[inverse].reshape(ids.shape + (F,))

    def gather_labels(self, ids) -> np.ndarray:
        ids = np.asarray(ids)
        if "labels" not in self._arrays:
            raise ValueError(f"{self.path}: store has no labels")
        dt = self._dtype["labels"]
        uniq, inverse = np.unique(ids.reshape(-1), return_inverse=True)
        lo = uniq.astype(np.int64) * dt.itemsize
        bufs = self._read_many("labels", lo, lo + dt.itemsize)
        vals = np.empty(uniq.size, np.int32)
        for j, raw in enumerate(bufs):
            vals[j] = np.frombuffer(raw, dtype=dt)[0]
        return vals[inverse].reshape(ids.shape)

    def gather_edge_blocks(self, blocks, block_e: int) -> np.ndarray:
        """``block_e``-wide int32 chunks of ``indices``, zero-padded past
        the array end, read through the page cache: device edge-cache
        misses are real paged reads and land in the counters."""
        blocks_a = np.asarray(blocks, np.int64).reshape(-1)
        read = lambda lo, hi: self._read_array("indices", lo, hi)  # noqa: E731
        if self._pool is not None and blocks_a.size >= 2 * self.io_threads:
            # read the distinct blocks' ranges concurrently, then let the
            # shared slicer assemble from the staged buffers
            E = self.num_edges
            dt = self._dtype["indices"]
            uniq = np.unique(blocks_a)
            lo_e = uniq * block_e
            hi_e = np.minimum(lo_e + block_e, E)
            nz = np.flatnonzero(hi_e > lo_e)
            bufs = self._read_many("indices", lo_e[nz] * dt.itemsize,
                                   hi_e[nz] * dt.itemsize)
            served = {(int(lo_e[j]), int(hi_e[j])):
                      np.frombuffer(raw, dtype=dt)
                      for j, raw in zip(nz, bufs)}
            fallback = read
            read = lambda lo, hi: (served.get((lo, hi))  # noqa: E731
                                   if (lo, hi) in served
                                   else fallback(lo, hi))
        return read_edge_blocks(read, blocks_a, block_e, self.num_edges)

    # -- planner hook --------------------------------------------------------
    def warm_nodes(self, nodes, *, features: bool = True,
                   edges: bool = True) -> int:
        """Planner pre-admission: pull the given nodes' neighbour-list and
        feature-row byte ranges through the page cache on the pread pool,
        ahead of the batch that will read them.  Fire-and-forget: the
        payloads are dropped; the value is the cache residency when the
        real read arrives.  Billed to the store's planner context
        (``stats()['planner']``), never to a batch.  Returns the number of
        ranges submitted (0 without a pool: warming synchronously would
        only move the stall)."""
        if self._pool is None:
            return 0
        nodes = np.unique(np.asarray(nodes, np.int64).reshape(-1))
        if nodes.size == 0:
            return 0
        jobs = []
        if edges:
            isz = self._dtype["indices"].itemsize
            lo = self.indptr[nodes] * isz
            hi = self.indptr[nodes + 1] * isz
            nz = hi > lo
            jobs.append(("indices", lo[nz], hi[nz]))
        if features and "features" in self._arrays:
            row = self._dtype["features"].itemsize * self.feat_dim
            lo = nodes * row
            jobs.append(("features", lo, lo + row))
        n = 0
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = self._planner_ctx     # bind submissions to planner
        try:
            for key, lo, hi in jobs:
                if lo.size == 0:
                    continue
                groups = self._block_disjoint_groups(
                    np.asarray(lo, np.int64), np.asarray(hi, np.int64),
                    self.io_threads)
                if groups is None:
                    continue
                for g in groups:
                    self._submit(self._read_group, key, lo, hi, g)
                    n += len(g)
        finally:
            self._tls.ctx = prev
        with self._stat_lock:
            self._warmed_nodes += int(nodes.size)
        return n

    # -- oracle (Belady) scheduling hooks ------------------------------------
    def read_indices_at(self, positions) -> np.ndarray:
        """Raw positional reads of ``indices[positions]`` for sampler
        replay: block reads through ``_fetch`` (retry and CRC policy)
        that bypass the page cache, so no residency changes and no
        request, hit or miss is billed."""
        dt = self._dtype["indices"]
        per = self.block_bytes // dt.itemsize
        pos = np.asarray(positions, np.int64).reshape(-1)
        uniq, inv = np.unique(pos, return_inverse=True)
        out = np.empty(uniq.size, dt)
        blocks = uniq // per
        for b in np.unique(blocks):
            sel = blocks == b
            data = np.frombuffer(self._fetch("indices", int(b)), dtype=dt)
            out[sel] = data[uniq[sel] - int(b) * per]
        return out[inv].reshape(np.shape(positions))

    def replay_block_ids(self, *, feature_nodes=None, edge_nodes=None,
                         label_nodes=None, edge_blocks=None,
                         block_e: int | None = None) -> np.ndarray:
        """Namespaced page ids a replayed batch's reads will touch: the
        feature rows of ``feature_nodes``, the neighbour lists of
        ``edge_nodes``, the labels of ``label_nodes`` and the
        ``block_e``-entry ``edge_blocks`` (the device edge cache's
        fetch unit).  Layout arithmetic over ``indptr``, no reads."""
        B = self.block_bytes
        parts: list[np.ndarray] = []

        def ranges_to_blocks(key, lo, hi):
            ns = self._ns[key] * _NS_STRIDE
            lo = np.asarray(lo, np.int64).reshape(-1)
            hi = np.asarray(hi, np.int64).reshape(-1)
            keep = hi > lo
            lo, hi = lo[keep], hi[keep]
            if lo.size == 0:
                return
            first = lo // B
            counts = (hi - 1) // B - first + 1
            total = int(counts.sum())
            starts = np.repeat(first, counts)
            offs = (np.arange(total)
                    - np.repeat(np.cumsum(counts) - counts, counts))
            parts.append(ns + starts + offs)

        if feature_nodes is not None and "features" in self._arrays:
            row = self._dtype["features"].itemsize * self.feat_dim
            ids = np.asarray(feature_nodes, np.int64).reshape(-1)
            ranges_to_blocks("features", ids * row, ids * row + row)
        if edge_nodes is not None:
            isz = self._dtype["indices"].itemsize
            ids = np.asarray(edge_nodes, np.int64).reshape(-1)
            ranges_to_blocks("indices", self.indptr[ids] * isz,
                             self.indptr[ids + 1] * isz)
        if edge_blocks is not None:
            isz = self._dtype["indices"].itemsize
            eb = np.asarray(edge_blocks, np.int64).reshape(-1)
            lo_e = eb * int(block_e)
            hi_e = np.minimum(lo_e + int(block_e), self.num_edges)
            ranges_to_blocks("indices", lo_e * isz, hi_e * isz)
        if label_nodes is not None and "labels" in self._arrays:
            isz = self._dtype["labels"].itemsize
            ids = np.asarray(label_nodes, np.int64).reshape(-1)
            ranges_to_blocks("labels", ids * isz, ids * isz + isz)
        if not parts:
            return np.empty(0, np.int64)
        return np.unique(np.concatenate(parts))

    def oracle_attach(self, replayer) -> None:
        """Bind the replay lane (``storage.oracle.OracleReplayer``) that
        keeps this store's schedule a window ahead; ``close`` closes it.
        Only under ``policy='optimal'``."""
        if self.policy != "optimal":
            raise ValueError(
                f"oracle_attach on a {self.policy!r}-policy store; the "
                "replayed schedule only drives policy='optimal'")
        self._oracle_replayer = replayer

    def oracle_feed(self, updates: dict) -> None:
        """Accept per-batch next-use updates from the replay lane:
        ``{batch_idx: (block_ids, next_use)}`` in the namespaced block
        space."""
        with self._oracle_lock:
            self._oracle_updates.update(updates)

    def oracle_advance(self, idx: int) -> None:
        """Enter batch ``idx``: wait for its window's schedule (only when
        the lane is behind) and apply the batch's next-use times to the
        page cache.  A no-op for other policies and for a batch without
        a schedule (an update already popped, as after a restart)."""
        if self.policy != "optimal":
            return
        rep = self._oracle_replayer
        if rep is not None:
            rep.advance(idx)
        with self._oracle_lock:
            upd = self._oracle_updates.pop(idx, None)
        if upd is None:
            return
        bids, nu = upd
        with self._locks[0]:
            self._shards[0].begin_batch(idx, bids, nu)

    # -- accounting ----------------------------------------------------------
    def io_counters(self) -> dict:
        hits = misses = evictions = 0
        for shard, lock in zip(self._shards, self._locks):
            with lock:
                hits += shard.hits
                misses += shard.misses
                evictions += shard.evictions
        with self._stat_lock:
            return {"requests": self._requests,
                    "block_fetches": self._block_fetches,
                    "bytes_fetched": self._bytes_fetched,
                    "hits": hits + self._pinned_hits, "misses": misses,
                    "evictions": evictions, **self._fault_totals}

    def thread_io_counters(self) -> dict:
        """This thread's attribution scope: the installed ``IOContext``,
        else the implicit per-thread context."""
        return self._current_ctx().counters()

    def stats(self) -> dict:
        return {"kind": self.kind, "policy": self.policy,
                "cache_mb": self.cache_mb,
                "cache_blocks": self.cache_blocks,
                "lock_shards": self.lock_shards,
                "io_threads": self.io_threads,
                "verify": self.verify,
                "direct_io": self.direct_io,
                "nbytes_on_disk": self.nbytes_on_disk(),
                "planner": dict(self._planner_ctx.counters(),
                                warmed_nodes=self._warmed_nodes),
                **self.io_counters()}

    def to_csr(self, include_features: bool = True) -> CSRGraph:
        """Materialize the graph in memory; with
        ``include_features=False`` the feature table stays on disk."""
        read = {k: np.fromfile(os.path.join(self.path, a["file"]),
                               dtype=self._dtype[k],
                               count=int(np.prod(a["shape"])))
                for k, a in self._arrays.items()
                if include_features or k != "features"}
        feats = read.get("features")
        if feats is not None:
            feats = feats.reshape(self._arrays["features"]["shape"])
        return CSRGraph(indptr=read["indptr"].astype(np.int64),
                        indices=read["indices"].astype(np.int32),
                        features=feats, labels=read.get("labels"),
                        name=self.name)

    def close(self) -> None:
        if self._oracle_replayer is not None:
            self._oracle_replayer.close()
            self._oracle_replayer = None
        if self._pool is not None:
            # drain before the fds go away
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        for fd in [*self._fd.values(), *self._retired_fds]:
            os.close(fd)
        self._fd, self._retired_fds = {}, []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _EdgeBlockIndex:
    """The degree-heat and byte-range view of the on-disk edge-list array
    that ``select_pinned_blocks`` needs, in the store's namespaced block
    space."""

    def __init__(self, store: DiskStore):
        self._store = store
        self._base = store._ns["indices"] * _NS_STRIDE * store.block_bytes

    def degrees(self) -> np.ndarray:
        return self._store.degrees()

    def edge_byte_range(self, u: int, entry_bytes: int) -> tuple[int, int]:
        lo, hi = self._store.edge_byte_range(u, entry_bytes)
        return (self._base + lo, self._base + hi)


def open_store(kind: str, *, g: CSRGraph | None = None,
               path: str | None = None, block_bytes: int | None = None,
               **kw) -> GraphStore:
    """``mem`` needs ``g``; ``disk`` needs ``path`` (saving ``g`` there
    first when given, laid out in ``block_bytes`` units; an existing
    layout keeps its own block size and must hold ``g``)."""
    if kind == "mem":
        if g is None:
            raise ValueError("mem store needs a graph")
        return InMemoryStore(g)
    if kind == "disk":
        if path is None:
            raise ValueError("disk store needs a path")
        if g is not None and not os.path.exists(os.path.join(path, MANIFEST)):
            save_graph(g, path, block_bytes=block_bytes)
        store = DiskStore(path, **kw)
        if g is not None:
            if (store.name, store.num_nodes, store.num_edges,
                    store.feat_dim) != (g.name, g.num_nodes, g.num_edges,
                                        g.feat_dim):
                store.close()
                raise ValueError(
                    f"{path} holds graph {store.name!r} "
                    f"({store.num_nodes} nodes, {store.num_edges} edges), "
                    f"not {g.name!r} ({g.num_nodes} nodes, "
                    f"{g.num_edges} edges); point --store-dir elsewhere "
                    "or remove the stale layout")
        return store
    raise KeyError(f"unknown graph store {kind!r}; have ('mem', 'disk')")
