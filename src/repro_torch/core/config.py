"""Declarative data-plane configuration: the ``PipelineSpec`` tree.

The port's copy of the reference's ``core/config.py``.  SmartSAGE treats
large-scale GNN training as a storage-hierarchy configuration problem:
which arrays live in which tier (HBM / host DRAM / SSD) and what caching
sits between them.  This module makes that configuration one frozen,
serializable object:

* ``PipelineSpec``: a frozen dataclass tree of ``BackendSpec``,
  ``SamplerSpec``, ``StoreSpec`` (with ``IspSpec``, ``RetrySpec`` and
  ``FaultSpec``), per-tier ``CacheTierSpec``s, ``PrefetchSpec`` and
  ``ObsSpec``.  Validation runs at construction, and
  ``to_dict``/``from_dict``/``to_json``/``from_json`` round-trip exactly;
  the JSON schema is the reference's, so its spec files and the
  ``pipeline_spec`` of its checkpoint manifests load here unchanged.

* ``build_pipeline(spec, graph_or_store)``: the entry point the launcher
  and the tests share.  It opens the store the spec asks for (owning it,
  and any temp directory, for the lifetime of the returned ``Pipeline``):
  a ``DiskStore`` in-process, or under ``store.mode='isp'`` a storage
  process (``repro_torch.isp``) and its ``RemoteGraphStore``; attaches
  the simulated storage engine (``storage.engines``); installs the
  telemetry session of the ``obs`` node, and builds the loader.

* ``add_pipeline_args`` / ``spec_from_args``: the launcher's data-plane
  flags, generated from ``FLAG_TABLE`` (each flag maps to a spec field),
  with ``--spec file.json`` loading a whole configuration and the flags
  given as overrides.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Sequence

from repro_torch.storage.faults import FaultSpec
from repro_torch.storage.specs import DEFAULT, RetrySpec

BACKENDS = ("host", "isp", "pallas")
SAMPLERS = ("khop", "saint")
STORE_KINDS = ("mem", "disk")
STORE_MODES = ("local", "isp")
ISP_TRANSPORTS = ("unix", "tcp", "shm")
CACHE_POLICIES = ("lru", "pinned", "optimal")
CACHE_TIERS = ("host", "device")
DEVICE_ARRAYS = ("features", "topology")
ENGINES = ("none", "dram", "pmem", "mmap", "directio", "isp", "isp_oracle",
           "fpga")


def _check(value, name, choices):
    if value not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {value!r}")


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Which data-preparation backend runs, plus its private knobs.

    ``n_workers``/``queue_depth``/``straggler_factor`` configure the host
    producer pipeline; ``axis`` is the isp mesh axis.  Knobs for other
    backends are ignored (but preserved through serialization)."""

    name: str = "host"
    n_workers: int = 4
    queue_depth: int = 8
    straggler_factor: float = 4.0
    axis: str = "data"

    def __post_init__(self):
        _check(self.name, "backend.name", BACKENDS)
        if self.n_workers < 1 or self.queue_depth < 1:
            raise ValueError("backend.n_workers and backend.queue_depth "
                             "must be >= 1")


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Sampler family: GraphSAGE k-hop fanouts or GraphSAINT walks.

    The default fanouts are the launchers' CPU-scale (10, 5), not the
    paper's (25, 10)."""

    family: str = "khop"
    fanouts: tuple[int, ...] = (10, 5)
    walk_length: int = 4

    def __post_init__(self):
        _check(self.family, "sampler.family", SAMPLERS)
        object.__setattr__(self, "fanouts",
                           tuple(int(f) for f in self.fanouts))
        if not self.fanouts or any(f < 1 for f in self.fanouts):
            raise ValueError(f"sampler.fanouts must be positive ints, got "
                             f"{self.fanouts}")
        if self.walk_length < 1:
            raise ValueError("sampler.walk_length must be >= 1")

    @property
    def effective_fanouts(self) -> tuple[int, ...]:
        """The per-hop shape contract the loader/GNN see: a SAINT batch's
        one hop tensor is the whole (M, L+1) walk."""
        if self.family == "saint":
            return (self.walk_length + 1,)
        return self.fanouts


@dataclasses.dataclass(frozen=True)
class IspSpec:
    """The in-storage-processing service (``store.mode='isp'``): how the
    trainer reaches the storage process that owns the DiskStore
    (``transport`` ``unix``, ``tcp`` or ``shm``; ``address=None`` derives
    one from the store directory; ``window`` in-flight commands;
    ``server_cache=False`` shrinks the server's page cache to a
    minimum)."""

    transport: str = "unix"
    address: str | None = None
    window: int = 4
    server_cache: bool = True

    def __post_init__(self):
        _check(self.transport, "store.isp.transport", ISP_TRANSPORTS)
        if self.window < 1:
            raise ValueError("store.isp.window must be >= 1")
        object.__setattr__(self, "server_cache", bool(self.server_cache))


@dataclasses.dataclass(frozen=True)
class StoreSpec:
    """Where the graph arrays live: DRAM (``mem``) or the block-aligned
    on-disk DiskStore layout (``disk``).  ``path=None`` with ``disk``
    means a pipeline-owned temp directory.

    ``mode`` says who serves the disk layout (``local``: the DiskStore
    in-process; ``isp``: a storage process).  ``direct_io`` opens the
    backing files ``O_DIRECT``.  ``verify`` checks each block read's
    CRC32C; ``retry`` is the I/O retry policy every pread runs under;
    ``faults`` attaches the fault injector (an all-inactive FaultSpec
    normalizes to None so serialized specs stay canonical)."""

    kind: str = "mem"
    mode: str = "local"
    path: str | None = None
    block_bytes: int | None = None      # None = storage-spec default
    lock_shards: int | None = None      # None = storage-spec default
    io_threads: int | None = None       # None = storage-spec default (1)
    verify: bool = False
    direct_io: bool = False
    retry: RetrySpec = RetrySpec()
    faults: FaultSpec | None = None
    isp: IspSpec | None = None

    def __post_init__(self):
        _check(self.kind, "store.kind", STORE_KINDS)
        _check(self.mode, "store.mode", STORE_MODES)
        object.__setattr__(self, "direct_io", bool(self.direct_io))
        isp = self.isp
        if isinstance(isp, dict):
            _reject_unknown(IspSpec, isp, "store.isp")
            isp = IspSpec(**isp)
        if self.mode == "isp":
            if self.kind != "disk":
                raise ValueError(
                    "store.mode='isp' serves the on-disk layout from a "
                    "storage process; it needs store.kind='disk'")
            if isp is None:
                isp = IspSpec()
        else:
            isp = None              # canonical form: isp config rides
        object.__setattr__(self, "isp", isp)   # with isp mode only
        if self.block_bytes is not None and self.block_bytes < 512:
            raise ValueError("store.block_bytes must be >= 512")
        if self.lock_shards is not None and self.lock_shards < 1:
            raise ValueError("store.lock_shards must be >= 1")
        if self.io_threads is not None and self.io_threads < 1:
            raise ValueError("store.io_threads must be >= 1")
        object.__setattr__(self, "verify", bool(self.verify))
        retry = self.retry
        if retry is None:
            retry = RetrySpec()
        elif isinstance(retry, dict):
            retry = RetrySpec(**retry)
        object.__setattr__(self, "retry", retry)
        faults = self.faults
        if isinstance(faults, dict):
            faults = FaultSpec(**faults)
        if faults is not None and not faults.active:
            faults = None               # canonical form: inactive = absent
        object.__setattr__(self, "faults", faults)
        if self.faults is not None and self.faults.bitflip_rate > 0 \
                and not self.verify:
            raise ValueError(
                "store.faults.bitflip_rate > 0 needs store.verify=True: "
                "without checksum verification a flipped bit is silently "
                "trained on instead of detected and retried")


@dataclasses.dataclass(frozen=True)
class CacheTierSpec:
    """One cache tier of the storage hierarchy:

    * ``tier='host'``: the DiskStore's DRAM page cache over the SSD
      layout; ``capacity_mb`` is its budget (None = storage-spec
      default), spanning all on-disk arrays.
    * ``tier='device'``: the HBM cache over the host tier (pallas
      backend); ``arrays`` picks what reads through it: ``'features'``
      (a ``rows`` x F row cache read by ``feature_gather_cached``) and/or
      ``'topology'`` (an ``edge_blocks`` x BLOCK_E edge-block cache read
      by ``neighbor_sample_cached``).

    ``policy``: ``'lru'``, ``'pinned'`` (the hottest-by-degree
    ``pinned_fraction`` of the capacity staged permanently, LRU for the
    rest) or ``'optimal'`` (Belady eviction from a replay lane running
    ``oracle_window`` batches ahead)."""

    tier: str = "device"
    policy: str = "lru"
    capacity_mb: float | None = None        # host tier budget
    rows: int = 0                           # device tier: feature rows
    edge_blocks: int = 0                    # device tier: topology blocks
    pinned_fraction: float = 0.5
    arrays: tuple[str, ...] = ("features",)
    oracle_window: int = 0                  # replay window W (optimal only)

    def __post_init__(self):
        _check(self.tier, "cache tier", CACHE_TIERS)
        _check(self.policy, "cache policy", CACHE_POLICIES)
        object.__setattr__(self, "arrays", tuple(self.arrays))
        if not 0.0 <= self.pinned_fraction <= 1.0:
            raise ValueError("cache pinned_fraction must be in [0, 1]")
        if self.oracle_window < 0:
            raise ValueError("cache oracle_window must be >= 0")
        if self.policy == "optimal" and self.oracle_window < 1:
            raise ValueError(
                "policy 'optimal' needs oracle_window >= 1 (the Belady "
                "schedule is computed by replaying that many batches "
                "ahead)")
        if self.policy != "optimal" and self.oracle_window:
            raise ValueError(
                f"oracle_window applies to policy 'optimal' only (got "
                f"policy={self.policy!r}, oracle_window="
                f"{self.oracle_window})")
        if self.tier == "device":
            unknown = set(self.arrays) - set(DEVICE_ARRAYS)
            if unknown or not self.arrays:
                raise ValueError(
                    f"device cache arrays must be a non-empty subset of "
                    f"{DEVICE_ARRAYS}, got {self.arrays}")
            if ("features" in self.arrays) != (self.rows > 0):
                raise ValueError(
                    "device cache: rows > 0 exactly when 'features' is in "
                    f"arrays (got rows={self.rows}, arrays={self.arrays})")
            if ("topology" in self.arrays) != (self.edge_blocks > 0):
                raise ValueError(
                    "device cache: edge_blocks > 0 exactly when 'topology' "
                    f"is in arrays (got edge_blocks={self.edge_blocks}, "
                    f"arrays={self.arrays})")
        else:
            if self.rows or self.edge_blocks:
                raise ValueError("host tier capacity is capacity_mb; "
                                 "rows/edge_blocks are device-tier fields")
            if self.capacity_mb is not None and self.capacity_mb <= 0:
                raise ValueError("host cache capacity_mb must be > 0")

    @classmethod
    def device(cls, *, rows: int = 0, edge_blocks: int = 0,
               policy: str = "lru", pinned_fraction: float = 0.5,
               oracle_window: int = 0) -> "CacheTierSpec":
        """Device tier with ``arrays`` derived from the capacities: the
        one place the rows/edge_blocks <-> arrays rule lives."""
        arrays = (("features",) if rows else ()) + \
            (("topology",) if edge_blocks else ())
        return cls(tier="device", policy=policy, rows=int(rows),
                   edge_blocks=int(edge_blocks),
                   pinned_fraction=pinned_fraction, arrays=arrays,
                   oracle_window=int(oracle_window))


@dataclasses.dataclass(frozen=True)
class PrefetchSpec:
    """Async prefetch configuration.

    ``depth`` is the bounded output-queue capacity (0 = synchronous; 2 =
    double buffer).  ``overlap=True`` runs the multi-stage
    ``OverlappedLoader``: sampling, cache miss resolution and admission
    each on a lane of its own, ``stage_depth`` batches deep.
    ``plan_ahead > 0`` runs the frontier planner, which warms the host
    page cache for batch ``t+plan_ahead`` while batch ``t`` is in flight.
    ``lane_timeout_s`` is the stall watchdog's heartbeat budget, and
    ``max_lane_restarts`` the restarts before the loader degrades to
    synchronous composition."""

    depth: int = 0
    overlap: bool = False
    stage_depth: int = 2
    plan_ahead: int = 0
    lane_timeout_s: float = 30.0        # stall watchdog: heartbeat budget
    max_lane_restarts: int = 3          # then degrade to sync composition

    def __post_init__(self):
        object.__setattr__(self, "overlap", bool(self.overlap))
        if self.depth < 0:
            raise ValueError("prefetch.depth must be >= 0")
        if self.stage_depth < 1:
            raise ValueError("prefetch.stage_depth must be >= 1")
        if self.plan_ahead < 0:
            raise ValueError("prefetch.plan_ahead must be >= 0")
        if self.overlap and self.depth < 1:
            raise ValueError("prefetch.overlap needs depth >= 1 (the "
                             "overlapped pipeline drains through the "
                             "prefetch queue)")
        if self.lane_timeout_s <= 0:
            raise ValueError("prefetch.lane_timeout_s must be > 0")
        if self.max_lane_restarts < 0:
            raise ValueError("prefetch.max_lane_restarts must be >= 0")


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Telemetry configuration (the ``obs`` node): ``enabled`` turns the
    telemetry layer on; ``trace_path`` adds a Chrome/Perfetto trace,
    ``metrics_path`` JSONL snapshots every ``metrics_interval_s``.
    Setting either path implies ``enabled``."""

    enabled: bool = False
    trace_path: str | None = None
    metrics_path: str | None = None
    metrics_interval_s: float = 5.0

    def __post_init__(self):
        object.__setattr__(self, "enabled", bool(
            self.enabled or self.trace_path or self.metrics_path))
        if self.metrics_interval_s <= 0:
            raise ValueError("obs.metrics_interval_s must be > 0")


_COMPONENTS = {
    "backend": BackendSpec,
    "sampler": SamplerSpec,
    "store": StoreSpec,
    "prefetch": PrefetchSpec,
    "obs": ObsSpec,
}


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """The whole data-plane configuration, one serializable tree.

    Construction validates cross-component compatibility, so an invalid
    combination fails before any store is opened or kernel built."""

    backend: BackendSpec = BackendSpec()
    sampler: SamplerSpec = SamplerSpec()
    store: StoreSpec = StoreSpec()
    cache_tiers: tuple[CacheTierSpec, ...] = ()
    prefetch: PrefetchSpec = PrefetchSpec()
    obs: ObsSpec = ObsSpec()
    batch_size: int = 64
    seed: int = 0
    engine: str = "none"

    def __post_init__(self):
        object.__setattr__(self, "cache_tiers", tuple(self.cache_tiers))
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        _check(self.engine, "engine", ENGINES)
        if self.sampler.family == "saint" and self.backend.name != "host":
            raise ValueError(
                "sampler family 'saint' runs on the host backend only "
                f"(numpy random walks), not {self.backend.name!r}")
        by_tier: dict[str, int] = {}
        for t in self.cache_tiers:
            by_tier[t.tier] = by_tier.get(t.tier, 0) + 1
        if any(n > 1 for n in by_tier.values()):
            raise ValueError("at most one cache tier per level "
                             f"(got {by_tier})")
        if "host" in by_tier and self.store.kind != "disk":
            raise ValueError("a host cache tier fronts the on-disk layout; "
                             "it needs store.kind='disk'")
        host = self.host_cache_tier()
        if self.store.mode == "isp" and host is not None \
                and host.policy == "optimal":
            raise ValueError(
                "store.mode='isp' cannot run the host tier's 'optimal' "
                "policy: the Belady oracle lane replays the sampler "
                "trainer-side, but the page cache lives in the storage "
                "process; use 'lru' or 'pinned' (served server-side)")
        if self.store.mode == "isp" and self.backend.name == "isp":
            raise ValueError(
                "backend 'isp' (device-mesh shards) never reads through a "
                "store, so store.mode='isp' would spawn a storage process "
                "nothing talks to; use the host or pallas backend")
        dev = self.device_cache_tier()
        if dev is not None and self.backend.name != "pallas":
            raise ValueError(
                "a device cache tier applies to the pallas backend only "
                f"(got backend {self.backend.name!r}); features and "
                "topology caches live in HBM in front of the device "
                "kernels")

    # -- tier lookups --------------------------------------------------------
    def host_cache_tier(self) -> CacheTierSpec | None:
        return next((t for t in self.cache_tiers if t.tier == "host"), None)

    def device_cache_tier(self) -> CacheTierSpec | None:
        return next((t for t in self.cache_tiers if t.tier == "device"), None)

    def feature_cache(self) -> CacheTierSpec | None:
        t = self.device_cache_tier()
        return t if t is not None and "features" in t.arrays else None

    def topology_cache(self) -> CacheTierSpec | None:
        t = self.device_cache_tier()
        return t if t is not None and "topology" in t.arrays else None

    @property
    def effective_fanouts(self) -> tuple[int, ...]:
        return self.sampler.effective_fanouts

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineSpec":
        d = dict(d)
        kw = {}
        for key, comp in _COMPONENTS.items():
            if key in d:
                sub = d.pop(key)
                if isinstance(sub, dict):
                    _reject_unknown(comp, sub, key)
                    sub = comp(**sub)
                kw[key] = sub
        if "cache_tiers" in d:
            tiers = []
            for t in d.pop("cache_tiers"):
                if isinstance(t, dict):
                    _reject_unknown(CacheTierSpec, t, "cache_tiers[]")
                    t = CacheTierSpec(**t)
                tiers.append(t)
            kw["cache_tiers"] = tuple(tiers)
        _reject_unknown(cls, d, "spec")
        return cls(**kw, **d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=kw.pop("indent", 2), **kw)

    @classmethod
    def from_json(cls, s: str) -> "PipelineSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def load(cls, path: str) -> "PipelineSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kw) -> "PipelineSpec":
        return dataclasses.replace(self, **kw)


def _reject_unknown(cls, d: dict, where: str) -> None:
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"unknown {where} field(s): {sorted(unknown)}")


# ---------------------------------------------------------------------------
# the assembled pipeline: the resources a spec materializes into
# ---------------------------------------------------------------------------

class Pipeline:
    """A built data plane: the loader plus every resource the spec opened.

    Implements the loader protocol by delegation, so it can be handed to
    ``build_train_step``/``train_loop``.  ``close`` releases the loader
    and any store or temp directory the pipeline created (a store the
    caller passed is left open), and finalizes the telemetry session."""

    def __init__(self, spec: PipelineSpec, loader, *, graph=None, store=None,
                 engine=None, owns_store: bool = False,
                 tmpdir: str | None = None, obs_session=None):
        self.spec = spec
        self.loader = loader
        self.graph = graph
        self.store = store
        self.engine = engine
        self.obs = obs_session
        self.notes: list[str] = []
        self._owns_store = owns_store
        self._tmpdir = tmpdir
        self._closed = False

    @property
    def backend(self) -> str:
        return self.loader.backend

    @property
    def fanouts(self) -> tuple[int, ...]:
        return tuple(self.loader.fanouts)

    def get_batch(self, idx: int, **kw):
        return self.loader.get_batch(idx, **kw)

    def stats(self) -> dict:
        return self.loader.stats()

    def start_epoch(self) -> None:
        mark = getattr(self.loader, "start_epoch", None)
        if mark is not None:
            mark()

    def describe(self) -> str:
        s = self.spec
        bits = [f"backend={s.backend.name}", f"sampler={s.sampler.family}",
                f"store={s.store.kind}"]
        if s.store.mode == "isp":
            bits.append(f"isp({s.store.isp.transport}, "
                        f"window={s.store.isp.window})")
        if s.store.direct_io:
            bits.append("direct_io")
        if s.store.verify:
            bits.append("verify=crc32c")
        if s.store.faults is not None:
            bits.append("faults=injected")
        if s.engine != "none":
            bits.append(f"engine={s.engine}")
        if s.prefetch.depth:
            bits.append(f"prefetch={s.prefetch.depth}")
        if s.prefetch.overlap:
            bits.append(f"overlap(stages={s.prefetch.stage_depth}, "
                        f"plan_ahead={s.prefetch.plan_ahead})")
        host = s.host_cache_tier()
        if host is not None:
            bits.append(f"host-cache={host.capacity_mb or 'default'}MB"
                        f"({host.policy})")
        dev = s.device_cache_tier()
        if dev is not None:
            parts = []
            if "features" in dev.arrays:
                parts.append(f"{dev.rows} rows")
            if "topology" in dev.arrays:
                parts.append(f"{dev.edge_blocks} edge blocks")
            bits.append(f"device-cache={'+'.join(parts)}({dev.policy})")
        return ", ".join(bits)

    def close(self) -> None:
        if self._closed:                # idempotent: finally-blocks and
            return                      # __exit__ may both reach here
        self._closed = True
        try:
            self.loader.close()
        finally:
            if self.obs is not None:
                # flush the trace and the final metrics snapshot before
                # the store (a collector source) goes away
                self.obs.close()
            if self._owns_store and self.store is not None:
                self.store.close()
            if self._tmpdir is not None:
                shutil.rmtree(self._tmpdir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def build_pipeline(spec: PipelineSpec, graph_or_store=None, *, g=None,
                   store=None, mesh=None, device="cuda") -> Pipeline:
    """Materialize ``spec`` into a running data plane on ``device``.

    ``graph_or_store`` (or the ``g``/``store`` keywords) supplies the
    data: a ``CSRGraph``, a ``GraphStore``, or both.  When the spec asks
    for a disk store and none was passed, the pipeline writes the graph
    into ``spec.store.path`` (or a temp directory it owns) and opens a
    ``DiskStore`` with the host cache tier's budget and policy, or, under
    ``store.mode='isp'``, spawns the storage process that owns it
    (``_open_isp_store``).  A spec naming an ``engine`` attaches it,
    measured against the store when there is one.  ``mesh`` places the
    ``isp`` backend's shards (``launch.mesh``; default one shard on
    ``device``).  Returns a ``Pipeline`` that owns exactly the resources
    it created."""
    from repro_torch.core.graph import CSRGraph

    if graph_or_store is not None:
        if isinstance(graph_or_store, CSRGraph):
            if g is not None:
                raise ValueError("pass the graph positionally or as g=, "
                                 "not both")
            g = graph_or_store
        else:
            if store is not None:
                raise ValueError("pass the store positionally or as store=, "
                                 "not both")
            store = graph_or_store
    if g is None and store is None:
        raise ValueError("build_pipeline needs a graph and/or a GraphStore")

    owns_store = False
    tmpdir = None
    notes = []
    if store is None and spec.store.kind == "disk":
        device_only = spec.backend.name == "pallas" and \
            spec.device_cache_tier() is None
        if spec.backend.name == "isp" and g is not None:
            notes.append("store.kind='disk' does not apply to the isp "
                         "backend (mesh shards are device-resident); "
                         "proceeding in-memory")
        elif device_only and g is not None:
            notes.append("pallas without a device cache tier never reads "
                         "through the store; proceeding in-memory "
                         "(full-table upload)")
        else:
            from repro_torch.storage.store import open_store
            path = spec.store.path
            if path is None:
                name = g.name if g is not None else "graph"
                path = tmpdir = tempfile.mkdtemp(prefix=f"graphstore-{name}-")
            host = spec.host_cache_tier()
            store_kw = {}
            if spec.store.lock_shards is not None:
                store_kw["lock_shards"] = spec.store.lock_shards
            if spec.store.io_threads is not None:
                store_kw["io_threads"] = spec.store.io_threads
            try:
                if spec.store.mode == "isp":
                    store = _open_isp_store(spec, g, path)
                else:
                    store = open_store(
                        "disk", g=g, path=path,
                        block_bytes=spec.store.block_bytes,
                        cache_mb=None if host is None else host.capacity_mb,
                        policy=None if host is None else host.policy,
                        verify=spec.store.verify,
                        direct_io=spec.store.direct_io,
                        retry=spec.store.retry, faults=spec.store.faults,
                        **store_kw)
            except BaseException:
                if tmpdir is not None:
                    shutil.rmtree(tmpdir, ignore_errors=True)
                raise
            owns_store = True

    from repro_torch.core.loader import _build_loader
    engine = None
    obs_session = None
    try:
        if spec.engine != "none":
            from repro_torch.storage.engines import make_engine
            if g is None:
                # one materialization, reused by the loader below (the
                # engines model the whole graph, features included)
                g = store.to_csr()
            engine = make_engine(spec.engine, g, measured=store is not None,
                                 store=store)
        if spec.obs.enabled:
            from repro_torch import obs
            obs_session = obs.install(obs.ObsSession(
                trace_path=spec.obs.trace_path,
                metrics_path=spec.obs.metrics_path,
                metrics_interval_s=spec.obs.metrics_interval_s))
        loader = _build_loader(spec, g=g, store=store, mesh=mesh,
                               storage_engine=engine, device=device)
    except BaseException:
        if obs_session is not None:
            obs_session.close()
        if owns_store:
            store.close()
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    if obs_session is not None:
        # absorb the loader's counter surfaces (store I/O bill, cache
        # tiers, oracle lane, lane supervisor) into every snapshot; all
        # of them are host ints, so a snapshot never waits on the device
        from repro_torch.obs import names as _names
        obs_session.registry.register_collector(
            lambda: _names.flatten_stats(loader.stats()))
    pipe = Pipeline(spec, loader, graph=g, store=store, engine=engine,
                    owns_store=owns_store, tmpdir=tmpdir,
                    obs_session=obs_session)
    pipe.notes = notes
    return pipe


def _open_isp_store(spec: PipelineSpec, g, path: str):
    """Spawn the storage process over ``path`` and return the trainer's
    ``RemoteGraphStore`` view of it.

    The layout is written trainer-side first (the one-time ingest any
    real device would also need); the server then owns the DiskStore:
    page cache, retry and fault machinery and CRC verification all run
    in the storage process, and only command replies cross the wire.
    The unix socket's default address is ``<path>/.isp.sock``."""
    from repro_torch.isp.client import IspClient, RemoteGraphStore
    from repro_torch.isp.server import spawn_server
    from repro_torch.storage.store import MANIFEST, save_graph

    if g is not None and not os.path.exists(os.path.join(path, MANIFEST)):
        save_graph(g, path, block_bytes=spec.store.block_bytes)
    isp = spec.store.isp
    address = isp.address
    if address is None:
        if isp.transport == "unix":
            address = os.path.join(path, ".isp.sock")
        elif isp.transport == "shm":
            address = f"isp-{os.getpid():x}"
        else:
            raise ValueError(
                "store.isp.transport='tcp' needs an explicit "
                "store.isp.address ('host:port')")
    host = spec.host_cache_tier()
    sstore: dict = {"path": path, "verify": spec.store.verify,
                    "direct_io": spec.store.direct_io,
                    "retry": dataclasses.asdict(spec.store.retry)}
    if spec.store.lock_shards is not None:
        sstore["lock_shards"] = spec.store.lock_shards
    if spec.store.io_threads is not None:
        sstore["io_threads"] = spec.store.io_threads
    if spec.store.faults is not None:
        sstore["faults"] = dataclasses.asdict(spec.store.faults)
    if not isp.server_cache:
        # worst-case-wire configuration: a nominal cache so (almost)
        # every block read hits the backing files
        sstore["cache_mb"] = 1.0
    elif host is not None:
        if host.capacity_mb is not None:
            sstore["cache_mb"] = host.capacity_mb
        sstore["policy"] = host.policy
    config = {"transport": isp.transport, "address": address,
              "store": sstore}
    if spec.obs.enabled and (spec.obs.trace_path or spec.obs.metrics_path):
        # the storage process writes its own telemetry next to the
        # trainer's (the same files would clobber each other)
        config["obs"] = {
            "trace_path": spec.obs.trace_path
            and spec.obs.trace_path + ".isp",
            "metrics_path": spec.obs.metrics_path
            and spec.obs.metrics_path + ".isp",
            "metrics_interval_s": spec.obs.metrics_interval_s}
    proc = spawn_server(config)
    try:
        client = IspClient(isp.transport, address, window=isp.window)
    except Exception:
        proc.kill()
        proc.wait(timeout=5.0)
        raise
    store = RemoteGraphStore(client, server_proc=proc)
    if g is not None and (store.name, store.num_nodes, store.num_edges,
                          store.feat_dim) != (g.name, g.num_nodes,
                                              g.num_edges, g.feat_dim):
        store.close()
        raise ValueError(
            f"{path} holds graph {store.name!r}, not {g.name!r}; point "
            "--store-dir elsewhere or remove the stale layout")
    return store


# ---------------------------------------------------------------------------
# CLI surface: flags generated from the spec field table
# ---------------------------------------------------------------------------

def _parse_fanouts(s) -> tuple[int, ...]:
    if isinstance(s, (tuple, list)):
        return tuple(int(x) for x in s)
    return tuple(int(x) for x in str(s).split(","))


#: flag -> (spec path, argparse kwargs), the reference's entries.  Paths address the spec tree; the pseudo-paths
#: ``cache.*`` / ``devcache.*`` configure the two cache tiers (a host tier
#: exists iff the store is on disk; a device tier iff rows or edge_blocks
#: is set).
FLAG_TABLE = {
    "--backend": ("backend.name", dict(
        choices=BACKENDS,
        help="GNN data-preparation backend (SubgraphLoader)")),
    "--sampler": ("sampler.family", dict(
        choices=SAMPLERS,
        help="sampler family: GraphSAGE k-hop fanouts or GraphSAINT "
             "random walks (host backend only)")),
    "--fanouts": ("sampler.fanouts", dict(
        type=_parse_fanouts, metavar="F1,F2,...",
        help="per-hop fanouts for the khop sampler")),
    "--walk-length": ("sampler.walk_length", dict(
        type=int, help="GraphSAINT walk length (--sampler saint)")),
    "--batch": ("batch_size", dict(type=int, help="minibatch size")),
    "--seed": ("seed", dict(
        type=int, help="per-batch target/sampling seed")),
    "--prefetch": ("prefetch.depth", dict(
        type=int,
        help="async prefetch queue depth (0 = synchronous; 2 = double "
             "buffering): overlap data preparation with training")),
    "--overlap": ("prefetch.overlap", dict(
        type=int, choices=(0, 1), metavar="0|1",
        help="1 = multi-stage overlapped out-of-core pipeline "
             "(sample / miss-resolve / admit+upload lanes draining "
             "concurrently; needs --prefetch >= 1)")),
    "--stage-depth": ("prefetch.stage_depth", dict(
        type=int,
        help="overlapped pipeline: per-stage queue depth (how many "
             "batches each lane may run ahead of the next)")),
    "--plan-ahead": ("prefetch.plan_ahead", dict(
        type=int,
        help="overlapped pipeline: frontier-planner window; warm the "
             "host page cache for batch t+N's probable reads while "
             "batch t is in flight (0 = off)")),
    "--storage-engine": ("engine", dict(
        choices=ENGINES,
        help="simulated storage tier attached to the loader")),
    "--graph-store": ("store.kind", dict(
        choices=STORE_KINDS,
        help="where the graph data lives: 'mem' = DRAM arrays, 'disk' = "
             "out-of-core DiskStore (block-aligned on-disk layout + live "
             "page cache)")),
    "--store-dir": ("store.path", dict(
        help="directory for the on-disk graph layout (default: a fresh "
             "temp dir; reused if it already holds a manifest)")),
    "--store-mode": ("store.mode", dict(
        choices=STORE_MODES,
        help="who serves the disk layout: 'local' opens the DiskStore "
             "in-process; 'isp' spawns the in-storage processing "
             "service — a storage process owning the store, with k-hop "
             "sample+gather pushed down so only sampled bytes cross "
             "the wire")),
    "--direct-io": ("store.direct_io", dict(
        type=int, choices=(0, 1), metavar="0|1",
        help="1 = open the disk store's backing files O_DIRECT (bypass "
             "the OS page cache; aligned preads into a pooled buffer), "
             "falling back to buffered reads where the filesystem "
             "refuses")),
    "--isp-transport": ("store.isp.transport", dict(
        choices=ISP_TRANSPORTS,
        help="isp mode: command-queue transport — unix socket (default), "
             "tcp, or shm (two SPSC shared-memory rings; single "
             "connection, no reconnect)")),
    "--isp-address": ("store.isp.address", dict(
        metavar="ADDR",
        help="isp mode: transport address (unix: socket path; tcp: "
             "host:port; shm: segment name prefix; default derives from "
             "the store directory)")),
    "--isp-window": ("store.isp.window", dict(
        type=int,
        help="isp mode: pipelined in-flight command window (concurrent "
             "producer round-trips overlap instead of serializing)")),
    "--isp-server-cache": ("store.isp.server_cache", dict(
        type=int, choices=(0, 1), metavar="0|1",
        help="isp mode: 1 = the storage process runs the host cache "
             "tier's page-cache budget/policy; 0 = minimal server "
             "cache, every read hits the backing files")),
    "--lock-shards": ("store.lock_shards", dict(
        type=int,
        help="disk-store page-cache lock shards (default: storage spec; "
             "1 = single global lock)")),
    "--io-threads": ("store.io_threads", dict(
        type=int,
        help="disk-store pread pool size: concurrent block fetches per "
             "multi-range gather (default: storage spec, 1 = serial "
             "reads; keep <= --lock-shards)")),
    "--verify-blocks": ("store.verify", dict(
        type=int, choices=(0, 1), metavar="0|1",
        help="1 = verify the per-block CRC32C checksum on every disk "
             "read (needs a layout saved with checksums; mismatches "
             "count as corrupt_blocks and are retried)")),
    "--io-retries": ("store.retry.max_attempts", dict(
        type=int,
        help="disk-store I/O retry policy: total attempts per block "
             "read before StoreReadError (1 = no retry)")),
    "--io-retry-backoff": ("store.retry.backoff_s", dict(
        type=float,
        help="disk-store I/O retry policy: sleep before the first "
             "retry, doubled per further retry (deterministic jitter)")),
    "--io-deadline": ("store.retry.deadline_s", dict(
        type=float,
        help="disk-store I/O retry policy: per-attempt wall-clock "
             "budget in seconds (overruns count as timeouts)")),
    "--lane-timeout": ("prefetch.lane_timeout_s", dict(
        type=float,
        help="overlapped pipeline: lane heartbeat budget in seconds "
             "before the stall watchdog restarts the lanes")),
    "--max-lane-restarts": ("prefetch.max_lane_restarts", dict(
        type=int,
        help="overlapped pipeline: watchdog restarts before degrading "
             "permanently to synchronous composition")),
    "--fault-seed": ("store.faults.seed", dict(
        type=int,
        help="fault injection: deterministic schedule seed")),
    "--fault-eio": ("store.faults.eio_rate", dict(
        type=float,
        help="fault injection: per-(block, first attempt) probability "
             "of a transient EIO (0 = off)")),
    "--fault-short-read": ("store.faults.short_read_rate", dict(
        type=float,
        help="fault injection: probability of a truncated pread")),
    "--fault-bitflip": ("store.faults.bitflip_rate", dict(
        type=float,
        help="fault injection: probability of a flipped payload bit "
             "(needs --verify-blocks 1 to be detectable)")),
    "--fault-stall": ("store.faults.stall_rate", dict(
        type=float,
        help="fault injection: probability of a stalled pread")),
    "--fault-stall-s": ("store.faults.stall_s", dict(
        type=float, help="fault injection: stalled-pread duration")),
    "--cache-mb": ("cache.capacity_mb", dict(
        type=float,
        help="host tier: disk-store page-cache budget in MB (default: "
             "storage spec; set below the on-disk footprint to exercise "
             "the beyond-DRAM working set)")),
    "--cache-policy": ("cache.policy", dict(
        choices=CACHE_POLICIES,
        help="host tier placement: OS-page-cache-style LRU, hot-block "
             "pinning + LRU spill, or Belady-optimal from sampler "
             "replay")),
    "--cache-oracle-window": ("cache.oracle_window", dict(
        type=int,
        help="host tier, policy 'optimal': superbatch replay window in "
             "batches (the Belady schedule's lookahead)")),
    "--device-cache-rows": ("devcache.rows", dict(
        type=int,
        help="device tier (pallas): HBM feature-cache capacity in rows "
             "(0 = full-table upload)")),
    "--edge-cache-blocks": ("devcache.edge_blocks", dict(
        type=int,
        help="device tier (pallas): HBM edge-block cache capacity in "
             "BLOCK_E-wide topology blocks (0 = full edge-array upload); "
             "with it the sampling kernel too runs beyond HBM")),
    "--device-cache-policy": ("devcache.policy", dict(
        choices=CACHE_POLICIES,
        help="device tier placement: LRU recency, degree-pinned hot "
             "set + LRU spill, or Belady-optimal from sampler replay")),
    "--device-cache-oracle-window": ("devcache.oracle_window", dict(
        type=int,
        help="device tier, policy 'optimal': superbatch replay window "
             "in batches")),
    "--device-cache-pinned-fraction": ("devcache.pinned_fraction", dict(
        type=float,
        help="device tier: fraction of the capacity staged permanently "
             "under the pinned policy")),
    "--trace-out": ("obs.trace_path", dict(
        metavar="PATH",
        help="telemetry: write a Chrome/Perfetto trace-event JSON of "
             "the run (pipeline lanes, consumer steps, disk preads) to "
             "PATH; implies obs.enabled")),
    "--metrics-out": ("obs.metrics_path", dict(
        metavar="PATH",
        help="telemetry: append periodic JSONL metrics snapshots "
             "(canonical counter namespace: per-tier hit rates, I/O "
             "bytes, faults) to PATH; implies obs.enabled")),
    "--metrics-interval": ("obs.metrics_interval_s", dict(
        type=float,
        help="telemetry: seconds between JSONL metrics snapshots "
             "(a final snapshot is always written at close)")),
}

#: argparse default marking "flag not given", distinguishable from an
#: explicitly passed value that equals the spec default, so
#: ``--spec file.json --prefetch 0`` really turns prefetch off
_UNSET = object()


def _spec_defaults() -> dict:
    """The default spec as a tree, plus the two tiers' scratch dicts."""
    d = PipelineSpec().to_dict()
    # plain dicts, not CacheTierSpec instances: rows=0 just means "no
    # tier yet", which the real constructor (rightly) rejects
    d["cache"] = dict(tier="host", policy=DEFAULT.diskstore.policy,
                      capacity_mb=None, rows=0, edge_blocks=0,
                      pinned_fraction=0.5, arrays=(), oracle_window=0)
    d["devcache"] = dict(
        tier="device", policy=DEFAULT.devcache.policy, capacity_mb=None,
        rows=0, edge_blocks=0,
        pinned_fraction=DEFAULT.devcache.pinned_fraction,
        arrays=("features",), oracle_window=0)
    # faults/isp are None in the canonical spec; the flag paths need
    # scratch dicts to write through (faults: all-zero normalizes back to
    # None; isp: dropped unless store.mode is 'isp')
    d["store"]["faults"] = dataclasses.asdict(FaultSpec())
    d["store"]["isp"] = dataclasses.asdict(IspSpec())
    return d


def _tree_get(tree: dict, path: str):
    node = tree
    for part in path.split("."):
        node = node[part]
    return node


def _tree_set(tree: dict, path: str, value) -> None:
    parts = path.split(".")
    node = tree
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value


def _dest(flag: str) -> str:
    return flag.lstrip("-").replace("-", "_")


def add_pipeline_args(parser, exclude: Sequence[str] = (),
                      overrides: dict | None = None) -> None:
    """Attach the generated data-plane flags (plus ``--spec``) to an
    ``argparse`` parser.  ``exclude`` drops flags; ``overrides`` changes
    a flag's default (by dest name, e.g. ``{"backend": "pallas"}``).

    Flags without an override default to the ``_UNSET`` sentinel, so
    ``spec_from_args`` can tell "not given" from "set to the default
    value"; launchers that read flag attributes directly call
    ``fill_pipeline_flag_defaults(args)`` first."""
    parser.add_argument("--spec", default=None, metavar="FILE",
                        help="load the data-plane PipelineSpec from a JSON "
                             "file; individual flags override its fields")
    flag_defaults = {}
    for flag, (path, kw) in FLAG_TABLE.items():
        if flag in exclude:
            continue
        dest = _dest(flag)
        default = _UNSET
        if overrides and dest in overrides:
            default = overrides[dest]
            flag_defaults[dest] = default
        parser.add_argument(flag, dest=dest, default=default, **kw)
    parser.set_defaults(_pipeline_flag_defaults=flag_defaults)


def fill_pipeline_flag_defaults(args) -> None:
    """Replace ``_UNSET`` flag values with the spec defaults, in place."""
    defaults = _spec_defaults()
    for flag, (path, _) in FLAG_TABLE.items():
        dest = _dest(flag)
        if getattr(args, dest, None) is _UNSET:
            setattr(args, dest, _tree_get(defaults, path))


def spec_from_args(args) -> PipelineSpec:
    """Build a ``PipelineSpec`` from parsed CLI args.

    With ``--spec FILE`` the file is the base configuration and every
    flag the user passed overrides its field (even when the value equals
    the flag's default); without, the flags define the spec.  Cache tiers
    are derived: a host tier exists iff the store is on disk, a device
    tier iff feature rows or topology edge blocks were requested."""
    defaults = _spec_defaults()
    flag_defaults = getattr(args, "_pipeline_flag_defaults", {})
    base = None
    spec_path = getattr(args, "spec", None)
    if spec_path:
        base = PipelineSpec.load(spec_path)

    tree = base.to_dict() if base is not None else PipelineSpec().to_dict()
    # the faults/isp flags need a dict to write through even when the
    # base spec carries none (StoreSpec normalizes all-inactive faults,
    # and any isp config outside isp mode, back to None)
    if tree["store"].get("faults") is None:
        tree["store"]["faults"] = dict(defaults["store"]["faults"])
    if tree["store"].get("isp") is None:
        tree["store"]["isp"] = dict(defaults["store"]["isp"])
    # scratch dicts for the two tiers, seeded from the base spec's tiers
    cache = dict(defaults["cache"])
    devcache = dict(defaults["devcache"])
    for t in tree.pop("cache_tiers", ()):
        if t["tier"] == "host":
            cache = dict(t)
        else:
            devcache = dict(t)
    tree["cache"], tree["devcache"] = cache, devcache

    for flag, (path, _) in FLAG_TABLE.items():
        dest = _dest(flag)
        if not hasattr(args, dest):
            continue
        value = getattr(args, dest)
        if value is _UNSET:
            continue                    # flag not given: keep the base
        if base is not None and dest in flag_defaults \
                and value == flag_defaults[dest]:
            # a launcher-overridden default is indistinguishable from
            # "not given": keep the spec's value
            continue
        _tree_set(tree, path, value)

    cache = tree.pop("cache")
    devcache = tree.pop("devcache")
    tiers = []
    if tree["store"]["kind"] == "disk":
        cache["arrays"] = []            # host tier spans the whole store
        cache["rows"] = cache["edge_blocks"] = 0
        tiers.append(cache)
    rows = int(devcache.get("rows") or 0)
    edge_blocks = int(devcache.get("edge_blocks") or 0)
    if rows or edge_blocks:
        tiers.append(CacheTierSpec.device(
            rows=rows, edge_blocks=edge_blocks, policy=devcache["policy"],
            pinned_fraction=devcache["pinned_fraction"],
            oracle_window=int(devcache.get("oracle_window") or 0)))
    tree["cache_tiers"] = tiers
    return PipelineSpec.from_dict(tree)
