"""The minibatch data plane and the training loop, in PyTorch.

The port of the reference's ``core/loader.py``: the ``pallas``, ``host``
and ``isp`` backends.  On ``pallas`` a batch is sampled k hops by the
``neighbor_sample`` kernel and its features are gathered by the
``feature_gather_rows`` kernel, both hand-written CUDA for Hopper when
the loader's device is a GPU (the plain PyTorch versions on the CPU, as
the tests run it).  On ``host`` (the paper's CPU data preparation,
Fig. 4) producer threads sample with the numpy ``sample_khop`` (or
GraphSAINT walks) and gather through the store, and ``get_batch`` copies
the batch's features and labels to the device.  On ``isp`` (the mesh ISP
backend, ``core.isp``) the graph lives partitioned over the shards of a
mesh (``launch.mesh``), each shard samples and gathers the targets it
owns, and the shard results are summed: plain torch ops, no kernel, and
the ``pallas`` backend's ids and features at equal seeds.

Out of core, the graph is read through a ``GraphStore`` (``store=``,
typically a ``DiskStore`` behind its page cache) and either array family
can sit behind a device cache tier (``core.config.CacheTierSpec``)
instead of a full upload: feature rows behind a ``DeviceFeatureCache``
read by ``feature_gather_cached``, edge blocks behind a
``DeviceEdgeBlockCache`` read by ``neighbor_sample_cached``.  That path
is the reference's staged composition, sample -> resolve -> admit, run
back to back here or on the lanes of ``core.pipeline.OverlappedLoader``;
each batch's ``Minibatch.trace.io`` holds its exact store, devcache and
edgecache counters, and ``Minibatch.launches`` the kernel launches its
stages made.  A feature-cache fetch that fails past the store's retry
policy trips the reference's one-strike bypass: from then on each
batch's unique rows are read straight from the store, uploaded once and
gathered by ``feature_gather_rows``, with unchanged values.

A simulated storage tier (``storage.engines``, the spec's ``engine``) can
be attached to any loader: each batch's access trace is replayed against
the engine's cost model and the modeled latency is imposed on the batch's
preparation (``impose_storage_cost``; the host producers sleep it), so a
slow simulated device shows as consumer idle time.

``_build_loader`` builds the loader a ``PipelineSpec`` describes
(``core.config.build_pipeline`` is the entry point), attaches the Belady
replay lane when a tier is ``optimal`` (``storage.oracle``), and wraps
the loader in a ``PrefetchingLoader`` or an ``OverlappedLoader`` when the
spec prefetches; ``make_loader`` is the reference's keyword shim over it.

Randomness matches the reference exactly: targets of batch ``i`` come
from ``np.random.default_rng(seed + i)``, and sampling bits from the
threefry stream ``fold_in(fold_in(key(seed), i), hop)`` (``repro_torch.
rng``), drawn on the loader's device, so the port's minibatches equal the
reference's at equal seeds, cached or not, and the ``isp`` backend's equal
the ``pallas`` backend's.  The host backend's numpy
sampler draws from ``np.random.default_rng(seed + i)``, as the
reference's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch import kernels, obs, rng
from repro_torch.core.config import (BackendSpec, CacheTierSpec,
                                     PipelineSpec, PrefetchSpec, SamplerSpec,
                                     StoreSpec)
from repro_torch.core.gnn import gnn_loss_fn
from repro_torch.core.graph import CSRGraph
from repro_torch.core.sampler import (DEFAULT_FANOUTS, SampleTrace,
                                      _io_delta, _io_snapshot, sample_khop,
                                      saint_random_walk)
from repro_torch.kernels import ops
from repro_torch.obs.metrics import idle_fraction as _idle_fraction
from repro_torch.storage import store as _store
from repro_torch.storage.devcache import (DeviceEdgeBlockCache,
                                          DeviceFeatureCache, _to_device,
                                          pad_pow2)


@dataclasses.dataclass
class Minibatch:
    """One training minibatch.

    targets:   (M,) int32 numpy -- the batch's seed nodes.
    hop_ids:   hop_ids[t] has shape (M, f1, ..., ft) -- sampled node ids.
    hop_feats: hop_feats[t] has shape (M, f1, ..., ft, F) -- their features.
    labels:    (M,) int32.
    trace:     the batch's storage-access record (out-of-core path only).
    launches:  kernel launches the batch's preparation made, by kernel
               (counted per thread, so exact on the overlapped lanes).
    """

    targets: np.ndarray
    hop_ids: list
    hop_feats: list
    labels: torch.Tensor
    trace: SampleTrace | None = None
    launches: dict | None = None


LOADERS: dict[str, type] = {}


def register_loader(name: str):
    def deco(cls):
        cls.backend = name
        LOADERS[name] = cls
        return cls
    return deco


def make_loader(name: str, g: CSRGraph | None, *, batch_size: int = 64,
                fanouts: Sequence[int] = DEFAULT_FANOUTS, mesh=None,
                seed: int = 0, storage_engine=None, prefetch: int = 0,
                store=None, device_cache=None, device="cuda"):
    """The reference's keyword shim over the spec API: assembles the
    ``PipelineSpec`` its arguments describe and returns the bare loader
    (``core.config.build_pipeline`` is the entry point).
    ``device_cache`` (a ``storage.specs.DeviceCacheSpec`` or anything
    with its fields, ``edge_blocks`` optional) becomes a device
    ``CacheTierSpec``; ``store`` stays a live object and the spec
    records only its kind."""
    if name not in LOADERS:
        raise KeyError(f"unknown backend {name!r}; have {sorted(LOADERS)}")
    tiers = []
    if device_cache is not None and (
            getattr(device_cache, "rows", 0)
            or getattr(device_cache, "edge_blocks", 0)):
        tiers.append(CacheTierSpec.device(
            rows=getattr(device_cache, "rows", 0),
            edge_blocks=getattr(device_cache, "edge_blocks", 0),
            policy=device_cache.policy,
            pinned_fraction=device_cache.pinned_fraction,
            oracle_window=getattr(device_cache, "oracle_window", 0)))
    spec = PipelineSpec(
        backend=BackendSpec(name=name),
        sampler=SamplerSpec(fanouts=tuple(fanouts)),
        store=StoreSpec(kind=getattr(store, "kind", "mem")),
        cache_tiers=tuple(tiers), prefetch=PrefetchSpec(depth=prefetch),
        batch_size=batch_size, seed=seed)
    return _build_loader(spec, g=g, store=store, mesh=mesh,
                         storage_engine=storage_engine, device=device)


def _build_loader(spec: PipelineSpec, *, g: CSRGraph | None, store=None,
                  mesh=None, storage_engine=None, device="cuda"):
    """Construct the loader a validated spec describes, on ``device``.

    ``store`` selects where graph data is read from; ``mesh`` places the
    ``isp`` backend's shards; ``storage_engine`` is the simulated tier
    whose modeled latency each batch pays.  Without ``g`` the
    graph is materialized from it, with a loud warning (that loads the
    whole store into DRAM), leaving the feature table on disk when a
    device feature-cache tier fetches rows on demand anyway."""
    name = spec.backend.name
    if name not in LOADERS:
        raise KeyError(f"unknown backend {name!r}; have {sorted(LOADERS)}")
    feature_cache = spec.feature_cache()
    edge_cache = spec.topology_cache()
    if g is None and store is not None and name != "host":
        skip_features = feature_cache is not None
        nbytes = getattr(store, "nbytes_on_disk", lambda: 0)()
        warnings.warn(
            f"materializing the full graph from the {store.kind!r} store "
            f"into DRAM for the {name!r} backend"
            + (f" (~{nbytes / 2**20:.0f} MB on disk"
               + (", feature table left on disk for the device cache)"
                  if skip_features else ")") if nbytes else "")
            + "; pass the CSRGraph directly to avoid the copy",
            stacklevel=3)
        if getattr(store, "kind", None) == "disk":
            g = store.to_csr(include_features=not skip_features)
        else:
            g = store.to_csr()
    if name == "host":
        kw = dict(sampler=spec.sampler.family,
                  walk_length=spec.sampler.walk_length,
                  n_workers=spec.backend.n_workers,
                  queue_depth=spec.backend.queue_depth,
                  straggler_factor=spec.backend.straggler_factor)
    elif name == "isp":
        kw = dict(mesh=mesh, axis=spec.backend.axis)
    else:
        kw = dict(device_cache=feature_cache, edge_cache=edge_cache)
    loader = LOADERS[name](g, batch_size=spec.batch_size,
                           fanouts=spec.sampler.fanouts, seed=spec.seed,
                           device=device, store=store,
                           storage_engine=storage_engine, **kw)
    if any(t.policy == "optimal" for t in spec.cache_tiers):
        from repro_torch.storage.oracle import (attach_host_oracle,
                                                attach_pallas_oracle)
        if name == "pallas":
            attach_pallas_oracle(loader, spec)
        elif name == "host":
            attach_host_oracle(loader, spec)
    if spec.prefetch.depth:
        from repro_torch.core.pipeline import (OverlappedLoader,
                                               PrefetchingLoader)
        if spec.prefetch.overlap:
            loader = OverlappedLoader(
                loader, depth=spec.prefetch.depth,
                stage_depth=spec.prefetch.stage_depth,
                plan_ahead=_effective_plan_ahead(
                    spec.prefetch.plan_ahead, store, spec.batch_size),
                lane_timeout=spec.prefetch.lane_timeout_s,
                max_lane_restarts=spec.prefetch.max_lane_restarts,
                stall_inject=(spec.store.faults.lane_stall
                              if spec.store.faults is not None else None))
        else:
            loader = PrefetchingLoader(loader, depth=spec.prefetch.depth)
    return loader


def _effective_plan_ahead(plan_ahead: int, store, batch_size: int) -> int:
    """Frontier-planner guard: warming ``plan_ahead`` future batches only
    helps while the page cache can hold the planned window's working set
    alongside the current batch.  When it cannot, the warmed blocks evict
    each other (and the live batch's blocks) before they are consumed, so
    the planner is disabled with a one-time warning."""
    if not plan_ahead or store is None or not hasattr(store, "cache_blocks"):
        return plan_ahead
    try:
        bb = store.block_bytes
        row = store._dtype["features"].itemsize * store.feat_dim
        esz = store._dtype["indices"].itemsize
        avg_deg = store.num_edges / max(1, store.num_nodes)
        per_target = (max(1, -(-row // bb))            # feature row blocks
                      + max(1, int(avg_deg * esz // bb) + 1))  # edge list
        working_set = (plan_ahead + 1) * batch_size * per_target
    except (AttributeError, KeyError, TypeError):
        return plan_ahead
    if store.cache_blocks >= working_set:
        return plan_ahead
    warnings.warn(
        f"plan_ahead={plan_ahead} disabled: the page cache holds "
        f"{store.cache_blocks} blocks but the planned window's working "
        f"set is ~{working_set} blocks ({plan_ahead + 1} batches x "
        f"{batch_size} targets); warming would thrash the cache it is "
        "trying to fill — grow cache_mb or lower plan_ahead to re-enable",
        stacklevel=3)
    return 0


def _launches_since(before: dict, into: dict | None = None) -> dict:
    """The calling thread's kernel launches since ``before`` (a
    ``kernels.thread_launches()`` snapshot), added to ``into``."""
    out = dict(into or {})
    for k, v in kernels.thread_launches().items():
        if v != before[k]:
            out[k] = out.get(k, 0) + v - before[k]
    return out


def batch_targets(g, idx: int, batch_size: int, seed: int = 0) -> np.ndarray:
    """The shared per-batch target stream (a pure function of the index).
    ``g`` is anything with ``num_nodes``, a CSRGraph or a GraphStore."""
    rng_ = np.random.default_rng(seed + idx)
    return rng_.integers(0, g.num_nodes, batch_size).astype(np.int32)


class _LoaderBase:
    """What every backend's loader shares: the target stream, the oracle
    hook, the simulated-storage accounting, the counters and
    ``stats()``."""

    backend = "base"
    SAMPLERS = ("khop",)

    def __init__(self, g: CSRGraph | None, *, batch_size: int, fanouts,
                 seed: int = 0, device="cuda", store=None,
                 storage_engine=None, sampler: str = "khop",
                 walk_length: int = 4):
        self.g = g
        self.store = store if store is not None else g
        if self.store is None:
            raise ValueError("loader needs a graph or a GraphStore")
        if sampler not in self.SAMPLERS:
            raise ValueError(
                f"backend {self.backend!r} supports samplers "
                f"{self.SAMPLERS}, not {sampler!r} (GraphSAINT walks are "
                "host-side numpy sampling)")
        self.sampler = sampler
        self.walk_length = int(walk_length)
        self.batch_size = batch_size
        # a SAINT batch's one hop tensor is the (M, L+1) walk
        self.fanouts = ((self.walk_length + 1,) if sampler == "saint"
                        else tuple(fanouts))
        self.seed = seed
        self.device = torch.device(device)
        self.storage_engine = storage_engine
        self.simulated_storage_s = 0.0
        self._storage_lock = threading.Lock()
        self.devcache = None
        self.edgecache = None
        self._epoch0 = None
        self._oracle = None        # OracleReplayer (optimal-policy tiers)

    def targets(self, idx: int) -> np.ndarray:
        return batch_targets(self.store, idx, self.batch_size, self.seed)

    def _advance_oracle(self, idx: int) -> None:
        """Head-of-batch hook of the optimal (Belady) tiers: wait until
        the replay lane has batch ``idx``'s window scheduled, then roll
        the edge cache's and the store's two-phase next-use state
        forward.  No-ops under lru and pinned."""
        rep = self._oracle
        if rep is not None:
            rep.advance(idx)
        ec = self.edgecache
        if ec is not None:
            ec.oracle_begin_batch(idx)
        adv = getattr(self.store, "oracle_advance", None)
        if adv is not None:
            adv(idx)

    def storage_delay(self, trace: SampleTrace) -> float:
        """Replay ``trace`` against the attached engine's cost model and
        return the simulated data-preparation latency (0 without an
        engine).  Producer threads call it, so the sum is locked; a
        straggler's reissued batch pays its cost twice, like the
        duplicated work it models."""
        if self.storage_engine is None or trace is None:
            return 0.0
        eng = self.storage_engine
        delay = eng.batch_cost(trace).time_s + eng.feature_time(trace)
        with self._storage_lock:
            self.simulated_storage_s += delay
        return delay

    def storage_cost_trace(self, idx: int) -> SampleTrace:
        """The cost model's access trace for the device backends, which
        keep no host trace: a numpy re-sample of batch ``idx`` with the
        same event counts (the host sampler's stream)."""
        g = self.g if self.g is not None else self.store
        if self.sampler == "saint":
            return saint_random_walk(g, self.targets(idx), self.walk_length,
                                     seed=self.seed + idx)
        return sample_khop(g, self.targets(idx), self.fanouts,
                           seed=self.seed + idx)

    def impose_storage_cost(self, idx: int) -> None:
        """Replay batch ``idx``'s trace against the attached engine and
        sleep the modeled latency, less the re-sample's own time, so the
        visible delay is the model's.  It runs inside ``get_batch``: under
        a prefetching loader the re-sample and the sleep happen on the
        prefetch worker, off the consumer's path."""
        if self.storage_engine is None:
            return
        t0 = time.perf_counter()
        delay = self.storage_delay(self.storage_cost_trace(idx))
        time.sleep(max(0.0, delay - (time.perf_counter() - t0)))

    def _counter_sources(self) -> dict:
        src = {}
        io = getattr(self.store, "io_counters", None)
        if io is not None:
            src["store"] = io
        if self.devcache is not None:
            src["devcache"] = self.devcache.counters
        if self.edgecache is not None:
            src["edgecache"] = self.edgecache.counters
        return src

    def start_epoch(self) -> None:
        """Mark an epoch boundary: from here on ``stats()`` also reports
        the counters since this call (``store_epoch``, ``devcache_epoch``,
        ``edgecache_epoch``) beside the cumulative totals."""
        self._epoch0 = {k: fn() for k, fn in self._counter_sources().items()}

    def stats(self) -> dict:
        s = {"backend": self.backend, "sampler": self.sampler,
             "simulated_storage_s": self.simulated_storage_s}
        store_stats = getattr(self.store, "stats", None)
        if store_stats is not None:
            s["store"] = store_stats()
        if self.devcache is not None:
            s["devcache"] = self.devcache.stats()
        if self.edgecache is not None:
            s["edgecache"] = self.edgecache.stats()
        if self._oracle is not None:
            s["oracle"] = self._oracle.stats()
        if self._epoch0 is not None:
            for name, fn in self._counter_sources().items():
                base = self._epoch0.get(name, {})
                s[f"{name}_epoch"] = {
                    k: v - base.get(k, 0) for k, v in fn().items()
                    if isinstance(v, (int, float))}
        return s

    def close(self) -> None:
        if self._oracle is not None:
            self._oracle.close()


@register_loader("host")
class HostSubgraphLoader(_LoaderBase):
    """CPU data preparation (the paper's Fig. 4): ``sample_khop`` (or
    GraphSAINT walks, ``sampler='saint'``) and the feature and label
    gathers run in the producer threads of a
    ``core.pipeline.ProducerConsumerPipeline``, through ``self.store``
    (in-memory arrays, or a ``DiskStore``'s paged reads), and batches are
    consumed strictly in index order.  The producers touch only numpy and
    the store.  ``get_batch`` copies the batch's features and labels to
    the loader's device on the caller's thread, through pinned host
    buffers with ``non_blocking`` on the current stream; the hop ids stay
    on the host."""

    SAMPLERS = ("khop", "saint")

    def __init__(self, g, *, batch_size, fanouts, seed=0, device="cuda",
                 store=None, storage_engine=None, sampler="khop",
                 walk_length=4, n_workers: int = 4, queue_depth: int = 8,
                 straggler_factor: float = 4.0):
        super().__init__(g, batch_size=batch_size, fanouts=fanouts,
                         seed=seed, device=device, store=store,
                         storage_engine=storage_engine, sampler=sampler,
                         walk_length=walk_length)
        from repro_torch.core.pipeline import (ProducerConsumerPipeline,
                                               make_host_producer)
        produce = make_host_producer(self.store, batch_size, self.fanouts,
                                     seed=seed, sampler=self.sampler,
                                     walk_length=self.walk_length,
                                     storage_cost_fn=self.storage_delay)
        self.pipeline = ProducerConsumerPipeline(
            produce, n_workers=n_workers, queue_depth=queue_depth,
            straggler_factor=straggler_factor)

    def get_batch(self, idx: int) -> Minibatch:
        mb = self.pipeline.get_batch(idx)
        dev = self.device
        return Minibatch(
            targets=mb.targets,
            # (a pushed-down batch's ids are read-only views of the
            # reply's payload)
            hop_ids=[torch.from_numpy(np.require(h, requirements="W"))
                     for h in mb.hop_ids],
            hop_feats=[_to_device(np.asarray(f, np.float32), dev)
                       for f in mb.hop_feats],
            labels=_to_device(np.asarray(mb.labels, np.int32), dev),
            trace=mb.trace, launches={})

    def stats(self) -> dict:
        s = self.pipeline.stats
        produce = s.produce_times
        return dict(super().stats(),
                    mean_produce_s=float(np.mean(produce)) if produce else 0.0,
                    reissued=s.reissued,
                    duplicates_dropped=s.duplicates_dropped)

    def close(self) -> None:
        self.pipeline.close()
        super().close()


@register_loader("pallas")
class PallasSubgraphLoader(_LoaderBase):
    """Kernel data preparation on one device.

    Without a device tier, the graph's CSR arrays, features and labels
    are uploaded once, and each batch runs the ``neighbor_sample`` kernel
    once per hop and the ``feature_gather_rows`` kernel once per hop
    tensor.  The device cache tiers (``CacheTierSpec``, as the reference's
    ``_build_loader`` passes them) keep the arrays they name behind
    device caches over ``store``:

    * ``edge_cache`` (``edge_blocks``): sampling runs one
      ``neighbor_sample_cached`` launch per planned chunk of each hop's
      frontier, after the chunk's edge blocks are admitted;
    * ``device_cache`` (``rows``): the batch's unique ids are resolved
      against the feature cache (misses fetched through the store),
      gathered by one ``feature_gather_cached`` launch per segment, and
      the hop tensors are gathered from those rows by
      ``feature_gather_rows``.

    ``indptr`` and the labels stay on the device.  ``dispatches`` counts
    the cached launches the plans call for (``edge_chunks``,
    ``feature_segments``); ``stats()['stage_s']`` the host seconds of each
    stage when they run back to back here."""

    def __init__(self, g: CSRGraph, *, batch_size: int,
                 fanouts: Sequence[int], seed: int = 0, device="cuda",
                 store=None, storage_engine=None,
                 device_cache: CacheTierSpec | None = None,
                 edge_cache: CacheTierSpec | None = None):
        super().__init__(g, batch_size=batch_size, fanouts=fanouts,
                         seed=seed, device=device, store=store,
                         storage_engine=storage_engine)
        # the reference casts the int64 offsets to int32 as well
        self.indptr = torch.as_tensor(np.asarray(g.indptr, np.int32),
                                      device=self.device)
        self.labels = torch.as_tensor(np.asarray(g.labels, np.int32),
                                      device=self.device)
        self.max_degree = int(g.degrees().max()) if g.num_edges else 1
        self._key = rng.key(seed)
        self.dispatches = {"edge_chunks": 0, "feature_segments": 0}
        self._devcache_bypass = False   # permanent once tripped
        self._bypass_events = 0
        # orders a bypass's cache reset against the admit stage's use of
        # the cache (they run on different lanes when overlapped)
        self._admit_lock = threading.Lock()
        if edge_cache is not None and getattr(edge_cache, "edge_blocks", 0):
            self.indices = None         # topology stays off the device
            self.edgecache = DeviceEdgeBlockCache(
                self.store, indptr=np.asarray(g.indptr, np.int64),
                block_e=ops.edge_block_size(self.max_degree),
                blocks=edge_cache.edge_blocks, policy=edge_cache.policy,
                pinned_fraction=edge_cache.pinned_fraction,
                device=self.device)
        else:
            self.indices = torch.as_tensor(np.asarray(g.indices, np.int32),
                                           device=self.device)
        if device_cache is not None and getattr(device_cache, "rows", 0):
            self.features = None        # no full-table upload
            self.devcache = DeviceFeatureCache(
                self.store, rows=device_cache.rows,
                policy=device_cache.policy,
                pinned_fraction=device_cache.pinned_fraction,
                device=self.device)
        else:
            self.features = torch.as_tensor(
                np.asarray(g.features, np.float32), device=self.device)
        stages = self.pipeline_stages() or ()
        self._stage_s = {name: 0.0 for name, _ in stages}
        self._stage_n = {name: 0 for name, _ in stages}

    def get_batch(self, idx: int) -> Minibatch:
        if self.devcache is None and self.edgecache is None:
            self._advance_oracle(idx)
            l0 = kernels.thread_launches()
            targets = self.targets(idx)
            self.impose_storage_cost(idx)
            t = _to_device(targets, self.device)
            hops = ops.sample_khop_kernel(self.indptr, self.indices, t,
                                          self.fanouts,
                                          key=rng.fold_in(self._key, idx),
                                          max_degree=self.max_degree)
            hop_feats = [ops.feature_gather_rows(self.features, h)
                         for h in hops]
            return Minibatch(targets=targets, hop_ids=hops,
                             hop_feats=hop_feats,
                             labels=self.labels[t.long()],
                             launches=_launches_since(l0))
        # the same three stages the OverlappedLoader runs on its lanes,
        # back to back
        payload = idx
        for name, fn in self.pipeline_stages():
            t0 = time.perf_counter()
            payload = fn(payload)
            self._stage_s[name] += time.perf_counter() - t0
            self._stage_n[name] += 1
        return payload

    # -- the staged cached data plane ----------------------------------------
    # Stage 0 maps a batch index to a payload, later stages map it
    # forward; each stage is called in batch order.  Mirror bookkeeping
    # happens only in plan_rows (resolve) and device mutations replay in
    # plan order (admit), as in the reference.

    def pipeline_stages(self):
        """The cached path's decomposition: sample the k hops (edge-block
        cache traffic included), resolve feature-cache misses (storage
        reads), admit and gather on the device.  ``None`` for the
        full-upload configuration."""
        if self.devcache is None and self.edgecache is None:
            return None
        return [("sample", self._stage_sample),
                ("resolve", self._stage_resolve),
                ("admit", self._stage_admit)]

    def _attr(self, ctx):
        """Attribution scope for batch-owned store reads."""
        if ctx is None:
            return contextlib.nullcontext()
        return self.store.io_attribution(ctx)

    def _stage_sample(self, idx: int) -> dict:
        """Sample the k hops, through the edge-block cache when there is
        one, else over the device-resident edge array.  The edge cache's
        counter delta here is the batch's exact edge traffic.  Under an
        optimal tier the batch's schedule is entered first."""
        self._advance_oracle(idx)
        l0 = kernels.thread_launches()
        targets = self.targets(idx)
        self.impose_storage_cost(idx)
        key = rng.fold_in(self._key, idx)
        make_ctx = getattr(self.store, "make_io_context", None)
        ctx = make_ctx() if make_ctx is not None else None
        if ctx is not None:
            # spans of pool preads issued on this batch's behalf inherit
            # the attribution ctx, and with it the batch index
            ctx.batch = idx
        io0 = _io_snapshot(self.store) if ctx is None else None
        edge0 = (self.edgecache.counters()
                 if self.edgecache is not None else None)
        t = _to_device(targets, self.device)
        with self._attr(ctx):
            if self.edgecache is not None:
                hops, hop_ids = self._sample_khop_edgecached(targets, key)
            else:
                hops = ops.sample_khop_kernel(self.indptr, self.indices, t,
                                              self.fanouts, key=key,
                                              max_degree=self.max_degree)
                hop_ids = None
        edge_io = None
        if edge0 is not None:
            e1 = self.edgecache.counters()
            edge_io = {k: e1[k] - edge0[k] for k in e1}
        return dict(idx=idx, targets=targets, hops=hops, hop_ids=hop_ids,
                    labels=self.labels[t.long()], ctx=ctx, io0=io0,
                    edge_io=edge_io, launches=_launches_since(l0))

    def reset_staged_state(self) -> None:
        """Discard cache-mirror state staged by abandoned plans (a
        bypassed feature cache is left alone).  On a GPU the device is
        synchronized first: an abandoned lane's installs and gathers must
        be done before the slot tables are cleared."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.devcache is not None and not self._devcache_bypass:
            self.devcache.reset()
        if self.edgecache is not None:
            self.edgecache.reset()

    def _note_devcache_failure(self, exc: BaseException) -> None:
        """Degrade policy: a feature-cache fetch that failed past the
        store's retry policy means the cached path cannot make progress,
        so it is bypassed for good (a direct ``gather_features`` per
        batch) instead of failing training.  The cache is reset after the
        device has finished the installs already queued.  The reference
        ignores any error of that reset; here it is a device fault, and
        it raises."""
        with self._admit_lock:
            self._devcache_bypass = True
            self._bypass_events += 1
            warnings.warn(
                f"device feature cache fetch failed past the retry policy "
                f"({exc}); bypassing the cache permanently — features now "
                f"fetched directly from the store each batch (slower, "
                f"bit-identical)", stacklevel=2)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.devcache.reset(preload=False)

    def _stage_resolve(self, s: dict) -> dict:
        """Plan and fetch the batch's feature-cache misses.  The unique
        ids are padded to a power of two with the last id (the pads are
        hits and count toward the segment cut, as in the reference)."""
        hop_ids = s["hop_ids"]
        if hop_ids is None:
            hop_ids = [h.cpu().numpy() for h in s["hops"]]
        uniq = np.unique(np.concatenate([h.reshape(-1) for h in hop_ids]))
        s["hop_ids"], s["uniq"] = hop_ids, uniq
        if self.devcache is not None and not self._devcache_bypass:
            try:
                self.devcache.oracle_begin_batch(s["idx"])
                with self._attr(s["ctx"]):
                    with obs.trace_span("devcache.plan", batch=s["idx"]):
                        plan = self.devcache.plan_rows(
                            pad_pow2(uniq, uniq[-1]), n_valid=uniq.size)
                    with obs.trace_span("devcache.fetch", batch=s["idx"]):
                        self.devcache.fetch_plan(plan)
                s["plan"] = plan
            except _store.StoreReadError as e:
                self._note_devcache_failure(e)
                s["plan"] = None
        return s

    def _stage_admit(self, s: dict) -> Minibatch:
        """Install the fetched rows, gather them on the device, gather
        the hop tensors from them (one ``feature_gather_rows`` launch per
        hop), and assemble the Minibatch with the batch's I/O bill.  With
        the feature cache bypassed, the batch's unique rows come straight
        from the store in one upload instead: the same rows in the same
        order, so only the transfers and counters differ.  (Overlapped,
        a plan made before the bypass tripped is not installed.)"""
        l0 = kernels.thread_launches()
        hop_ids, uniq = s["hop_ids"], s["uniq"]
        plan = s.get("plan")
        if self.devcache is not None:
            with self._admit_lock:
                if self._devcache_bypass:
                    plan = None
                else:
                    with obs.trace_span("devcache.install", batch=s["idx"]):
                        rows = self.devcache.execute_plan(plan)
                    self.dispatches["feature_segments"] += len(
                        plan.segments)
            if plan is None:
                with self._attr(s["ctx"]):
                    rows = _to_device(np.ascontiguousarray(
                        self.store.gather_features(uniq), np.float32),
                        self.device)
            F = self.devcache.feat_dim
            hop_feats = []
            for h in hop_ids:
                pos = np.searchsorted(uniq, h.reshape(-1)).astype(np.int32)
                hop_feats.append(ops.feature_gather_rows(
                    rows, _to_device(pos, self.device)).reshape(
                        tuple(h.shape) + (F,)))
        else:
            hop_feats = [ops.feature_gather_rows(self.features, h)
                         for h in s["hops"]]
        if s["ctx"] is not None:
            io = s["ctx"].counters()
        else:
            io = _io_delta(self.store, s["io0"]) or {}
        io = _store.nest_fault_counters(io)
        if self.devcache is not None:
            if plan is not None:
                io["devcache"] = dict(plan.counters)
            else:
                io["devcache_bypass"] = True
        if s["edge_io"] is not None:
            io["edgecache"] = s["edge_io"]
        trace = SampleTrace(touched_nodes=np.empty(0, np.int64),
                            hops=hop_ids, subgraph_nodes=uniq, io=io)
        return Minibatch(targets=s["targets"], hop_ids=list(s["hops"]),
                         hop_feats=hop_feats, labels=s["labels"],
                         trace=trace,
                         launches=_launches_since(l0, s["launches"]))

    def _sample_khop_edgecached(self, targets, key):
        """K-hop sampling through the edge-block cache.  The rand bits are
        ``ops.sample_khop_kernel``'s, drawn on the device; each hop's
        frontier comes to the host, where its chunks are planned and
        their blocks admitted before each launch.  Returns the hops on the
        device and on the host."""
        frontier = np.asarray(targets, np.int32)
        hops = [_to_device(frontier, self.device)]
        host = [frontier]
        for i, f in enumerate(self.fanouts):
            rand = rng.randint(rng.fold_in(key, i), frontier.shape + (f,),
                               0, 2**31 - 1, device=self.device)
            flat = frontier.reshape(-1)
            nxt, nxt_dev = self._sample_chunk_cached(
                flat, rand.reshape(flat.shape[0], f))
            frontier = nxt.reshape(frontier.shape + (f,))
            hops.append(nxt_dev.reshape(frontier.shape))
            host.append(frontier)
        return hops, host

    def _sample_chunk_cached(self, flat: np.ndarray, rand2d: torch.Tensor
                             ) -> tuple[np.ndarray, torch.Tensor]:
        """One hop through the edge-block cache: plan chunks whose block
        set fits the cache, admit each chunk's blocks, launch the cached
        kernel per chunk at the chunk's own length (the reference pads it
        to a power of two for jit's static shapes; the pads change no id
        and no counter, since the plan is made before the launch)."""
        ec = self.edgecache
        parts = []
        for sl, blocks in ec.plan(flat):
            ec.resolve(blocks)
            parts.append(ops.neighbor_sample_cached(
                self.indptr, ec.table, ec.slot_of,
                _to_device(flat[sl], self.device), rand2d[sl],
                block_e=ec.block_e, max_block=ec.max_block))
            self.dispatches["edge_chunks"] += 1
        dev = parts[0] if len(parts) == 1 else torch.cat(parts)
        return dev.cpu().numpy(), dev

    def warm_batch(self, idx: int) -> int:
        """Frontier planner hook: pre-pull batch ``idx``'s probable byte
        ranges (its targets' neighbour lists and feature rows) through
        the store's page cache on the pread pool.  Advisory: warms only
        the host page cache, never device or cache-mirror state."""
        warm = getattr(self.store, "warm_nodes", None)
        if warm is None:
            return 0
        return warm(self.targets(idx), features=self.devcache is not None,
                    edges=self.edgecache is not None)

    def stats(self) -> dict:
        s = dict(super().stats(), dispatches=dict(self.dispatches),
                 devcache_bypass=self._devcache_bypass,
                 devcache_bypass_events=self._bypass_events)
        if self._stage_s:
            s["stage_s"] = dict(self._stage_s)
            s["stage_mean_s"] = {k: v / max(self._stage_n[k], 1)
                                 for k, v in self._stage_s.items()}
        return s


@register_loader("isp")
class ISPSubgraphLoader(_LoaderBase):
    """Near-data (ISP) data preparation on a mesh: the graph is
    partitioned over the mesh's ``axis`` (``core.partition``), each shard
    lives on its device (``core.isp.ISPGraph``), and a batch is sampled
    and gathered where its nodes live, the shards' results summed into
    the minibatch on the first shard's device.  Without a mesh the graph
    is one shard on the loader's device (``launch.mesh.make_host_mesh``).
    Plain torch ops, no kernel launch; hop ids and labels int32, as the
    ``pallas`` loader's, and equal to its at equal seeds."""

    def __init__(self, g: CSRGraph, *, batch_size: int,
                 fanouts: Sequence[int], seed: int = 0, device="cuda",
                 store=None, storage_engine=None, mesh=None,
                 axis: str = "data"):
        super().__init__(g, batch_size=batch_size, fanouts=fanouts,
                         seed=seed, device=device, store=store,
                         storage_engine=storage_engine)
        from repro_torch.core.isp import ISPGraph
        from repro_torch.core.partition import partition_graph
        if mesh is None:
            from repro_torch.launch.mesh import make_host_mesh
            mesh = make_host_mesh(self.device)
        self.mesh = mesh
        self.engine = ISPGraph(partition_graph(g, mesh.shape[axis]), mesh,
                               axis=axis)
        self._key = rng.key(seed)

    def get_batch(self, idx: int) -> Minibatch:
        l0 = kernels.thread_launches()
        targets = self.targets(idx)
        self.impose_storage_cost(idx)
        eng = self.engine
        hops = eng.sample_khop(_to_device(targets, eng.device), self.fanouts,
                               key=rng.fold_in(self._key, idx))
        return Minibatch(targets=targets, hop_ids=hops,
                         hop_feats=[eng.gather_features(h) for h in hops],
                         labels=eng.gather_labels(hops[0]),
                         launches=_launches_since(l0))


def build_train_step(loader, gnn, optimizer):
    """GraphSAGE update over a ``Minibatch``: loss, gradients and the
    optimizer step.  The parameters live in ``gnn`` and are updated in
    place; ``state`` carries the optimizer state and the step count.
    Returns ``train_step(state, mb) -> (state, metrics)``."""
    if loader is not None and tuple(loader.fanouts) != tuple(gnn.cfg.fanouts):
        raise ValueError(f"loader fanouts {loader.fanouts} != "
                         f"gnn fanouts {gnn.cfg.fanouts}")
    params = dict(gnn.named_parameters())

    def train_step(state: dict, mb: Minibatch):
        hop_feats = [f.float() for f in mb.hop_feats]
        loss, metrics = gnn_loss_fn(gnn, hop_feats, mb.labels)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt_metrics = optimizer.update(dict(zip(params, grads)), state["opt"],
                                       params, state["step"])
        return ({"opt": state["opt"], "step": state["step"] + 1},
                dict(metrics, **opt_metrics))

    return train_step


@dataclasses.dataclass
class RunStats:
    """Loop telemetry: the paper's Fig. 7 metrics."""

    steps: int = 0
    idle_s: float = 0.0          # consumer waiting on data preparation
    busy_s: float = 0.0          # consumer in the train step
    wall_s: float = 0.0

    @property
    def idle_fraction(self) -> float:
        return _idle_fraction(self.idle_s, self.busy_s)

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.wall_s if self.wall_s > 0 else 0.0


def _block_until_ready(metrics: dict) -> None:
    """Wait for the stream that computed ``metrics``, if on a GPU (not the
    whole device: the overlapped pipeline's lanes keep their own streams
    busy meanwhile)."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.current_stream(v.device).synchronize()
            return


def train_loop(loader, train_step, state, *, steps: int, start: int = 0,
               on_step=None) -> tuple[object, RunStats]:
    """Drive ``train_step`` over ``loader`` batches; record the idle/busy
    split.  ``on_step(i, state, metrics)`` is called after every step."""
    stats = RunStats()
    t_start = time.perf_counter()
    for i in range(start, steps):
        t0 = time.perf_counter()
        with obs.trace_span("consume.wait", batch=i, lane="consumer"):
            mb = loader.get_batch(i)
        t1 = time.perf_counter()
        with obs.trace_span("consume.step", batch=i, lane="consumer"):
            state, metrics = train_step(state, mb)
            # kernels run asynchronously: without the wait, device time
            # would fall into the next step's idle window
            _block_until_ready(metrics)
        t2 = time.perf_counter()
        stats.idle_s += t1 - t0
        stats.busy_s += t2 - t1
        stats.steps += 1
        obs.tick()                   # periodic JSONL metrics snapshot
        if on_step is not None:
            on_step(i, state, metrics)
    stats.wall_s = time.perf_counter() - t_start
    return state, stats
