"""Event-driven storage engines: the paper's six design points.

The port's copy of the reference's ``storage/engines.py`` (numpy only).
Each engine replays a real sampler access trace (``core.sampler``) against
its device model and returns a ``BatchCost``: single-worker latency,
link bytes, command count, and per-batch demand on *shared* resources
(flash, embedded cores, PCIe, device IOPS).  Multi-worker throughput is
then ``min(W / t_single, capacity_r / demand_r for every shared r)``: the
same resource model for every engine, so the paper's Fig. 14/16/17
contention effects emerge from counts, not hand-tuned curves.

The device constants are the paper's machine (``storage.specs``: its
SSD, Optane PMEM, embedded ISP cores and host), not measurements of the
machine the port runs on.

Engines:
  dram        -- oracular in-memory baseline (infinite DRAM)
  pmem        -- Optane DC PMEM on the memory bus
  mmap        -- baseline SSD via mmap + OS page cache (Fig. 3b)
  directio    -- SmartSAGE(SW): direct I/O + pinned user scratchpad (§IV-C)
  isp         -- SmartSAGE(HW/SW): firmware ISP + NS_config coalescing (§IV-B)
  isp_oracle  -- SmartSAGE(oracle): dedicated ISP cores (Newport-class)
  fpga        -- FPGA-based CSD: two-step P2P per chunk (Fig. 9/19)

``make_engine(..., measured=True)`` additionally reports the real I/O
counters a live ``storage.store.DiskStore`` issued per batch
(``SampleTrace.io``) beside the simulated cost (``MeasuredEngine``).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.core.graph import CSRGraph
from repro_torch.core.sampler import SampleTrace
from repro_torch.storage.blockdev import (EDGE_ENTRY_BYTES, LRUCache,
                                          PinnedCache, block_trace)
from repro_torch.storage.specs import DEFAULT, SystemSpec


@dataclasses.dataclass
class BatchCost:
    engine: str
    time_s: float                       # single-worker per-batch latency
    link_bytes: int                     # storage->host bytes moved
    commands: int                       # host-visible I/O commands issued
    components: dict                    # named latency components (Fig. 6/19)
    shared_demand: dict                 # resource -> demand per batch
    meta: dict = dataclasses.field(default_factory=dict)


# Shared-resource capacities (units/second) derived from a SystemSpec.
def capacities(spec: SystemSpec) -> dict:
    s = spec.ssd
    return {
        "ssd_iops": s.max_iops,                              # commands/s
        "flash_pages": s.channels * s.queue_depth / s.flash_read_latency,
        "isp_cores": spec.isp.embedded_cores * (1 - spec.isp.ftl_share),
        "isp_oracle_cores": spec.isp.oracle_cores
        * (1 - spec.isp.oracle_ftl_share),
        "pcie_bytes": s.pcie_bw,
        "p2p_bytes": spec.fpga.p2p_bw,
        "pmem_bytes": spec.pmem.bw,
        "dram_bytes": spec.host.dram_bw,
    }


def throughput(cost: BatchCost, workers: int, spec: SystemSpec = DEFAULT
               ) -> float:
    """Steady-state batches/s for ``workers`` concurrent producer workers."""
    caps = capacities(spec)
    rate = workers / max(cost.time_s, 1e-12)
    for r, demand in cost.shared_demand.items():
        if demand > 0:
            rate = min(rate, caps[r] / demand)
    return rate


def _samples(trace: SampleTrace) -> int:
    return int(sum(h.size for h in trace.hops[1:]))


def _flash_pages(g: CSRGraph, trace: SampleTrace, page_bytes: int) -> int:
    """Flash pages read for the batch's neighbor lists.  No cross-request
    dedup: at the paper's true scale (Table I: 40-440 GB edge arrays vs
    16 KB pages) two touched nodes essentially never share a page, so the
    per-request page count is the honest model even though our CPU-sized
    graphs would alias (a scale artifact we deliberately avoid)."""
    t = np.asarray(trace.touched_nodes, np.int64)
    start = g.indptr[t] * EDGE_ENTRY_BYTES
    end = np.maximum(g.indptr[t + 1] * EDGE_ENTRY_BYTES, start + 1)
    return int(np.sum(-(-(end - start) // page_bytes)))


class StorageEngine:
    name = "base"

    def __init__(self, g: CSRGraph, spec: SystemSpec = DEFAULT):
        self.g = g
        self.spec = spec

    def batch_cost(self, trace: SampleTrace) -> BatchCost:
        raise NotImplementedError

    def feature_time(self, trace: SampleTrace) -> float:
        """Feature-table lookup for the subgraph (step ② in Fig. 1).
        Default: random row reads from the DRAM-resident feature table
        (the paper offloads only the edge-list array to the SSD)."""
        h = self.spec.host
        n = trace.subgraph_nodes.size
        nbytes = n * self.g.feat_dim * 4
        return n * h.dram_latency + nbytes / h.dram_bw


class DRAMEngine(StorageEngine):
    """Oracular in-memory processing (infinite DRAM)."""
    name = "dram"

    def batch_cost(self, trace):
        h = self.spec.host
        R = trace.touched_nodes.size
        n_samples = _samples(trace)
        t_lookup = R * h.dram_latency
        t_sample = n_samples * h.sample_cpu_time
        return BatchCost(self.name, t_lookup + t_sample, 0, 0,
                         {"lookup": t_lookup, "sample": t_sample},
                         {"dram_bytes": float(R * 64)})


class PMEMEngine(StorageEngine):
    """Optane DC PMEM (NVDIMM): the *entire* dataset (edge lists AND the
    feature table) lives in PMEM (§VI-C), so both sampling lookups and
    feature rows pay PMEM latency/bandwidth."""
    name = "pmem"

    def batch_cost(self, trace):
        h, p = self.spec.host, self.spec.pmem
        R = trace.touched_nodes.size
        n_samples = _samples(trace)
        t_lookup = R * p.latency
        t_sample = n_samples * h.sample_cpu_time
        return BatchCost(self.name, t_lookup + t_sample, 0, 0,
                         {"lookup": t_lookup, "sample": t_sample},
                         {"pmem_bytes": float(R * 256)})

    def feature_time(self, trace):
        p = self.spec.pmem
        n = trace.subgraph_nodes.size
        nbytes = n * self.g.feat_dim * 4
        return n * p.latency + nbytes / p.bw


class MmapSSDEngine(StorageEngine):
    """Baseline SSD(mmap): OS page cache, page-fault per miss (Fig. 3b)."""
    name = "mmap"

    def __init__(self, g, spec=DEFAULT, *, cache_fraction=None):
        super().__init__(g, spec)
        frac = (spec.page_cache_fraction if cache_fraction is None
                else cache_fraction)
        total_blocks = -(-g.edge_list_nbytes(EDGE_ENTRY_BYTES)
                         // spec.ssd.block_bytes)
        self.cache = LRUCache(int(frac * total_blocks))

    def batch_cost(self, trace):
        s, h = self.spec.ssd, self.spec.host
        bt = block_trace(self.g, trace.touched_nodes, s.block_bytes)
        misses = 0
        for f, n in zip(bt.first_block, bt.n_blocks):
            misses += self.cache.access_run(int(f), int(n))
        hits = bt.total_blocks - misses
        n_samples = _samples(trace)
        t_hit = hits * s.page_cache_hit_time
        t_miss = misses * (s.page_fault_overhead + s.flash_read_latency)
        t_sample = n_samples * h.sample_cpu_time
        return BatchCost(
            self.name, t_hit + t_miss + t_sample,
            link_bytes=misses * s.block_bytes, commands=misses,
            components={"page_cache_hit": t_hit, "page_fault+flash": t_miss,
                        "sample": t_sample},
            shared_demand={"ssd_iops": float(misses),
                           "flash_pages": float(misses)},
            meta={"miss_rate": misses / max(bt.total_blocks, 1),
                  "blocks": bt.total_blocks})


class DirectIOEngine(StorageEngine):
    """SmartSAGE(SW): O_DIRECT into a user scratchpad pinned to hot blocks —
    latency-first (no kernel page-cache maintenance), locality second."""
    name = "directio"

    def __init__(self, g, spec=DEFAULT, *, scratch_fraction=None):
        super().__init__(g, spec)
        frac = (spec.scratchpad_fraction if scratch_fraction is None
                else scratch_fraction)
        total_blocks = -(-g.edge_list_nbytes(EDGE_ENTRY_BYTES)
                         // spec.ssd.block_bytes)
        self.cache = PinnedCache(g, int(frac * total_blocks),
                                 spec.ssd.block_bytes)

    def batch_cost(self, trace):
        s, h = self.spec.ssd, self.spec.host
        bt = block_trace(self.g, trace.touched_nodes, s.block_bytes)
        misses = 0
        for f, n in zip(bt.first_block, bt.n_blocks):
            misses += self.cache.access_run(int(f), int(n))
        hits = bt.total_blocks - misses
        n_samples = _samples(trace)
        t_hit = hits * s.scratchpad_hit_time
        t_miss = misses * (s.directio_overhead + s.flash_read_latency)
        t_sample = n_samples * h.sample_cpu_time
        return BatchCost(
            self.name, t_hit + t_miss + t_sample,
            link_bytes=misses * s.block_bytes, commands=misses,
            components={"scratchpad_hit": t_hit, "directio+flash": t_miss,
                        "sample": t_sample},
            shared_demand={"ssd_iops": float(misses),
                           "flash_pages": float(misses)},
            meta={"miss_rate": misses / max(bt.total_blocks, 1)})


class ISPEngine(StorageEngine):
    """SmartSAGE(HW/SW): firmware ISP.  One NS_config per ``coalesce``
    targets (default: whole mini-batch under a single NVMe command); flash
    page reads pipeline across channels inside the SSD; wimpy embedded
    cores gather the samples; only the dense subgraph crosses PCIe."""
    name = "isp"
    cores_resource = "isp_cores"

    def __init__(self, g, spec=DEFAULT, *, coalesce: int | None = None):
        super().__init__(g, spec)
        self.coalesce = coalesce

    def _core_params(self):
        i = self.spec.isp
        return (i.embedded_cores * (1 - i.ftl_share), i.sample_core_time)

    def batch_cost(self, trace):
        s, h, i = self.spec.ssd, self.spec.host, self.spec.isp
        M = trace.hops[0].size
        g_coal = self.coalesce or M
        n_cmds = -(-M // g_coal)
        pages = _flash_pages(self.g, trace, s.flash_page_bytes)
        pages = max(pages, trace.touched_nodes.size)
        n_samples = _samples(trace)
        ids_bytes = trace.sampled_ids_nbytes(EDGE_ENTRY_BYTES)
        nsconfig_bytes = trace.touched_nodes.size * i.nsconfig_entry_bytes

        # Command path: submit + NS_config DMA + completion DMA, per command.
        t_cmd = n_cmds * (2 * s.nvme_cmd_overhead) \
            + nsconfig_bytes / s.pcie_bw
        # Flash: channel pipelining is bounded by what one command exposes.
        pages_per_cmd = max(1.0, pages / n_cmds)
        parallel = min(float(s.cmd_parallel), pages_per_cmd)
        t_flash = pages * s.flash_read_latency / parallel
        # Embedded cores (shared with FTL).
        eff_cores, t_per_sample = self._core_params()
        t_core = n_samples * t_per_sample / eff_cores
        # Subgraph transfer back over PCIe.
        t_xfer = ids_bytes / s.pcie_bw
        total = t_cmd + t_flash + t_core + t_xfer
        return BatchCost(
            self.name, total,
            link_bytes=ids_bytes + nsconfig_bytes, commands=n_cmds,
            components={"nvme_cmd": t_cmd, "flash": t_flash,
                        "isp_core": t_core, "subgraph_xfer": t_xfer},
            shared_demand={
                "flash_pages": float(pages),
                self.cores_resource: n_samples * t_per_sample,
                "pcie_bytes": float(ids_bytes + nsconfig_bytes)},
            meta={"pages": pages, "samples": n_samples,
                  "coalesce": g_coal})


class ISPOracleEngine(ISPEngine):
    """SmartSAGE(oracle): dedicated ISP cores (NGD Newport-class A53s)."""
    name = "isp_oracle"
    cores_resource = "isp_oracle_cores"

    def _core_params(self):
        i = self.spec.isp
        return (i.oracle_cores * (1 - i.oracle_ftl_share),
                i.oracle_sample_core_time)


class FPGACSDEngine(StorageEngine):
    """FPGA-based CSD (SmartSSD): sampling runs on the FPGA over its local
    DRAM, but every missing chunk takes a two-step P2P route (SSD->FPGA
    over the in-device PCIe switch, then FPGA->CPU for the result) — the
    latency of step ① dominates and erases the ISP benefit (Fig. 9/19)."""
    name = "fpga"

    def __init__(self, g, spec=DEFAULT, *, cache_fraction=None):
        super().__init__(g, spec)
        frac = (spec.page_cache_fraction if cache_fraction is None
                else cache_fraction)
        total_blocks = -(-g.edge_list_nbytes(EDGE_ENTRY_BYTES)
                         // spec.ssd.block_bytes)
        self.cache = LRUCache(int(frac * total_blocks))  # FPGA local DRAM

    def batch_cost(self, trace):
        s, f = self.spec.ssd, self.spec.fpga
        bt = block_trace(self.g, trace.touched_nodes, s.block_bytes)
        misses = 0
        for fb, n in zip(bt.first_block, bt.n_blocks):
            misses += self.cache.access_run(int(fb), int(n))
        n_samples = _samples(trace)
        ids_bytes = trace.sampled_ids_nbytes(EDGE_ENTRY_BYTES)
        raw_bytes = misses * s.block_bytes
        # step 1: per-miss SSD->FPGA P2P (flash read + switch hop each)
        t_p2p = misses * (s.flash_read_latency + f.p2p_latency) \
            + raw_bytes / f.p2p_bw
        # step 2: FPGA gather unit (fast, hardwired)
        t_fpga = n_samples * f.fpga_sample_time
        # step 3: FPGA->CPU
        t_out = f.p2p_latency + ids_bytes / f.fpga_to_host_bw
        return BatchCost(
            self.name, t_p2p + t_fpga + t_out,
            link_bytes=raw_bytes + ids_bytes, commands=misses,
            components={"ssd_to_fpga": t_p2p, "fpga_sample": t_fpga,
                        "fpga_to_cpu": t_out},
            shared_demand={"flash_pages": float(misses),
                           "p2p_bytes": float(raw_bytes)},
            meta={"raw_bytes": raw_bytes})


class MeasuredEngine(StorageEngine):
    """``measured`` mode: pair a simulated engine with the *real* I/O the
    live ``storage.store.DiskStore`` issued for each batch.

    The wrapped engine's cost model is untouched; every ``BatchCost``
    additionally carries ``meta['measured']`` — the block requests, page
    fetches, bytes read, and live-cache hits/misses/evictions recorded in
    the trace by the store-backed sampler (``SampleTrace.io``) — and the
    wrapper accumulates run totals, so simulated time-per-event and
    measured event counts can be reported side by side.
    """

    def __init__(self, inner: StorageEngine, store=None):
        super().__init__(inner.g, inner.spec)
        self.inner = inner
        self.store = store
        self.name = f"measured:{inner.name}"
        self.totals: dict[str, int] = {}
        self.batches = 0
        self._lock = threading.Lock()   # host producers cost concurrently

    def batch_cost(self, trace: SampleTrace) -> BatchCost:
        cost = self.inner.batch_cost(trace)
        measured = getattr(trace, "io", None)
        if measured is not None:
            cost.meta["measured"] = dict(measured)
            # a trace nests the fault counters (``io['faults']``); the
            # totals keep the store's flat keys.  (The reference adds the
            # nested dict to an int and raises.)
            flat = {}
            for k, v in measured.items():
                flat.update(v if isinstance(v, dict) else {k: v})
            with self._lock:
                for k, v in flat.items():
                    self.totals[k] = self.totals.get(k, 0) + v
                self.batches += 1
        return cost

    def feature_time(self, trace: SampleTrace) -> float:
        return self.inner.feature_time(trace)

    def report(self) -> dict:
        """Accumulated measured counters (plus the store's cumulative view
        when one is attached — exact even under concurrent producers)."""
        out = {"engine": self.name, "batches": self.batches,
               "measured_totals": dict(self.totals)}
        if self.store is not None:
            out["store"] = self.store.stats()
        return out


def calibrate_directio(store_dir: str, *, samples: int = 512, seed: int = 0,
                       spec: SystemSpec = DEFAULT) -> dict:
    """Measured-vs-model pread latency calibration for the
    ``DirectIOEngine`` constants (§IV-C).

    Times ``samples`` random single-block preads against a real on-disk
    store twice — once through the ``O_DIRECT`` path (every read a real
    device read; the latency ``directio_overhead + flash_read_latency``
    stands in for) and once buffered (the kernel page cache is warm
    after the direct pass wrote nothing to it, but the store's own save
    typically left it hot — the analogue of ``scratchpad_hit_time``) —
    and reports measured distributions next to the model constants plus
    the ``SSDSpec`` overrides that would make the model reproduce the
    measured means (``dataclasses.replace(spec.ssd, **overrides)``).

    When the filesystem refuses ``O_DIRECT`` the direct pass degrades to
    buffered preads (the store warns); ``direct_io_active`` records
    which latency was actually measured so the calibration is never
    silently the wrong one.
    """
    import os
    import time

    from repro_torch.storage.store import DiskStore

    def run(direct_io: bool) -> dict:
        store = DiskStore(store_dir, cache_mb=1.0, direct_io=direct_io)
        try:
            key = "indices" if "indices" in store._arrays \
                else next(iter(store._arrays))
            nbytes = os.path.getsize(
                os.path.join(store.path, store._arrays[key]["file"]))
            nblocks = max(1, nbytes // store.block_bytes)
            rng = np.random.default_rng(seed)
            blocks = rng.integers(0, nblocks, samples)
            store._read_block_raw(key, int(blocks[0]))   # warm fd + buffer
            lat = np.empty(samples)
            for i, b in enumerate(blocks):
                t0 = time.perf_counter()
                store._read_block_raw(key, int(b))
                lat[i] = time.perf_counter() - t0
            return {"samples": int(samples),
                    "block_bytes": int(store.block_bytes),
                    "direct_io_active": bool(store.direct_io),
                    "mean_s": float(lat.mean()),
                    "p50_s": float(np.percentile(lat, 50)),
                    "p95_s": float(np.percentile(lat, 95))}
        finally:
            store.close()

    direct = run(True)
    buffered = run(False)
    s = spec.ssd
    model_direct = s.directio_overhead + s.flash_read_latency
    overrides = {
        # keep the syscall-overhead split, move the flash term onto the
        # measured end-to-end direct-read mean
        "flash_read_latency": max(direct["mean_s"] - s.directio_overhead,
                                  1e-7),
        "scratchpad_hit_time": buffered["mean_s"],
    }
    return {
        "measured": {"direct": direct, "buffered": buffered},
        "model": {"directio_read_s": model_direct,
                  "flash_read_latency": s.flash_read_latency,
                  "directio_overhead": s.directio_overhead,
                  "scratchpad_hit_time": s.scratchpad_hit_time},
        "measured_over_model": direct["mean_s"] / model_direct,
        "spec_overrides": overrides,
    }


ENGINES = {
    "dram": DRAMEngine, "pmem": PMEMEngine, "mmap": MmapSSDEngine,
    "directio": DirectIOEngine, "isp": ISPEngine,
    "isp_oracle": ISPOracleEngine, "fpga": FPGACSDEngine,
}


def make_engine(name: str, g: CSRGraph, spec: SystemSpec = DEFAULT, *,
                measured: bool = False, store=None, **kw) -> StorageEngine:
    """Build a storage engine; ``measured=True`` wraps it in
    ``MeasuredEngine`` so real I/O counters from a live ``DiskStore``
    ride along with the simulated cost model."""
    eng = ENGINES[name](g, spec, **kw)
    if measured:
        eng = MeasuredEngine(eng, store=store)
    return eng
