"""Device constants for the storage-tier simulator.

The port's copy of the reference's ``storage/specs.py`` (the port imports
nothing of ``repro``); the live ``DiskStore`` reads its defaults from
``DiskStoreSpec`` and its retry policy from ``RetrySpec``.

The simulator replays *real* access traces (block fetches, commands, bytes
— produced by the actual samplers on actual synthetic graphs) against these
device models.  Event counts are algorithmic; only time-per-event comes
from the constants below.  Values are drawn from the paper's platform
(§V: Xeon Gold 6242 + 192 GB DRAM, Cosmos+ OpenSSD over PCIe gen2 x8,
dual Cortex-A9 firmware cores; §III-B: 125 GB/s DRAM peak) and public
OpenSSD/NVMe literature.  EXPERIMENTS.md §Paper-claims reports the
sensitivity of the reproduced ratios to these constants.
"""

from __future__ import annotations

import dataclasses
import zlib


@dataclasses.dataclass(frozen=True)
class HostSpec:
    dram_bw: float = 125e9          # B/s   (paper Fig. 5: max memory thpt)
    dram_latency: float = 90e-9     # s     random-access load latency
    sample_cpu_time: float = 50e-9  # s     per sampled neighbor (host CPU)
    n_workers_max: int = 12         # paper: best at 12 workers
    gpu_flops: float = 65e12 * 0.05  # T4 fp16 peak x achieved GNN MFU
    gpu_step_overhead: float = 8e-3  # s    launch/PCIe/optimizer floor
    pcie_bw: float = 3.2e9          # B/s   PCIe gen2 x8 (OpenSSD host link)


@dataclasses.dataclass(frozen=True)
class SSDSpec:
    block_bytes: int = 4096         # logical block (the paper's 4 KB chunks)
    flash_page_bytes: int = 16384   # NAND page
    flash_read_latency: float = 70e-6   # s per page read
    channels: int = 8               # internal flash parallelism
    queue_depth: int = 10            # per-channel outstanding page reads
    cmd_parallel: int = 16          # page reads one NS_config keeps in flight
    pcie_bw: float = 3.2e9          # B/s SSD<->host
    nvme_cmd_overhead: float = 10e-6    # s per NVMe command (submit+complete)
    # mmap path: page-fault service = kernel crossing + page-cache insert
    page_fault_overhead: float = 30e-6  # s ("several tens of microseconds")
    page_cache_hit_time: float = 250e-9  # s (page-table walk + DRAM)
    # direct-I/O path: thin user-space submit, no page-cache maintenance
    directio_overhead: float = 5e-6     # s per I/O
    scratchpad_hit_time: float = 120e-9  # s (user-space buffer, no kernel)
    max_iops: float = 400e3         # device random-read IOPS ceiling


@dataclasses.dataclass(frozen=True)
class ISPSpec:
    """Firmware-based CSD (OpenSSD: dual Cortex-A9 @1 GHz, shared w/ FTL)."""
    embedded_cores: int = 2
    ftl_share: float = 0.3          # fraction of core time owned by FTL
    sample_core_time: float = 0.2e-6    # s per sampled neighbor (wimpy core)
    dram_buffer_bw: float = 4.0e9   # B/s SSD-internal DRAM page buffer
    nsconfig_entry_bytes: int = 64  # per-target metadata in NS_config
    # oracle variant (NGD Newport-class): dedicated quad A53 for ISP
    oracle_cores: int = 4
    oracle_ftl_share: float = 0.0
    oracle_sample_core_time: float = 0.4e-6


@dataclasses.dataclass(frozen=True)
class FPGASpec:
    """FPGA-based CSD (SmartSSD): two-step P2P over an internal PCIe switch."""
    p2p_bw: float = 2.5e9           # B/s SSD->FPGA (shared PCIe switch)
    p2p_latency: float = 15e-6      # s per P2P transfer setup
    fpga_sample_time: float = 50e-9  # s per sample (hardwired gather unit)
    fpga_to_host_bw: float = 2.5e9  # B/s FPGA->CPU


@dataclasses.dataclass(frozen=True)
class PMEMSpec:
    """Intel Optane DC PMEM on the memory bus (NVDIMM)."""
    latency: float = 1.0e-6         # s random load under concurrent access
    bw: float = 8e9                 # B/s sustained random read
    capacity: int = 768 << 30


@dataclasses.dataclass(frozen=True)
class DiskStoreSpec:
    """Defaults for the *live* out-of-core ``storage.store.DiskStore`` (as
    opposed to the simulated engines above): the on-disk layout is
    block-aligned at ``block_bytes`` and reads go through a page cache of
    ``cache_mb`` under the ``policy`` placement rule ('lru' = OS-page-cache
    style recency, 'pinned' = §IV-C hot-block pinning + LRU spill,
    'optimal' = Belady eviction from a replayed sampler schedule,
    ``storage.oracle``).  The
    page cache is split into ``lock_shards`` hashed-block shards so
    concurrent producer workers don't serialize on one lock (the engines'
    shared-resource contention model, Fig. 17).  ``io_threads`` sizes the
    store's pread pool: gathers split their block-disjoint byte ranges
    across that many concurrent ``pread`` calls (1 = fully synchronous
    reads, the bit-compatible default)."""
    block_bytes: int = 4096
    cache_mb: float = 16.0
    policy: str = "lru"
    lock_shards: int = 8
    io_threads: int = 1


@dataclasses.dataclass(frozen=True)
class RetrySpec:
    """I/O retry policy for every ``DiskStore`` block pread (including
    the ``io_threads`` pool path): a failed attempt — OSError, short
    read, checksum mismatch, or an attempt running past ``deadline_s`` —
    is retried up to ``max_attempts`` total tries with exponential
    backoff.  Jitter is *deterministic* (hashed from the read's
    identity, not a global RNG) so two runs of the same fault schedule
    sleep identically: timing stays reproducible along with the data."""
    max_attempts: int = 3
    backoff_s: float = 0.005        # sleep before the first retry
    backoff_mult: float = 2.0       # multiplier per further retry
    jitter: float = 0.25            # max extra backoff fraction in [0, 1]
    deadline_s: float = 30.0        # per-attempt wall-clock budget

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"retry.max_attempts must be >= 1, "
                             f"got {self.max_attempts!r}")
        if self.backoff_s < 0 or self.backoff_mult < 1.0:
            raise ValueError("retry.backoff_s must be >= 0 and "
                             "retry.backoff_mult >= 1.0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"retry.jitter must be in [0, 1], "
                             f"got {self.jitter!r}")
        if self.deadline_s <= 0:
            raise ValueError(f"retry.deadline_s must be > 0, "
                             f"got {self.deadline_s!r}")

    def backoff(self, key: str, block: int, attempt: int) -> float:
        """Sleep before retrying ``attempt`` (0-based) of one block read;
        deterministic jitter from the read's identity."""
        base = self.backoff_s * self.backoff_mult ** attempt
        frac = zlib.crc32(f"{key}:{block}:{attempt}".encode()) / 2**32
        return base * (1.0 + self.jitter * frac)


@dataclasses.dataclass(frozen=True)
class DeviceCacheSpec:
    """HBM-resident feature-row cache for the pallas backend
    (``storage.devcache.DeviceFeatureCache``): ``rows`` is the fixed
    device-side capacity in feature rows (0 = disabled, full-table
    upload); ``policy`` picks the host-managed placement — 'lru'
    recency, 'pinned' with the hottest-degree ``pinned_fraction`` of
    the capacity staged permanently (the paper's skewed-access
    characterization: hub rows dominate the gather stream), or
    'optimal' — Belady eviction from a replayed sampler schedule
    (``storage.oracle``), computed ``oracle_window`` batches ahead."""
    rows: int = 4096
    policy: str = "pinned"
    pinned_fraction: float = 0.5
    oracle_window: int = 0


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    host: HostSpec = HostSpec()
    ssd: SSDSpec = SSDSpec()
    isp: ISPSpec = ISPSpec()
    fpga: FPGASpec = FPGASpec()
    pmem: PMEMSpec = PMEMSpec()
    diskstore: DiskStoreSpec = DiskStoreSpec()
    devcache: DeviceCacheSpec = DeviceCacheSpec()
    dram_capacity: int = 192 << 30  # paper host DRAM
    # fraction of the edge-list array that fits in the OS page cache /
    # user scratchpad for LARGE-scale datasets (paper: working set >> DRAM;
    # Table I large-scale arrays are 2-10x the 192 GB host DRAM, of which
    # only part is available for caching)
    page_cache_fraction: float = 0.05
    scratchpad_fraction: float = 0.05  # same budget, informed placement


DEFAULT = SystemSpec()
