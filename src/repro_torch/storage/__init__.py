"""The storage tiers of the port: the ``GraphStore`` layer with its
on-disk ``DiskStore`` and page cache (``store``, ``blockdev``,
``integrity``, ``specs``), its fault injection (``faults``), the device
caches in front of it (``devcache``), the Belady replay lane that
schedules the ``optimal`` policies (``oracle``, imported on use), and the
simulator that replays sampler traces against device models of the
paper's six design points (``engines``, ``e2e``).

The names below are re-exported lazily (PEP 562), so the numpy-only
modules (``store``, ``blockdev``, ``integrity``, ``specs``, ``faults``,
``engines``, ``e2e``) load without torch, as the ISP service's storage
process needs.
"""

import importlib

_EXPORTS = {
    "BlockTrace": "blockdev", "EDGE_ENTRY_BYTES": "blockdev",
    "FAR_NEXT_USE": "blockdev", "LRUCache": "blockdev",
    "OracleCache": "blockdev", "PinnedCache": "blockdev",
    "block_trace": "blockdev", "select_pinned_blocks": "blockdev",
    "AdmissionPlan": "devcache", "DeviceArrayCache": "devcache",
    "DeviceEdgeBlockCache": "devcache", "DeviceFeatureCache": "devcache",
    "StaleAdmissionPlan": "devcache", "pad_pow2": "devcache",
    "E2EResult": "e2e", "capacity_report": "e2e", "e2e_train": "e2e",
    "feature_gather_time": "e2e", "gnn_step_flops": "e2e",
    "gpu_step_time": "e2e",
    "ENGINES": "engines", "BatchCost": "engines",
    "DirectIOEngine": "engines", "DRAMEngine": "engines",
    "FPGACSDEngine": "engines", "ISPEngine": "engines",
    "ISPOracleEngine": "engines", "MeasuredEngine": "engines",
    "MmapSSDEngine": "engines", "PMEMEngine": "engines",
    "StorageEngine": "engines", "calibrate_directio": "engines",
    "capacities": "engines", "make_engine": "engines",
    "throughput": "engines",
    "FaultInjector": "faults", "FaultSpec": "faults",
    "block_checksums": "integrity", "crc32c": "integrity",
    "DEFAULT": "specs", "DeviceCacheSpec": "specs", "RetrySpec": "specs",
    "SystemSpec": "specs",
    "DiskStore": "store", "GraphStore": "store", "IOContext": "store",
    "InMemoryStore": "store", "StoreReadError": "store",
    "nest_fault_counters": "store", "open_store": "store",
    "save_graph": "store",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"repro_torch.storage.{mod}"), name)
