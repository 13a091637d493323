"""The out-of-core storage tiers of the port: the ``GraphStore`` layer
with its on-disk ``DiskStore`` and page cache (``store``, ``blockdev``,
``integrity``, ``specs``), its fault injection (``faults``), the device
caches in front of it (``devcache``) and the Belady replay lane that
schedules the ``optimal`` policies (``oracle``, imported on use).

The names below are re-exported lazily (PEP 562), so the numpy-only
modules (``store``, ``blockdev``, ``integrity``, ``specs``, ``faults``)
load without torch, as the ISP service's storage process needs.
"""

import importlib

_EXPORTS = {
    "FAR_NEXT_USE": "blockdev", "LRUCache": "blockdev",
    "OracleCache": "blockdev", "select_pinned_blocks": "blockdev",
    "AdmissionPlan": "devcache", "DeviceArrayCache": "devcache",
    "DeviceEdgeBlockCache": "devcache", "DeviceFeatureCache": "devcache",
    "StaleAdmissionPlan": "devcache", "pad_pow2": "devcache",
    "FaultInjector": "faults", "FaultSpec": "faults",
    "block_checksums": "integrity", "crc32c": "integrity",
    "DEFAULT": "specs", "DeviceCacheSpec": "specs", "RetrySpec": "specs",
    "SystemSpec": "specs",
    "DiskStore": "store", "GraphStore": "store", "IOContext": "store",
    "InMemoryStore": "store", "StoreReadError": "store",
    "nest_fault_counters": "store", "open_store": "store",
    "save_graph": "store",
}

__all__ = [
    "AdmissionPlan", "DEFAULT", "DeviceArrayCache", "DeviceCacheSpec",
    "DeviceEdgeBlockCache", "DeviceFeatureCache", "DiskStore", "FAR_NEXT_USE",
    "FaultInjector", "FaultSpec", "GraphStore", "IOContext", "InMemoryStore",
    "LRUCache", "OracleCache", "RetrySpec", "StaleAdmissionPlan",
    "StoreReadError", "SystemSpec", "block_checksums", "crc32c",
    "nest_fault_counters", "open_store", "pad_pow2", "save_graph",
    "select_pinned_blocks"]


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"repro_torch.storage.{mod}"), name)
