"""The out-of-core storage tiers of the port: the ``GraphStore`` layer
with its on-disk ``DiskStore`` and page cache (``store``, ``blockdev``,
``integrity``, ``specs``), its fault injection (``faults``), the device
caches in front of it (``devcache``) and the Belady replay lane that
schedules the ``optimal`` policies (``oracle``, imported on use)."""

from repro_torch.storage.blockdev import (FAR_NEXT_USE, LRUCache,
                                          OracleCache, select_pinned_blocks)
from repro_torch.storage.devcache import (AdmissionPlan, DeviceArrayCache,
                                          DeviceEdgeBlockCache,
                                          DeviceFeatureCache,
                                          StaleAdmissionPlan, pad_pow2)
from repro_torch.storage.faults import FaultInjector, FaultSpec
from repro_torch.storage.integrity import block_checksums, crc32c
from repro_torch.storage.specs import (DEFAULT, DeviceCacheSpec, RetrySpec,
                                       SystemSpec)
from repro_torch.storage.store import (DiskStore, GraphStore, InMemoryStore,
                                       IOContext, StoreReadError,
                                       nest_fault_counters, open_store,
                                       save_graph)

__all__ = ["AdmissionPlan", "DEFAULT", "DeviceArrayCache", "FAR_NEXT_USE",
           "OracleCache",
           "DeviceCacheSpec", "DeviceEdgeBlockCache", "DeviceFeatureCache",
           "DiskStore", "FaultInjector", "FaultSpec", "GraphStore", "IOContext", "InMemoryStore",
           "LRUCache", "RetrySpec", "StaleAdmissionPlan", "StoreReadError",
           "SystemSpec", "block_checksums", "crc32c", "nest_fault_counters",
           "open_store", "pad_pow2", "save_graph", "select_pinned_blocks"]
