"""In-storage processing service — the storage-side sample+gather engine
(the port's copy of the reference's ``isp`` package: numpy and the
standard library only).

The paper's thesis (§III) is that GNN training over SSD-resident graphs
only scales when sampling and gathering execute *inside* the storage
tier, so that only sampled bytes — not raw pages — cross the host
interconnect.  This package makes that split real: an ``IspServer``
process owns the ``DiskStore`` (page cache, oracle lane, retry/fault
machinery all storage-side, emulating the SSD-controller firmware) and
answers ``SAMPLE_KHOP`` / ``GATHER_*`` / ``STATS`` commands over a
length-prefixed binary command-queue protocol; the trainer talks to it
through ``RemoteGraphStore``, a drop-in ``GraphStore`` implementation,
so ``build_pipeline`` composes it unchanged via ``StoreSpec.mode='isp'``.

Modules:

* ``protocol``  — versioned header + numpy-payload framing (CRC32C from
  ``storage.integrity``), command opcodes, errors;
* ``transport`` — pluggable byte transports: Unix/TCP socket and a
  shared-memory ring for zero-copy local runs;
* ``server``    — the storage-side process
  (``python -m repro_torch.isp.server``) plus the spawn helper the
  pipeline uses;
* ``client``    — ``IspClient`` (pipelined in-flight command window,
  reconnect-and-replay) and ``RemoteGraphStore``.
"""

import importlib

__all__ = ["Command", "IspClient", "IspServer", "ProtocolError",
           "RemoteGraphStore", "RemoteStoreError", "TransportClosed",
           "spawn_server"]

_EXPORTS = {
    "Command": "protocol", "ProtocolError": "protocol",
    "IspClient": "client", "RemoteGraphStore": "client",
    "RemoteStoreError": "client",
    "IspServer": "server", "spawn_server": "server",
    "TransportClosed": "transport",
}


def __getattr__(name):
    # lazy re-exports (PEP 562): importing the package must not import
    # ``repro_torch.isp.server`` eagerly — ``python -m
    # repro_torch.isp.server`` would then see the module in sys.modules
    # before runpy executes it
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"repro_torch.isp.{mod}"), name)
