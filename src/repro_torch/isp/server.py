"""The storage-side process: an SSD-firmware-style command engine (the
port's copy of the reference's ``isp/server.py``).

``IspServer`` owns the ``DiskStore`` — page cache, retry policy, fault
injection, CRC verification and telemetry all live on this side of the
wire, exactly like controller firmware owns the device's DRAM buffer and
FTL — and executes commands from the queue:

* ``SAMPLE_KHOP`` is the paper's pushdown: the whole k-hop expansion
  runs against the local store (many raw block reads stay inside the
  "device"), and the reply carries only the sampled subgraph — per-hop
  id tensors, the **deduplicated** unique-node feature rows, and the
  targets' labels.  The client reconstructs dense per-hop features by
  ``searchsorted`` into the unique rows (the same unique+inverse the
  store's own ``gather_features`` performs), so results are
  bit-identical to host-side sampling at equal seeds while the wire
  carries a fraction of the raw bytes read from flash.
* ``GATHER_*`` / ``OUT_DEGREES`` / ``DEGREES`` / ``NEIGHBORS`` serve the
  plain ``GraphStore`` access protocol remotely (the non-pushdown path:
  e.g. a device-cache tier fetching miss rows).
* ``STATS`` ships the store's counters plus the server's wire totals —
  the numbers behind the headline bytes-over-wire comparison.
* ``SHUTDOWN`` replies, closes the store, and exits 0.

Run as ``python -m repro_torch.isp.server --config <json-or-path>``; the
pipeline spawns it via ``spawn_server``.  The process imports numpy, the
store and the protocol only, never torch: it starts fast and creates no
CUDA context, and it is started with ``Popen`` (a fresh interpreter), so
it inherits none of the trainer's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.core.sampler import _io_delta, _io_snapshot, sample_khop
from repro_torch.isp import protocol, transport
from repro_torch.isp.protocol import Command
from repro_torch.obs import session as obs_session
from repro_torch.storage.specs import RetrySpec
from repro_torch.storage.store import DiskStore


class IspServer:
    """Dispatch loop over one connection (the SPSC command queue)."""

    def __init__(self, store, *, payload_crc: bool = False):
        self.store = store
        self.payload_crc = payload_crc
        self.bytes_tx = 0
        self.bytes_rx = 0
        self.requests = 0
        self.commands: dict[str, int] = {}
        self.started = time.monotonic()
        self._shutdown = False

    # -- command handlers ----------------------------------------------------
    def _cmd_hello(self, msg):
        s = self.store
        meta = {"name": s.name, "num_nodes": s.num_nodes,
                "num_edges": s.num_edges, "feat_dim": s.feat_dim,
                "n_classes": getattr(s, "n_classes", 0),
                "block_bytes": getattr(s, "block_bytes", 0),
                "protocol": protocol.VERSION}
        return meta, []

    def _cmd_sample_khop(self, msg):
        (targets,) = msg.arrays
        fanouts = tuple(msg.meta["fanouts"])
        seed = int(msg.meta["seed"])
        io0 = _io_snapshot(self.store)
        trace = sample_khop(self.store, targets, fanouts, seed=seed)
        uniq = trace.subgraph_nodes
        arrays = list(trace.hops)
        meta = {"n_hops": len(trace.hops)}
        arrays.append(uniq)
        if msg.meta.get("feats", True):
            arrays.append(self.store.gather_features(uniq))
            meta["feats"] = True
        if msg.meta.get("labels", True):
            arrays.append(self.store.gather_labels(targets))
            meta["labels"] = True
        # the batch's storage-side I/O bill rides back flat; the client
        # nests it into trace.io like the host producer does
        meta["io"] = _io_delta(self.store, io0)
        return meta, arrays

    def _cmd_gather_features(self, msg):
        (ids,) = msg.arrays
        return {}, [self.store.gather_features(ids)]

    def _cmd_gather_labels(self, msg):
        (ids,) = msg.arrays
        return {}, [self.store.gather_labels(ids)]

    def _cmd_gather_edges(self, msg):
        rows, offsets = msg.arrays
        return {}, [self.store.gather_edges(rows, offsets)]

    def _cmd_gather_edge_blocks(self, msg):
        (blocks,) = msg.arrays
        out = self.store.gather_edge_blocks(blocks,
                                            int(msg.meta["block_e"]))
        return {}, [out]

    def _cmd_out_degrees(self, msg):
        (nodes,) = msg.arrays
        return {}, [self.store.out_degrees(nodes)]

    def _cmd_degrees(self, msg):
        return {}, [self.store.degrees()]

    def _cmd_neighbors(self, msg):
        return {}, [self.store.neighbors(int(msg.meta["u"]))]

    def _cmd_stats(self, msg):
        return {"stats": self.store.stats(),
                "io_counters": self.store.io_counters(),
                "server": self.wire_counters()}, []

    def _cmd_shutdown(self, msg):
        self._shutdown = True
        return {"ok": True}, []

    _DISPATCH = {
        Command.HELLO: _cmd_hello,
        Command.SAMPLE_KHOP: _cmd_sample_khop,
        Command.GATHER_FEATURES: _cmd_gather_features,
        Command.GATHER_LABELS: _cmd_gather_labels,
        Command.GATHER_EDGES: _cmd_gather_edges,
        Command.GATHER_EDGE_BLOCKS: _cmd_gather_edge_blocks,
        Command.OUT_DEGREES: _cmd_out_degrees,
        Command.DEGREES: _cmd_degrees,
        Command.NEIGHBORS: _cmd_neighbors,
        Command.STATS: _cmd_stats,
        Command.SHUTDOWN: _cmd_shutdown,
    }

    def wire_counters(self) -> dict:
        return {"bytes_tx": self.bytes_tx, "bytes_rx": self.bytes_rx,
                "requests": self.requests, "commands": dict(self.commands),
                "uptime_s": time.monotonic() - self.started}

    # -- dispatch ------------------------------------------------------------
    def handle_one(self, conn) -> bool:
        """Serve one frame; returns False when the loop should stop."""
        msg, nbytes = protocol.read_message(conn.recv_exact)
        self.bytes_rx += nbytes
        self.requests += 1
        obs_session.metric_inc("isp.bytes_rx", nbytes)
        obs_session.metric_inc("isp.requests")
        try:
            cmd = Command(msg.command)
            name = cmd.name.lower()
        except ValueError:
            cmd, name = None, f"op{msg.command}"
        self.commands[name] = self.commands.get(name, 0) + 1
        flags = protocol.FLAG_REPLY
        try:
            if cmd is None:
                raise protocol.ProtocolError(
                    f"unknown command {msg.command}")
            with obs_session.trace_span("isp.cmd", command=name,
                                        request_id=msg.request_id):
                meta, arrays = self._DISPATCH[cmd](self, msg)
        except Exception as e:  # noqa: BLE001 — classified for the client
            meta, arrays = {"error": str(e),
                            "class": type(e).__name__}, []
            flags |= protocol.FLAG_ERROR
        reply = protocol.encode(msg.command, msg.request_id, meta, arrays,
                                flags=flags, payload_crc=self.payload_crc)
        conn.send_bytes(reply)
        self.bytes_tx += len(reply)
        obs_session.metric_inc("isp.bytes_tx", len(reply))
        return not self._shutdown

    def serve_connection(self, conn) -> bool:
        """Serve frames until SHUTDOWN (returns True) or the peer goes
        away (returns False — the listener may accept a reconnect)."""
        try:
            while self.handle_one(conn):
                pass
            return True
        except transport.TransportClosed:
            return False
        finally:
            conn.close()


def run_server(config: dict) -> int:
    """Open the store described by ``config``, listen, serve until
    SHUTDOWN.  A dropped connection is not fatal — the client may
    reconnect (the pipeline's reconnect-and-replay path)."""
    sc = dict(config["store"])
    retry = sc.pop("retry", None)
    if isinstance(retry, dict):
        retry = RetrySpec(**retry)
    faults = sc.pop("faults", None)
    if isinstance(faults, dict):
        from repro_torch.storage.faults import FaultSpec
        faults = FaultSpec(**faults)
    store = DiskStore(sc.pop("path"), retry=retry, faults=faults, **sc)
    obs_cfg = config.get("obs") or {}
    session = None
    if obs_cfg.get("trace_path") or obs_cfg.get("metrics_path"):
        session = obs_session.install(obs_session.ObsSession(
            trace_path=obs_cfg.get("trace_path"),
            metrics_path=obs_cfg.get("metrics_path"),
            metrics_interval_s=obs_cfg.get("metrics_interval_s", 5.0)))
    listener = transport.make_listener(config.get("transport", "unix"),
                                       config["address"])
    server = IspServer(store,
                       payload_crc=bool(config.get("payload_crc", False)))
    accept_timeout = float(config.get("accept_timeout_s", 120.0))
    try:
        # 1 s accept polls so a dead trainer is noticed promptly: when the
        # spawning process exits the kernel reparents this child and
        # getppid() changes — no point waiting out the reconnect window
        ppid0 = os.getppid()
        deadline = time.monotonic() + accept_timeout
        while True:
            try:
                conn = listener.accept(timeout=min(1.0, accept_timeout))
            except TimeoutError:
                if os.getppid() != ppid0:
                    break   # trainer died; nobody left to reconnect
                if time.monotonic() >= deadline:
                    break   # orphaned: trainer never (re)connected
                continue
            if server.serve_connection(conn):
                break
            deadline = time.monotonic() + accept_timeout
    finally:
        listener.close()
        store.close()
        if session is not None:
            session.close()
    return 0


def spawn_server(config: dict) -> subprocess.Popen:
    """Launch ``python -m repro_torch.isp.server`` with this interpreter
    and the port's source tree on the child's path."""
    import repro_torch
    pkg = os.path.dirname(repro_torch.__file__)
    src = os.path.dirname(os.path.abspath(pkg))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.isp.server",
         "--config", json.dumps(config)],
        env=env, stdin=subprocess.DEVNULL)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SmartSAGE in-storage processing server")
    ap.add_argument("--config", required=True,
                    help="server config: inline JSON or a path to a "
                         "JSON file")
    args = ap.parse_args(argv)
    cfg = args.config
    if os.path.exists(cfg):
        with open(cfg) as f:
            config = json.load(f)
    else:
        config = json.loads(cfg)
    return run_server(config)


if __name__ == "__main__":
    sys.exit(main())
