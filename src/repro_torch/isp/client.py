"""Trainer-side view of the in-storage processing service (the port's
copy of the reference's ``isp/client.py``).

``IspClient`` speaks the command-queue protocol over any transport with
a **pipelined in-flight window**: up to ``window`` commands may be on
the wire at once (a reader thread matches replies to requests by id),
so concurrent producer workers and ahead-of-time prefetch overlap their
round-trips instead of serializing on the queue.  Every command is an
idempotent read, which is what makes **reconnect-and-replay** sound: a
transient drop fails the in-flight calls, the next call dials again,
and ``RemoteGraphStore`` replays the failed command on the fresh
connection.  A peer that stays dead surfaces as ``RemoteStoreError`` —
a classified ``StoreReadError`` — so the producer/consumer pipeline's
existing fault machinery propagates it promptly instead of
hanging.

``RemoteGraphStore`` implements the ``GraphStore`` protocol over the
client, plus ``sample_khop_pushdown`` — the fused server-side
sample+gather the host producer prefers when present.  Wire traffic is
counted into the canonical ``isp.*`` metrics on both sides, with
per-command spans and an ``isp.rtt`` histogram.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.core.sampler import SampleTrace
from repro_torch.isp import protocol, transport
from repro_torch.isp.protocol import Command
from repro_torch.obs import session as obs_session
from repro_torch.storage.store import (IOContext, StoreReadError,
                                       nest_fault_counters)


class RemoteStoreError(StoreReadError):
    """The storage process is unreachable (peer closed, crashed, or
    refused reconnection) or replied with a storage-side failure."""


class _Pending:
    __slots__ = ("event", "reply", "error", "t0")

    def __init__(self):
        self.event = threading.Event()
        self.reply: protocol.Message | None = None
        self.error: Exception | None = None
        self.t0 = time.perf_counter()


class IspClient:
    """One connection to an ``IspServer`` with a pipelined request window."""

    def __init__(self, kind: str, address: str, *, window: int = 4,
                 connect_timeout: float = 15.0, call_timeout: float = 120.0,
                 payload_crc: bool = False):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.kind = kind
        self.address = address
        self.window = window
        self.connect_timeout = connect_timeout
        self.call_timeout = call_timeout
        self.payload_crc = payload_crc
        self.hello: dict = {}
        self.counters = {"requests": 0, "bytes_tx": 0, "bytes_rx": 0,
                         "disconnects": 0, "reconnects": 0}
        self._lock = threading.Lock()        # send + pending-map + counters
        self._sem = threading.Semaphore(window)
        self._pending: dict[int, _Pending] = {}
        self._next_id = 0
        self._closed = False
        self._dead: Exception | None = None
        self._conn = None
        self._reader: threading.Thread | None = None
        self._connect()

    # -- connection lifecycle ------------------------------------------------
    def _connect(self) -> None:
        self._conn = transport.connect(self.kind, self.address,
                                       timeout=self.connect_timeout)
        self._dead = None
        self._reader = threading.Thread(
            target=self._read_loop, args=(self._conn,),
            name="isp-client-reader", daemon=True)
        self._reader.start()
        self.hello = self.call(Command.HELLO).meta

    def reconnect(self) -> None:
        """Dial again after a drop (the server survives connection loss
        and keeps listening)."""
        with self._lock:
            old, self._conn = self._conn, None
            old_reader = self._reader
        if old is not None:
            old.close()
        if old_reader is not None:
            # the dying reader marks the client dead on its way out; let
            # it finish before the fresh connection clears the flag
            old_reader.join(timeout=5.0)
        self._connect()
        with self._lock:
            self.counters["reconnects"] += 1
        obs_session.metric_inc("isp.reconnects")

    def drop_connection(self) -> None:
        """Test hook: sever the transport as a crash would."""
        conn = self._conn
        if conn is not None:
            conn.close()

    def _read_loop(self, conn) -> None:
        try:
            while True:
                msg, nbytes = protocol.read_message(conn.recv_exact)
                with self._lock:
                    self.counters["bytes_rx"] += nbytes
                    pending = self._pending.pop(msg.request_id, None)
                obs_session.metric_inc("isp.bytes_rx", nbytes)
                if pending is not None:
                    obs_session.metric_observe(
                        "isp.rtt", time.perf_counter() - pending.t0)
                    pending.reply = msg
                    pending.event.set()
        except (transport.TransportClosed, protocol.ProtocolError,
                OSError) as e:
            self._on_disconnect(e)

    def _on_disconnect(self, exc: Exception) -> None:
        with self._lock:
            if self._dead is None and not self._closed:
                self.counters["disconnects"] += 1
                obs_session.metric_inc("isp.disconnects")
            self._dead = exc
            stranded = list(self._pending.values())
            self._pending.clear()
        for p in stranded:
            p.error = RemoteStoreError(
                f"storage process connection lost: {exc}")
            p.event.set()

    # -- request pipeline ----------------------------------------------------
    def submit(self, command: Command, meta: dict | None = None,
               arrays=()) -> _Pending:
        """Put one command on the wire (blocking while the in-flight
        window is full); returns a handle for ``wait``."""
        if not self._sem.acquire(timeout=self.call_timeout):
            raise RemoteStoreError(
                f"in-flight window stayed full for {self.call_timeout}s")
        try:
            with self._lock:
                if self._closed:
                    raise RemoteStoreError("client is closed")
                if self._dead is not None:
                    raise RemoteStoreError(
                        f"storage process connection lost: {self._dead}")
                rid = self._next_id = (self._next_id + 1) & 0xFFFFFFFF
                pending = _Pending()
                self._pending[rid] = pending
                data = protocol.encode(command, rid, meta, arrays,
                                       payload_crc=self.payload_crc)
                try:
                    self._conn.send_bytes(data)
                except transport.TransportClosed:
                    self._pending.pop(rid, None)
                    raise
                self.counters["requests"] += 1
                self.counters["bytes_tx"] += len(data)
            obs_session.metric_inc("isp.requests")
            obs_session.metric_inc("isp.bytes_tx", len(data))
            return pending
        except transport.TransportClosed as e:
            self._sem.release()
            self._on_disconnect(e)
            raise RemoteStoreError(
                f"storage process connection lost: {e}") from e
        except Exception:
            self._sem.release()
            raise

    def wait(self, pending: _Pending) -> protocol.Message:
        try:
            if not pending.event.wait(timeout=self.call_timeout):
                raise RemoteStoreError(
                    f"no reply from storage process within "
                    f"{self.call_timeout}s")
        finally:
            self._sem.release()
        if pending.error is not None:
            raise pending.error
        msg = pending.reply
        if msg.is_error:
            cls = msg.meta.get("class", "")
            err = msg.meta.get("error", "server error")
            if cls in ("StoreReadError", "RemoteStoreError"):
                raise RemoteStoreError(f"storage-side read failed: {err}")
            raise RuntimeError(f"isp server error [{cls}]: {err}")
        return msg

    def call(self, command: Command, meta: dict | None = None,
             arrays=()) -> protocol.Message:
        name = Command(command).name.lower()
        with obs_session.trace_span("isp.cmd", command=name):
            return self.wait(self.submit(command, meta, arrays))

    def close(self) -> None:
        """Tear down the connection; every in-flight waiter is failed —
        never left hanging."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()          # wakes the reader -> fails pending
        if self._reader is not None:
            self._reader.join(timeout=5.0)
        self._on_disconnect(RemoteStoreError("client closed"))


class RemoteGraphStore:
    """``GraphStore`` over the wire — the trainer's only view of storage
    in ``StoreSpec.mode='isp'``.

    Graph-shape facts come from the HELLO handshake; every access method
    is one command round-trip (pipelined across producer workers by the
    client window).  Transient connection drops are healed by one
    reconnect-and-replay pass per call; a persistently dead server
    raises ``RemoteStoreError`` (a ``StoreReadError``), which the
    pipeline's lane supervision classifies instead of hanging.
    """

    kind = "isp"
    supports_pushdown = True

    def __init__(self, client: IspClient, *, server_proc=None,
                 reconnect_attempts: int = 1):
        self.client = client
        self.server_proc = server_proc
        self.reconnect_attempts = reconnect_attempts
        self.name = client.hello["name"]
        self._degrees: np.ndarray | None = None
        self._closed = False

    # -- shape facts (handshake) --------------------------------------------
    @property
    def num_nodes(self) -> int:
        return int(self.client.hello["num_nodes"])

    @property
    def num_edges(self) -> int:
        return int(self.client.hello["num_edges"])

    @property
    def feat_dim(self) -> int:
        return int(self.client.hello["feat_dim"])

    @property
    def n_classes(self) -> int:
        return int(self.client.hello.get("n_classes", 0))

    @property
    def block_bytes(self) -> int:
        return int(self.client.hello.get("block_bytes", 0))

    # -- command plumbing ----------------------------------------------------
    def _call(self, command: Command, meta: dict | None = None,
              arrays=()) -> protocol.Message:
        attempts = 1 + max(0, self.reconnect_attempts)
        for attempt in range(attempts):
            try:
                return self.client.call(command, meta, arrays)
            except RemoteStoreError:
                if attempt + 1 >= attempts or self._closed:
                    raise
                server_gone = (self.server_proc is not None
                               and self.server_proc.poll() is not None)
                if server_gone:
                    raise
                try:
                    self.client.reconnect()
                except (transport.TransportClosed, OSError) as e:
                    raise RemoteStoreError(
                        f"storage process unreachable after drop: {e}"
                    ) from e
        raise RemoteStoreError("unreachable")   # pragma: no cover

    # -- GraphStore access methods -------------------------------------------
    def degrees(self) -> np.ndarray:
        if self._degrees is None:
            (d,) = self._call(Command.DEGREES).arrays
            self._degrees = d
        return self._degrees

    def out_degrees(self, nodes) -> np.ndarray:
        (d,) = self._call(Command.OUT_DEGREES, arrays=[
            np.asarray(nodes, np.int64)]).arrays
        return d

    def neighbors(self, u: int) -> np.ndarray:
        (n,) = self._call(Command.NEIGHBORS, {"u": int(u)}).arrays
        return n

    def gather_edges(self, rows, offsets) -> np.ndarray:
        (e,) = self._call(Command.GATHER_EDGES, arrays=[
            np.asarray(rows, np.int64), np.asarray(offsets, np.int64)
        ]).arrays
        return e

    def gather_features(self, ids) -> np.ndarray:
        (f,) = self._call(Command.GATHER_FEATURES,
                          arrays=[np.asarray(ids)]).arrays
        return f

    def gather_labels(self, ids) -> np.ndarray:
        (y,) = self._call(Command.GATHER_LABELS,
                          arrays=[np.asarray(ids)]).arrays
        return y

    def gather_edge_blocks(self, blocks, block_e: int) -> np.ndarray:
        (b,) = self._call(Command.GATHER_EDGE_BLOCKS,
                          {"block_e": int(block_e)},
                          arrays=[np.asarray(blocks, np.int64)]).arrays
        return b

    # -- the pushdown --------------------------------------------------------
    def sample_khop_pushdown(self, targets, fanouts, *, seed: int):
        """One fused SAMPLE_KHOP command: the storage process runs the
        whole k-hop expansion and replies with per-hop ids, unique
        feature rows and target labels.  Reconstruction mirrors
        ``sample_khop`` + ``gather_features`` exactly — bit-identical to
        host-side sampling at equal seeds — while only sampled bytes
        crossed the wire.  Returns ``(trace, hop_feats, labels)``."""
        targets = np.asarray(targets, np.int32)
        msg = self._call(Command.SAMPLE_KHOP,
                         {"fanouts": [int(f) for f in fanouts],
                          "seed": int(seed)},
                         arrays=[targets])
        n_hops = int(msg.meta["n_hops"])
        hops = list(msg.arrays[:n_hops])
        uniq = msg.arrays[n_hops]
        rows = msg.arrays[n_hops + 1]
        labels = msg.arrays[n_hops + 2]
        # same touched/subgraph derivation as sample_khop: every hop but
        # the last is expanded again
        touched = np.concatenate([h.reshape(-1) for h in hops[:-1]]
                                 if n_hops > 1 else [hops[0].reshape(-1)])
        trace = SampleTrace(
            touched_nodes=touched, hops=hops, subgraph_nodes=uniq,
            io=nest_fault_counters(dict(msg.meta.get("io") or {})))
        F = rows.shape[-1]
        hop_feats = [
            rows[np.searchsorted(uniq, h.reshape(-1))].reshape(h.shape + (F,))
            for h in hops]
        return trace, hop_feats, labels

    # -- accounting / stats --------------------------------------------------
    def isp_counters(self) -> dict:
        return dict(self.client.counters)

    def io_counters(self) -> dict:
        """The storage-side I/O totals (one STATS round-trip) — epoch
        deltas then reflect real server-side block traffic."""
        try:
            server = self._call(Command.STATS).meta["io_counters"]
            return {k: int(server.get(k, 0)) for k in IOContext.KEYS}
        except RemoteStoreError:
            return dict.fromkeys(IOContext.KEYS, 0)

    def stats(self) -> dict:
        out = {"kind": self.kind, "transport": self.client.kind,
               "address": self.client.address,
               "window": self.client.window,
               "isp": self.isp_counters()}
        try:
            meta = self._call(Command.STATS).meta
            out["server"] = meta["stats"]
            out["server_wire"] = meta["server"]
        except RemoteStoreError:
            out["server"] = None
        return out

    def to_csr(self):
        raise NotImplementedError(
            "RemoteGraphStore cannot materialize the graph trainer-side — "
            "that is the raw-page traffic the isp mode exists to avoid; "
            "pass the in-memory graph to build_pipeline for device "
            "backends instead")

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Shut the storage process down cleanly: SHUTDOWN over the wire
        (best effort), close the client (failing any stragglers), then
        reap the subprocess — escalating to kill so nothing leaks."""
        if self._closed:
            return
        self._closed = True
        try:
            self.client.call(Command.SHUTDOWN)
        except (RemoteStoreError, RuntimeError):
            pass
        self.client.close()
        proc = self.server_proc
        if proc is not None:
            try:
                proc.wait(timeout=10.0)
            except Exception:
                proc.kill()
                proc.wait(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
