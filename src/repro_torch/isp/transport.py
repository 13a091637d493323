"""Byte transports for the command-queue protocol (the port's copy of
the reference's ``isp/transport.py``).

Two families behind one tiny interface (``send_bytes`` / ``recv_exact``
/ ``close``):

* **sockets** (``unix`` — the default for a storage process on the same
  machine — and ``tcp``): kernel-buffered streams; a dead peer surfaces
  as ``TransportClosed`` from either direction.
* **shared-memory ring** (``shm``): two single-producer single-consumer
  byte rings in ``multiprocessing.shared_memory`` segments, one per
  direction — command frames are copied straight between address
  spaces, no kernel round-trip per message (the zero-syscall local
  path an on-device command queue would use).

Addresses:  ``unix`` — a filesystem path; ``tcp`` — ``host:port``;
``shm`` — the name prefix of the two ring segments (created by
``ShmServerListener``).
"""

from __future__ import annotations

import os
import socket
import time

TRANSPORTS = ("unix", "tcp", "shm")


class TransportClosed(ConnectionError):
    """The peer went away (clean close or crash) — distinguishable from a
    protocol error so the client can classify and reconnect."""


def _check_kind(kind: str) -> None:
    if kind not in TRANSPORTS:
        raise ValueError(f"unknown transport {kind!r}; have {TRANSPORTS}")


class SocketTransport:
    """Stream socket with exact-length reads and atomic frame writes."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        if sock.family == socket.AF_INET:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.closed = False

    def send_bytes(self, data: bytes) -> None:
        try:
            self.sock.sendall(data)
        except OSError as e:
            raise TransportClosed(f"peer closed during send: {e}") from e

    def recv_exact(self, n: int) -> bytes:
        parts = []
        got = 0
        while got < n:
            try:
                chunk = self.sock.recv(min(n - got, 1 << 20))
            except OSError as e:
                raise TransportClosed(f"peer closed during recv: {e}") from e
            if not chunk:
                raise TransportClosed(
                    f"peer closed mid-frame ({got}/{n} bytes)")
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts) if len(parts) != 1 else parts[0]

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self.sock.close()


class SocketListener:
    """Server-side accept loop for ``unix``/``tcp``."""

    def __init__(self, kind: str, address: str):
        _check_kind(kind)
        self.kind = kind
        if kind == "unix":
            if os.path.exists(address):
                os.unlink(address)
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.bind(address)
            self.address = address
        elif kind == "tcp":
            host, _, port = address.rpartition(":")
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host or "127.0.0.1", int(port or 0)))
            h, p = s.getsockname()
            self.address = f"{h}:{p}"
        else:
            raise ValueError("shm uses ShmServerListener")
        s.listen(4)
        self.sock = s

    def accept(self, timeout: float | None = None) -> SocketTransport:
        self.sock.settimeout(timeout)
        try:
            conn, _ = self.sock.accept()
        except socket.timeout as e:
            raise TimeoutError("no client connected") from e
        conn.settimeout(None)
        return SocketTransport(conn)

    def close(self) -> None:
        self.sock.close()
        if self.kind == "unix" and os.path.exists(self.address):
            try:
                os.unlink(self.address)
            except OSError:
                pass


def connect(kind: str, address: str, *, timeout: float = 10.0,
            poll_s: float = 0.05):
    """Client-side connect with a retry deadline (the server process may
    still be starting up)."""
    _check_kind(kind)
    deadline = time.monotonic() + timeout
    last: Exception | None = None
    while time.monotonic() < deadline:
        try:
            if kind == "unix":
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.connect(address)
                return SocketTransport(s)
            if kind == "tcp":
                host, _, port = address.rpartition(":")
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                s.connect((host or "127.0.0.1", int(port)))
                return SocketTransport(s)
            return ShmTransport.attach(address)
        except (OSError, FileNotFoundError) as e:
            last = e
            time.sleep(poll_s)
    raise TransportClosed(
        f"could not connect to {kind}:{address} within {timeout}s: {last}")


def make_listener(kind: str, address: str):
    _check_kind(kind)
    if kind == "shm":
        return ShmServerListener(address)
    return SocketListener(kind, address)


# ---------------------------------------------------------------------------
# shared-memory byte ring
# ---------------------------------------------------------------------------

# the header: head and tail (u64), writer_closed and reader_closed (u8)
_RING_HDR_BYTES = 64                    # cacheline-padded


class _Ring:
    """Single-producer single-consumer byte ring over one shared-memory
    segment.  ``head``/``tail`` are monotonically increasing byte totals
    (u64 — wrap is off the table), so fullness is ``head - tail``."""

    def __init__(self, shm, capacity: int, *, owner: bool):
        self.shm = shm
        self.capacity = capacity
        self.owner = owner
        self.buf = shm.buf
        # head and tail as native u64s: each read or write of one is a
        # single aligned 8-byte access, which the other process never sees
        # half done (struct packs and unpacks byte by byte, and a torn
        # head could read as fewer bytes than the reader has taken)
        self._at = shm.buf[:16].cast("Q")

    @classmethod
    def create(cls, name: str, capacity: int) -> "_Ring":
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(
            name=name, create=True, size=_RING_HDR_BYTES + capacity)
        shm.buf[:_RING_HDR_BYTES] = b"\0" * _RING_HDR_BYTES
        return cls(shm, capacity, owner=True)

    @classmethod
    def attach(cls, name: str) -> "_Ring":
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(name=name)
        try:
            # CPython < 3.13 registers attached segments with the resource
            # tracker, which then unlinks them a second time at exit; the
            # creator owns the lifetime, so unregister the attachment
            from multiprocessing import resource_tracker
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        return cls(shm, shm.size - _RING_HDR_BYTES, owner=False)

    def _hdr(self) -> tuple[int, int, int, int]:
        return self._at[0], self._at[1], self.buf[16], self.buf[17]

    def _set_head(self, v: int) -> None:
        self._at[0] = v

    def _set_tail(self, v: int) -> None:
        self._at[1] = v

    def mark_closed(self, *, writer: bool) -> None:
        self.buf[16 if writer else 17] = 1

    def write(self, data, *, timeout: float | None = None) -> None:
        mv = memoryview(data)
        deadline = None if timeout is None else time.monotonic() + timeout
        off = 0
        cap = self.capacity
        while off < len(mv):
            head, tail, _w, reader_closed = self._hdr()
            free = cap - (head - tail)
            if free == 0:
                if reader_closed:
                    raise TransportClosed("shm ring: reader closed")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("shm ring: write stalled")
                time.sleep(50e-6)
                continue
            n = min(free, len(mv) - off)
            pos = head % cap
            first = min(n, cap - pos)
            base = _RING_HDR_BYTES
            self.buf[base + pos:base + pos + first] = mv[off:off + first]
            if n > first:
                self.buf[base:base + n - first] = mv[off + first:off + n]
            self._set_head(head + n)
            off += n

    def read_exact(self, n: int, *, timeout: float | None = None) -> bytes:
        out = bytearray(n)
        deadline = None if timeout is None else time.monotonic() + timeout
        got = 0
        cap = self.capacity
        while got < n:
            head, tail, writer_closed, _r = self._hdr()
            avail = head - tail
            if avail == 0:
                if writer_closed:
                    raise TransportClosed(
                        f"shm ring: writer closed mid-frame ({got}/{n})")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("shm ring: read stalled")
                time.sleep(50e-6)
                continue
            k = min(avail, n - got)
            pos = tail % cap
            first = min(k, cap - pos)
            base = _RING_HDR_BYTES
            out[got:got + first] = self.buf[base + pos:base + pos + first]
            if k > first:
                out[got + first:got + k] = self.buf[base:base + k - first]
            self._set_tail(tail + k)
            got += k
        return bytes(out)

    def close(self) -> None:
        buf = self.buf
        self.buf = None
        if buf is not None:
            self._at.release()
            try:
                self.shm.close()
            except Exception:
                pass
            if self.owner:
                try:
                    self.shm.unlink()
                except FileNotFoundError:
                    pass


class ShmTransport:
    """Bidirectional transport over two rings, ``<prefix>-c2s`` (client
    writes) and ``<prefix>-s2c`` (server writes)."""

    def __init__(self, tx: _Ring, rx: _Ring):
        self._tx = tx
        self._rx = rx
        self.closed = False

    @classmethod
    def attach(cls, prefix: str) -> "ShmTransport":
        return cls(tx=_Ring.attach(f"{prefix}-c2s"),
                   rx=_Ring.attach(f"{prefix}-s2c"))

    def send_bytes(self, data: bytes) -> None:
        self._tx.write(data)

    def recv_exact(self, n: int) -> bytes:
        return self._rx.read_exact(n)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._tx.mark_closed(writer=True)
            self._rx.mark_closed(writer=False)
            self._tx.close()
            self._rx.close()


class ShmServerListener:
    """Creates the ring pair; ``accept`` returns the server-side view
    (tx = s2c, rx = c2s).  One client per listener — the SPSC rings are
    the point."""

    DEFAULT_CAPACITY = 8 << 20

    def __init__(self, prefix: str, capacity: int | None = None):
        cap = capacity or self.DEFAULT_CAPACITY
        self.address = prefix
        self._c2s = _Ring.create(f"{prefix}-c2s", cap)
        self._s2c = _Ring.create(f"{prefix}-s2c", cap)

    def accept(self, timeout: float | None = None) -> ShmTransport:
        t = ShmTransport(tx=self._s2c, rx=self._c2s)
        self._c2s = self._s2c = None
        return t

    def close(self) -> None:
        for ring in (self._c2s, self._s2c):
            if ring is not None:
                ring.close()
        self._c2s = self._s2c = None
