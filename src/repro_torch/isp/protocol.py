"""Command-queue wire protocol for the in-storage processing service (the
port's copy of the reference's ``isp/protocol.py``: its frames are byte
for byte the reference's).

Every message — request or reply — is one frame:

    +----------------------------+  28-byte fixed header, little-endian
    | magic   u32  'ISPQ'        |
    | version u16                |
    | command u8   (Command)     |
    | flags   u8   REPLY/ERROR/… |
    | req_id  u32                |
    | meta    u32  byte length   |
    | payload u64  byte length   |
    | crc     u32  CRC32C of the |
    |              24 bytes above|
    +----------------------------+
    | meta: UTF-8 JSON           |  command arguments / reply fields; its
    |                            |  "__arrays__" key describes the payload
    +----------------------------+
    | payload: raw numpy buffers |  concatenated C-contiguous array bytes
    +----------------------------+

The header CRC reuses the store's CRC32C (``storage.integrity``) so a
garbage or truncated header is rejected before any length field is
trusted.  Payload integrity is optional (``FLAG_PAYLOAD_CRC``): the
scalar CRC is pure Python and a feature-row payload is large, so the
default leaves payload protection to the transport (TCP/Unix sockets
already checksum) while the flag turns on end-to-end coverage.

Arrays travel as ``(dtype, shape)`` descriptors in the meta plus their
raw bytes in the payload — no pickling, nothing executable crosses the
wire, and the decoder can bound every allocation before reading it.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import struct

import numpy as np

from repro_torch.storage.integrity import crc32c

MAGIC = 0x51505349          # b"ISPQ" little-endian
VERSION = 1

# magic, version, command, flags, request_id, meta_len, payload_len, crc
_HEADER = struct.Struct("<IHBBIIQI")
HEADER_BYTES = _HEADER.size

FLAG_REPLY = 0x01
FLAG_ERROR = 0x02
FLAG_PAYLOAD_CRC = 0x04

# decoder hard bounds — a corrupt-but-CRC-colliding header must not be
# able to request an absurd allocation
MAX_META_BYTES = 64 << 20
MAX_PAYLOAD_BYTES = 16 << 30


class Command(enum.IntEnum):
    """Opcodes of the command queue (request and its reply share one)."""

    HELLO = 1               # handshake: server describes its graph
    SAMPLE_KHOP = 2         # the pushdown: sample+gather server-side
    GATHER_FEATURES = 3
    GATHER_LABELS = 4
    GATHER_EDGES = 5
    GATHER_EDGE_BLOCKS = 6
    OUT_DEGREES = 7
    DEGREES = 8
    NEIGHBORS = 9
    STATS = 10
    SHUTDOWN = 11


class ProtocolError(RuntimeError):
    """Malformed frame: bad magic/version/CRC, oversized lengths, or a
    meta/payload that does not match its descriptors."""


@dataclasses.dataclass
class Message:
    """One decoded frame."""

    command: int
    request_id: int
    meta: dict
    arrays: list[np.ndarray]
    flags: int = 0

    @property
    def is_reply(self) -> bool:
        return bool(self.flags & FLAG_REPLY)

    @property
    def is_error(self) -> bool:
        return bool(self.flags & FLAG_ERROR)


def encode(command: int, request_id: int, meta: dict | None = None,
           arrays=(), *, flags: int = 0, payload_crc: bool = False) -> bytes:
    """Serialize one frame.  ``arrays`` become C-contiguous raw buffers in
    the payload, described (dtype, shape) under meta's ``__arrays__``."""
    bufs = [np.ascontiguousarray(a) for a in arrays]
    m = dict(meta or {})
    # descriptors carry the ORIGINAL shapes: ascontiguousarray promotes
    # 0-d arrays to (1,), and the decoder's reshape restores ()
    m["__arrays__"] = [[b.dtype.str, list(np.asarray(a).shape)]
                       for a, b in zip(arrays, bufs)]
    if payload_crc:
        crc = 0
        for b in bufs:
            crc = crc32c(b.tobytes(), crc)
        m["__payload_crc__"] = crc
        flags |= FLAG_PAYLOAD_CRC
    meta_b = json.dumps(m, separators=(",", ":")).encode()
    payload_len = sum(b.nbytes for b in bufs)
    head = _HEADER.pack(MAGIC, VERSION, int(command), flags,
                        request_id & 0xFFFFFFFF, len(meta_b), payload_len, 0)
    head = head[:-4] + struct.pack("<I", crc32c(head[:-4]))
    return b"".join([head, meta_b] + [b.tobytes() for b in bufs])


def _parse_header(head: bytes) -> tuple[int, int, int, int, int]:
    """Validate a header frame; returns (command, flags, request_id,
    meta_len, payload_len)."""
    if len(head) != HEADER_BYTES:
        raise ProtocolError(
            f"truncated header: {len(head)}/{HEADER_BYTES} bytes")
    magic, version, command, flags, rid, meta_len, payload_len, crc = (
        _HEADER.unpack(head))
    if magic != MAGIC:
        raise ProtocolError(f"bad magic 0x{magic:08x}")
    if crc32c(head[:-4]) != crc:
        raise ProtocolError("header CRC32C mismatch")
    if version != VERSION:
        raise ProtocolError(f"protocol version {version} != {VERSION}")
    if meta_len > MAX_META_BYTES:
        raise ProtocolError(f"meta length {meta_len} exceeds bound")
    if payload_len > MAX_PAYLOAD_BYTES:
        raise ProtocolError(f"payload length {payload_len} exceeds bound")
    return command, flags, rid, meta_len, payload_len


def read_message(recv_exact) -> tuple[Message, int]:
    """Read one frame via ``recv_exact(n) -> bytes`` (a transport method;
    raises ``TransportClosed`` on a dead peer).  Returns the decoded
    message and its total wire size in bytes."""
    head = bytes(recv_exact(HEADER_BYTES))
    command, flags, rid, meta_len, payload_len = _parse_header(head)
    meta_b = bytes(recv_exact(meta_len)) if meta_len else b""
    try:
        meta = json.loads(meta_b.decode()) if meta_b else {}
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"meta is not valid JSON: {e}") from e
    payload = bytes(recv_exact(payload_len)) if payload_len else b""
    desc = meta.pop("__arrays__", [])
    arrays: list[np.ndarray] = []
    off = 0
    for dtype_str, shape in desc:
        try:
            dt = np.dtype(dtype_str)
        except TypeError as e:
            raise ProtocolError(f"bad array dtype {dtype_str!r}") from e
        nbytes = int(dt.itemsize * int(np.prod(shape, dtype=np.int64)))
        if off + nbytes > len(payload):
            raise ProtocolError(
                f"payload too short for descriptors: need {off + nbytes}, "
                f"have {len(payload)}")
        arrays.append(np.frombuffer(
            payload, dtype=dt, count=nbytes // dt.itemsize if dt.itemsize
            else 0, offset=off).reshape(shape))
        off += nbytes
    if off != len(payload):
        raise ProtocolError(
            f"payload length {len(payload)} != descriptor total {off}")
    want_crc = meta.pop("__payload_crc__", None)
    if flags & FLAG_PAYLOAD_CRC and want_crc is not None:
        if crc32c(payload) != want_crc:
            raise ProtocolError("payload CRC32C mismatch")
    msg = Message(command=command, request_id=rid, meta=meta,
                  arrays=arrays, flags=flags)
    return msg, HEADER_BYTES + meta_len + payload_len
