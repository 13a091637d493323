"""Block integrity: CRC32C (Castagnoli) checksums for the on-disk
GraphStore layout.

SmartSAGE's premise is trusting capacity-optimized NVM with the training
working set, and NAND at that density fails *silently* as well as loudly
— a bit flip that survives the device's own ECC corrupts training data
without any error ever reaching the host.  ``save_graph`` therefore
records one CRC32C per ``block_bytes`` block in the manifest, and
``DiskStore(verify=True)`` checks every fetched block against it; a
mismatch is a ``corrupt_blocks`` fault handled by the retry policy like
any other failed read.

CRC32C (polynomial 0x1EDC6F41, reflected 0x82F63B78) is the checksum
NVMe end-to-end data protection and iSCSI use — the natural choice for a
storage tier.  There is no stdlib implementation and this repo installs
nothing, so both paths are implemented here:

* ``crc32c(data)`` — scalar, table-driven, one Python loop over the
  block (~0.5 ms per 4 KB block): the read-time verify path, opt-in and
  off the default hot path.
* ``block_checksums(buf, block_bytes)`` — vectorized across blocks: one
  numpy pass per *byte position* updating a ``(n_blocks,)`` vector of
  CRC states, so save-time checksumming of a whole array costs
  ``block_bytes`` numpy ops regardless of how many blocks it has.

Both produce identical values.  This module is the port's copy of the
reference's ``storage/integrity.py``; ``tests/test_torch_store.py`` holds
the two equal.
"""

from __future__ import annotations

import numpy as np

_POLY = 0x82F63B78      # CRC-32C (Castagnoli), reflected


def _make_table() -> np.ndarray:
    table = np.empty(256, np.uint32)
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table[n] = c
    return table


_TABLE = _make_table()
_TABLE_LIST = [int(x) for x in _TABLE]      # Python ints: fast scalar loop


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like).  ``crc`` chains partial results:
    ``crc32c(b, crc32c(a)) == crc32c(a + b)``."""
    c = crc ^ 0xFFFFFFFF
    tab = _TABLE_LIST
    for b in memoryview(data).cast("B"):
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def block_checksums(buf, block_bytes: int) -> np.ndarray:
    """Per-block CRC32C of ``buf`` (bytes-like, length a multiple of
    ``block_bytes``) as a ``(n_blocks,)`` uint32 array.

    Vectorized across blocks: the sequential dependency of a CRC is
    within one block only, so all blocks advance together one byte
    position at a time — ``block_bytes`` numpy steps total, independent
    of the block count."""
    data = np.frombuffer(buf, np.uint8)
    if data.size % block_bytes:
        raise ValueError(f"buffer size {data.size} is not a multiple of "
                         f"block_bytes={block_bytes}")
    if data.size == 0:
        return np.empty(0, np.uint32)
    blocks = data.reshape(-1, block_bytes)
    c = np.full(blocks.shape[0], 0xFFFFFFFF, np.uint32)
    eight = np.uint32(8)
    for p in range(block_bytes):
        c = _TABLE[(c ^ blocks[:, p]) & 0xFF] ^ (c >> eight)
    return c ^ np.uint32(0xFFFFFFFF)
