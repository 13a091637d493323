"""Deterministic, seed-scheduled fault injection for the storage tier.

The port's copy of the reference's ``storage/faults.py``.  ``FaultSpec``
describes a failure mix (transient EIO, short reads, bit flips, latency
stalls, and one scheduled sample-lane stall); ``FaultInjector`` sits
below the retry and verify machinery in ``DiskStore._fetch`` and
perturbs single block preads.

Every decision is a pure function of ``(seed, array key, block, attempt,
fault kind)``: the CRC32 of ``f"{seed}:{key}:{block}:{attempt}:{kind}"``
over 2**32, the reference's hash, so both packages inject the same
faults into the same reads.  Unless ``persist`` is set, faults fire on
attempt 0 only, so the first retry of any read sees a healthy device and
a run under a transient schedule gives the fault-free run's data; the
faults show only in the counters.  ``persist=True`` hits every attempt,
which is how tests exhaust the retry budget.

``lane_stall_batch``/``lane_stall_s`` schedule the one pipeline-level
fault: the ``OverlappedLoader`` sample lane goes silent for
``lane_stall_s`` seconds just before that batch, which drives the
heartbeat watchdog's lane restart.
"""

from __future__ import annotations

import dataclasses
import errno
import time
import zlib


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Failure mix of ``FaultInjector``.  Rates are per-pread
    probabilities in [0, 1]; all-zero (and no lane stall) means inactive
    and is normalized to ``faults: null`` in the pipeline spec."""

    seed: int = 0
    eio_rate: float = 0.0          # pread raises OSError(EIO)
    short_read_rate: float = 0.0   # pread returns a truncated buffer
    bitflip_rate: float = 0.0      # one byte corrupted (needs verify=True)
    stall_rate: float = 0.0        # pread sleeps stall_s before returning
    stall_s: float = 0.05
    persist: bool = False          # fire on every attempt, not just the first
    lane_stall_batch: int = -1     # OverlappedLoader: stall the sample lane
    lane_stall_s: float = 0.0      # ...for this long, once, before that batch

    def __post_init__(self):
        for f in ("eio_rate", "short_read_rate", "bitflip_rate", "stall_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"faults.{f} must be in [0, 1], got {v!r}")
        if self.stall_s < 0 or self.lane_stall_s < 0:
            raise ValueError("fault stall durations must be >= 0")
        if self.lane_stall_batch >= 0 and self.lane_stall_s <= 0:
            raise ValueError("faults.lane_stall_batch needs lane_stall_s > 0")

    @property
    def storage_active(self) -> bool:
        return (self.eio_rate > 0 or self.short_read_rate > 0
                or self.bitflip_rate > 0 or self.stall_rate > 0)

    @property
    def active(self) -> bool:
        return self.storage_active or self.lane_stall_batch >= 0

    @property
    def lane_stall(self) -> "tuple[int, float] | None":
        if self.lane_stall_batch >= 0:
            return (self.lane_stall_batch, self.lane_stall_s)
        return None


def _roll(seed: int, key: str, block: int, attempt: int, kind: str) -> float:
    """Deterministic uniform in [0, 1) for one fault decision."""
    h = zlib.crc32(f"{seed}:{key}:{block}:{attempt}:{kind}".encode())
    return h / 2**32


class FaultInjector:
    """Wraps one raw block pread with the scheduled failure mix."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec

    def read(self, raw_read, key: str, block: int, attempt: int) -> bytes:
        """Run ``raw_read()`` (one block pread), perturbed per schedule.

        Stalls delay, EIO raises, short reads truncate, bit flips corrupt
        one byte.  A retried read replays the same scheduled fault
        (``persist``) or none (transient)."""
        s = self.spec
        if not s.persist and attempt > 0:
            return raw_read()
        a = attempt if s.persist else 0
        if _roll(s.seed, key, block, a, "stall") < s.stall_rate:
            time.sleep(s.stall_s)
        if _roll(s.seed, key, block, a, "eio") < s.eio_rate:
            raise OSError(errno.EIO, f"injected EIO: {key} block {block} "
                                     f"attempt {attempt}")
        data = raw_read()
        if _roll(s.seed, key, block, a, "short") < s.short_read_rate:
            return data[:max(1, len(data) // 2)]
        if _roll(s.seed, key, block, a, "flip") < s.bitflip_rate:
            buf = bytearray(data)
            pos = zlib.crc32(f"{s.seed}:{key}:{block}:pos".encode()) % len(buf)
            buf[pos] ^= 0x40
            return bytes(buf)
        return data
