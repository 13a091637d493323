"""The failure mix of the storage tier's fault injection, as a spec.

The port's copy of ``FaultSpec`` from the reference's
``storage/faults.py``: the ``PipelineSpec`` tree parses, validates and
round-trips ``store.faults`` with it.  The injector itself
(``FaultInjector``) is not part of the port yet: ``DiskStore(faults=)``
refuses, and ``build_pipeline`` refuses a spec that carries an active
``FaultSpec``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Failure mix of the fault injector.  Rates are per-pread
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
