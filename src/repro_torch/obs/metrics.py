"""Loop metrics shared by the trainer (a copy of the reference's helper)."""

from __future__ import annotations


def idle_fraction(idle_s: float, busy_s: float) -> float:
    """Fraction of consumer wall time spent waiting on the data plane
    -- the paper's Fig. 7 quantity.  Zero when nothing ran yet."""
    total = idle_s + busy_s
    return idle_s / total if total > 0 else 0.0
