"""The in-storage processing service's shared-memory ring
(``repro_torch.isp.transport._Ring``) between two processes.

A writer process sends frames of varying size through a small ring, so
that its head and tail cross byte boundaries thousands of times while
the reader polls them; the reader checks every byte of every frame.  A
head or tail that the other process could read half written (a store
made byte by byte) shows here as a short, long or stalled read.
"""

import multiprocessing as mp
import os

from repro_torch.isp.transport import _Ring

FRAMES = 20000


def _size(i: int) -> int:
    return 1 + (i * 7919) % 3000


def _frame(i: int) -> bytes:
    return bytes([i % 251]) * _size(i)


def _write_frames(name: str) -> None:
    ring = _Ring.attach(name)
    try:
        for i in range(FRAMES):
            ring.write(_frame(i), timeout=60)
        ring.mark_closed(writer=True)
    finally:
        ring.close()


def test_frames_cross_the_ring_whole_between_processes():
    ring = _Ring.create(f"ring-test-{os.getpid():x}", 4096)
    proc = mp.get_context("spawn").Process(target=_write_frames,
                                           args=(ring.shm.name,))
    proc.start()
    try:
        for i in range(FRAMES):
            got = ring.read_exact(_size(i), timeout=60)
            assert got == _frame(i), (i, len(got))
        proc.join(timeout=60)
        assert proc.exitcode == 0
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()
        ring.close()
