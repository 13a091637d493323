"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
plain PyTorch versions (``ref``), and the device-dispatching wrappers
(``ops``).

``LAUNCHES`` counts, per kernel, the launches its wrapper has made since
the last ``reset_launches()``: a run can show that its main path really
went through the kernels.  The plain CPU path counts nothing.  Wrappers
count through ``count_launch``, which is safe to call from several
threads at once (the overlapped pipeline launches from its lanes) and
also keeps each thread's own counts (``thread_launches``), so a stage
can bill the launches it made to its batch.
"""

import threading

LAUNCHES = {"neighbor_sample": 0, "feature_gather_rows": 0,
            "feature_gather_mean": 0, "neighbor_sample_cached": 0,
            "feature_gather_cached": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "decode_attention": 0, "ssd_chunk_scan": 0}

_LOCK = threading.Lock()
_THREAD = threading.local()


def count_launch(name: str) -> None:
    """Count one launch of kernel ``name``: in ``LAUNCHES``, under a lock,
    and in the calling thread's own counts."""
    with _LOCK:
        LAUNCHES[name] += 1
    mine = getattr(_THREAD, "counts", None)
    if mine is None:
        mine = _THREAD.counts = dict.fromkeys(LAUNCHES, 0)
    mine[name] += 1


def thread_launches() -> dict:
    """A copy of the calling thread's launch counts since it started (not
    reset by ``reset_launches``; take differences)."""
    return dict(getattr(_THREAD, "counts", None)
                or dict.fromkeys(LAUNCHES, 0))


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
