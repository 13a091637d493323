"""Fault injection, direct I/O, the scheduled lane stall and the
device-cache bypass of the port, held against the reference on the CPU.

* ``_roll`` and ``FaultInjector.read`` make the reference's decisions:
  the same hash, the same bit-flip position, attempt 0 only unless
  ``persist``.
* A port and a reference ``DiskStore`` over one layout, under one fault
  mix with one pread thread, read the clean store's bytes and count the
  same EIOs, short reads and corrupt blocks (the timing-dependent
  ``timeouts`` and ``retries`` are not compared).
* The retry policy's edges: a persistent EIO exhausts it, a deadline
  overrun counts ``timeouts``, a bit flip without ``verify`` is refused.
* ``direct_io``: the mode the store reports agrees with the reference's
  on the same directory; an unaligned block size and a read refused
  mid-run each warn and read buffered.
* ``OverlappedLoader(stall_inject=)`` stalls the sample lane once and the
  watchdog restarts it; ``smoke_pallas_overlap_faults.json`` gives the
  batches of its fault-free twin as the reference runs it.
* The out-of-core loader under the fault mix, synchronous and
  overlapped, gives the reference's fault-free batches, and the
  device-cache bypass after a failed fetch keeps them.
"""

import errno
import os
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

import repro.core.config as ref_config
from repro.core import load_dataset as jload_dataset
from repro.storage import DiskStore as JDiskStore
from repro.storage import FaultSpec as JFaultSpec
from repro.storage import RetrySpec as JRetrySpec
from repro.storage import StoreReadError as JStoreReadError
from repro.storage import faults as jfaults
from repro_torch.core import (BackendSpec, CacheTierSpec, OverlappedLoader,
                              PipelineSpec, PrefetchSpec, SamplerSpec,
                              StoreSpec, build_pipeline, load_dataset)
from repro_torch.core import config as port_config
from repro_torch.storage import (DiskStore, FaultInjector, RetrySpec,
                                 StoreReadError, save_graph)
from repro_torch.storage import faults as port_faults
from repro_torch.storage.faults import FaultSpec

SPECS = Path(__file__).resolve().parent.parent / "benchmarks" / "specs"
FANOUTS = (3, 2)
BATCH = 8
WAIT = 30.0
MIX = dict(seed=11, eio_rate=0.15, short_read_rate=0.05, bitflip_rate=0.05,
           stall_rate=0.01, stall_s=0.005)
DETERMINISTIC = ("io_errors", "short_reads", "corrupt_blocks")


@pytest.fixture(scope="module")
def reddit():
    return jload_dataset("reddit"), load_dataset("reddit")


@pytest.fixture(scope="module")
def store_dir(reddit, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("faults") / "store")
    save_graph(reddit[1], path)
    return path


# ---------------------------------------------------------------------------
# the injector's decisions
# ---------------------------------------------------------------------------

def _outcome(injector, raw, key, block, attempt):
    try:
        return ("data", injector.read(lambda: raw, key, block, attempt))
    except OSError as e:
        return ("error", e.errno, str(e))


@pytest.mark.parametrize("seed,persist", [(0, False), (7, False),
                                          (11, True), (2**31 - 1, True)])
def test_injector_decisions_equal_reference(seed, persist):
    rates = dict(eio_rate=0.2, short_read_rate=0.2, bitflip_rate=0.2,
                 stall_rate=0.1, stall_s=0.0)
    port = FaultInjector(FaultSpec(seed=seed, persist=persist, **rates))
    ref = jfaults.FaultInjector(JFaultSpec(seed=seed, persist=persist,
                                           **rates))
    raw = bytes(range(256)) * 16
    kinds = {"data": 0, "error": 0}
    for key in ("indptr", "indices", "features", "labels"):
        for block in range(48):
            for attempt in range(3):
                for kind in ("stall", "eio", "short", "flip"):
                    assert port_faults._roll(seed, key, block, attempt,
                                             kind) \
                        == jfaults._roll(seed, key, block, attempt, kind)
                got = _outcome(port, raw, key, block, attempt)
                assert got == _outcome(ref, raw, key, block, attempt), \
                    (key, block, attempt)
                kinds[got[0]] += 1
                if attempt and not persist:
                    assert got == ("data", raw)
    assert kinds["data"] and kinds["error"]


# ---------------------------------------------------------------------------
# DiskStore under faults
# ---------------------------------------------------------------------------

def _read_all(store, g):
    ids = np.arange(0, g.num_nodes, 3)
    return (store.gather_features(ids), store.neighbors(5),
            store.gather_edges(np.arange(40), np.zeros(40, np.int64)),
            store.gather_labels(ids),
            store.gather_edge_blocks(np.arange(0, 40, 3), 64))


def test_fault_mix_store_equals_reference_and_clean(reddit, store_dir):
    retry = dict(max_attempts=3, backoff_s=0.0005)
    clean = DiskStore(store_dir)
    port = DiskStore(store_dir, verify=True, io_threads=1,
                     retry=RetrySpec(**retry), faults=FaultSpec(**MIX))
    ref = JDiskStore(store_dir, verify=True, io_threads=1,
                     retry=JRetrySpec(**retry), faults=JFaultSpec(**MIX))
    try:
        want = _read_all(clean, reddit[1])
        for store in (port, ref):
            for a, b in zip(_read_all(store, reddit[1]), want):
                np.testing.assert_array_equal(np.asarray(a), b)
        p, r = port.io_counters(), ref.io_counters()
        for k in DETERMINISTIC:
            assert p[k] == r[k] > 0, (k, p, r)
        assert p["retries"] > 0
        assert clean.io_counters()["retries"] == 0
        assert port.stats()["direct_io"] is False
    finally:
        for s in (clean, port, ref):
            s.close()


def test_persistent_eio_exhausts_retries(store_dir):
    st = DiskStore(store_dir, retry=RetrySpec(max_attempts=2, backoff_s=0.0),
                   faults=FaultSpec(seed=0, eio_rate=1.0, persist=True))
    try:
        with pytest.raises(StoreReadError, match="read failed after 2"):
            st.gather_features(np.arange(4))
        io = st.io_counters()
        assert io["io_errors"] >= 2 and io["retries"] >= 1
    finally:
        st.close()


def test_deadline_overrun_counts_timeouts(store_dir):
    clean = DiskStore(store_dir)
    st = DiskStore(store_dir, retry=RetrySpec(max_attempts=3, backoff_s=0.0,
                                              deadline_s=0.005),
                   faults=FaultSpec(seed=1, stall_rate=1.0, stall_s=0.02))
    try:
        ids = np.arange(4)
        np.testing.assert_array_equal(st.gather_features(ids),
                                      clean.gather_features(ids))
        assert st.io_counters()["timeouts"] > 0
    finally:
        st.close()
        clean.close()


def test_bitflip_without_verify_is_refused(store_dir):
    with pytest.raises(ValueError, match="verify"):
        DiskStore(store_dir, faults=FaultSpec(bitflip_rate=0.1))
    with pytest.raises(ValueError, match="verify"):
        StoreSpec(kind="disk", faults=FaultSpec(bitflip_rate=0.1))


# ---------------------------------------------------------------------------
# direct I/O
# ---------------------------------------------------------------------------

def test_direct_io_mode_agrees_with_reference(reddit, store_dir):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        port = DiskStore(store_dir, direct_io=True, io_threads=2)
        ref = JDiskStore(store_dir, direct_io=True, io_threads=2)
    try:
        assert port.stats()["direct_io"] == ref.stats()["direct_io"]
        msgs = [str(x.message) for x in w if "direct_io" in str(x.message)]
        assert len(msgs) in (0, 2) and msgs[:1] == msgs[1:]
        for a, b in zip(_read_all(port, reddit[1]), _read_all(ref,
                                                              reddit[1])):
            np.testing.assert_array_equal(a, b)
    finally:
        port.close()
        ref.close()


def test_direct_io_unaligned_block_reads_buffered(reddit, tmp_path):
    save_graph(reddit[1], str(tmp_path), block_bytes=1000)
    with pytest.warns(UserWarning, match="not 512-byte aligned"):
        st = DiskStore(str(tmp_path), direct_io=True)
    try:
        assert st.stats()["direct_io"] is False
        ids = np.arange(30)
        np.testing.assert_array_equal(st.gather_features(ids),
                                      reddit[1].features[ids])
    finally:
        st.close()


def test_direct_io_refused_mid_run_degrades(reddit, store_dir):
    """A read refused with EINVAL after the open goes through
    ``_degrade_direct``: one warning, buffered reads from then on, the
    same bytes; the reference's store words it the same.  The port keeps
    the refused fds open until ``close()``, where a racing pread may
    still hold one."""
    msgs = []
    for cls in (DiskStore, JDiskStore):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            st = cls(store_dir, direct_io=True)
        st.direct_io = True             # as if the probe had passed
        old_fds = list(st._fd.values())

        def refuse(key, block):
            raise OSError(errno.EINVAL, "Invalid argument")

        st._read_block_direct = refuse
        try:
            with pytest.warns(UserWarning, match="refused mid-run") as w:
                rows = st.gather_features(np.arange(20))
            np.testing.assert_array_equal(rows, reddit[1].features[:20])
            assert st.stats()["direct_io"] is False
            msgs.append([str(x.message) for x in w])
            if cls is DiskStore:
                assert st._retired_fds == old_fds
                for fd in old_fds:
                    os.fstat(fd)                # still open
        finally:
            st.close()
        if cls is DiskStore:
            assert st._retired_fds == []
            for fd in old_fds:
                with pytest.raises(OSError):
                    os.fstat(fd)
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the scheduled lane stall
# ---------------------------------------------------------------------------

class _Staged:
    """Two-stage loader stub."""

    backend = "staged"
    fanouts = FANOUTS

    def __init__(self):
        self.resets = 0

    def pipeline_stages(self):
        return [("sample", lambda i: {"idx": i}),
                ("emit", lambda s: dict(s, val=2 * s["idx"]))]

    def get_batch(self, idx):
        return {"idx": idx, "val": 2 * idx}

    def reset_staged_state(self):
        self.resets += 1

    def stats(self):
        return {"backend": self.backend}

    def close(self):
        pass


def test_stall_inject_fires_once_and_the_watchdog_restarts():
    inner = _Staged()
    ov = OverlappedLoader(inner, depth=2, stage_depth=2, lane_timeout=0.3,
                          max_lane_restarts=3, stall_inject=(2, 1.2))
    try:
        t0 = time.perf_counter()
        with pytest.warns(UserWarning, match="missed their heartbeat"):
            for i in range(5):
                assert ov.get_batch(i, timeout=WAIT)["val"] == 2 * i
        assert time.perf_counter() - t0 < 10.0
        s = ov.stats()
        assert s["lane_stall_restarts"] == 1        # one shot, replay clean
        assert not s["degraded"] and inner.resets == 1
    finally:
        ov.close()


def test_lane_restart_reset_raises_device_errors():
    """The watchdog's cache reset raises its error at the consumer, on
    every device (the reference warns and goes on): on a GPU the reset
    synchronizes the device, so its error may be a device fault."""
    class _Broken(_Staged):
        def reset_staged_state(self):
            raise RuntimeError("CUDA error: an illegal memory access")

    ov = OverlappedLoader(_Broken(), lane_timeout=10.0)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")      # and no warning instead
            with pytest.raises(RuntimeError, match="CUDA error"):
                ov._reset_inner()
    finally:
        ov.close()


def test_chaos_spec_equals_fault_free_twin(reddit):
    """``smoke_pallas_overlap_faults.json`` (faults, verify, a 2.5 s
    sample-lane stall at batch 4 against a 1 s lane timeout) gives the
    batches of ``smoke_pallas_overlap.json`` as the reference runs it."""
    twin = ref_config.PipelineSpec.load(str(SPECS /
                                            "smoke_pallas_overlap.json"))
    spec = PipelineSpec.load(str(SPECS / "smoke_pallas_overlap_faults.json"))
    assert spec.store.faults.lane_stall == (4, 2.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_config.build_pipeline(twin, reddit[0])
        port = build_pipeline(spec, reddit[1], device="cpu")
    try:
        assert "faults=injected" in port.describe()
        faults = dict.fromkeys(DETERMINISTIC, 0)
        # the consumer takes the batches at once, so it waits on the
        # stalled lane longer than the lane timeout
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = [port.get_batch(i, timeout=WAIT) for i in range(6)]
            for i, mb in enumerate(got):
                _assert_batch_equal(mb, ref.get_batch(i), i)
                for k in faults:
                    faults[k] += mb.trace.io["faults"][k]
        s = port.stats()
        assert s["lane_stall_restarts"] >= 1 and not s["degraded"]
        assert sum(faults.values()) > 0, faults
    finally:
        ref.close()
        port.close()


# ---------------------------------------------------------------------------
# the out-of-core loader under faults, and the device-cache bypass
# ---------------------------------------------------------------------------

def _spec(config, store_dir, *, faults=None, overlap=False):
    """The reference's ``tests/test_faults.py`` configuration, in the
    package ``config``."""
    tiers = (config.CacheTierSpec(tier="host", capacity_mb=2.0, arrays=()),
             config.CacheTierSpec.device(rows=48, policy="lru"))
    return config.PipelineSpec(
        backend=config.BackendSpec(name="pallas"),
        sampler=config.SamplerSpec(fanouts=FANOUTS),
        store=config.StoreSpec(
            kind="disk", path=store_dir, io_threads=2,
            verify=faults is not None,
            retry=config.RetrySpec(max_attempts=3, backoff_s=0.0005),
            faults=faults),
        cache_tiers=tiers,
        prefetch=(config.PrefetchSpec(depth=2, overlap=True, stage_depth=2,
                                      lane_timeout_s=10.0)
                  if overlap else config.PrefetchSpec()),
        batch_size=BATCH, seed=0)


def _assert_batch_equal(got, want, idx):
    for x, y in zip(got.hop_ids + got.hop_feats + [got.labels],
                    want.hop_ids + want.hop_feats + [want.labels]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=f"batch {idx}")


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sync", "overlapped"])
def test_loader_under_faults_equals_reference_fault_free(reddit, store_dir,
                                                         overlap):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_config.build_pipeline(_spec(ref_config, store_dir),
                                        reddit[0])
    port = build_pipeline(_spec(port_config, store_dir,
                                faults=FaultSpec(**MIX), overlap=overlap),
                          reddit[1], device="cpu")
    try:
        total = dict.fromkeys(("retries",) + DETERMINISTIC, 0)
        for i in range(4):
            got = port.get_batch(i)
            _assert_batch_equal(got, ref.get_batch(i), i)
            for k in total:
                total[k] += got.trace.io["faults"][k]
            assert "devcache" in got.trace.io
        assert total["retries"] > 0 and total["io_errors"] > 0, total
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sync", "overlapped"])
def test_devcache_bypass_keeps_the_batches(reddit, store_dir, overlap):
    """A feature-cache fetch failing past the retry policy trips the
    one-strike bypass (the reference's warning), after which batches come
    through direct store reads with the reference's values.  Overlapped,
    the fetch of batch 2 fails while earlier plans may still be in
    flight."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        clean = ref_config.build_pipeline(_spec(ref_config, store_dir),
                                          reddit[0])
        jbroken = ref_config.build_pipeline(_spec(ref_config, store_dir),
                                            reddit[0])
    port = build_pipeline(_spec(port_config, store_dir, overlap=overlap),
                          reddit[1], device="cpu")
    loader = port.loader.inner if overlap else port.loader
    fetch, calls = loader.devcache.fetch_plan, []
    lock = threading.Lock()

    def failing(plan):
        with lock:
            calls.append(1)
            n = len(calls)
        if n > (2 if overlap else 0):
            raise StoreReadError("injected persistent failure")
        return fetch(plan)

    def jfailing(plan):
        raise JStoreReadError("injected persistent failure")

    loader.devcache.fetch_plan = failing
    jbroken.loader.devcache.fetch_plan = jfailing
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            jbroken.get_batch(0)
            got = [port.get_batch(i) for i in range(5)]
        msgs = [str(x.message) for x in w
                if "bypassing the cache" in str(x.message)]
        assert len(msgs) == 2 and msgs[0] == msgs[1], msgs
        for i, mb in enumerate(got):
            _assert_batch_equal(mb, clean.get_batch(i), i)
            assert ("devcache_bypass" in mb.trace.io) \
                != ("devcache" in mb.trace.io)
        assert got[-1].trace.io["devcache_bypass"] is True
        if not overlap:
            assert all(mb.trace.io.get("devcache_bypass") for mb in got)
        s = port.stats()
        assert s["devcache_bypass"] is True
        assert s["devcache_bypass_events"] == 1
        assert s["devcache_bypass_events"] \
            == jbroken.stats()["devcache_bypass_events"]
    finally:
        for p in (clean, jbroken, port):
            p.close()
