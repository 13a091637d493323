"""The port's asynchronous data plane (``repro_torch.core.pipeline``) and
the thread safety of its kernel layer, on the CPU.

* Lane mechanics over a staged stub loader, as the reference's
  ``tests/test_overlap.py`` and ``tests/test_faults.py`` check them:
  ordering, lanes running concurrently, an error propagating and the
  recovery after it, restart on a jump, clean shutdown with stages in
  flight, the stall watchdog's restart and the degrade past
  ``max_lane_restarts``; and ``PrefetchingLoader``'s.
* ``smoke_pallas_overlap.json``: the overlapped pipeline's batches equal
  the port's synchronous run's and the reference's overlapped run's (ids,
  features, labels, the per-batch counters that the lanes' interleaving
  over the shared page cache cannot move, and each batch's kernel
  launches), and a 4-step fp32 loss trajectory equals the synchronous
  run's and agrees with the reference's within 1e-5.
* ``DiskStore.warm_nodes`` bills the planner context, never a batch, as
  the reference's does.
* The kernel layer from several threads: one compile per source when two
  threads build at once (``nvcc`` replaced by a stub), and no launch
  count lost by 8 threads counting at once.
"""

import os
import sys
import threading
import time
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.config as ref_config
import repro.core.gnn as jgnn
from repro.core import build_train_step as jbuild_train_step
from repro.core import load_dataset as jload_dataset
from repro.core import train_loop as jtrain_loop
from repro.optim import adamw as jadamw
from repro.storage import DiskStore as JDiskStore
from repro_torch import kernels
from repro_torch.convert import params_from_jax
from repro_torch.core import (GNNConfig, GraphSAGE, OverlappedLoader,
                              PipelineSpec, PrefetchingLoader, PrefetchSpec,
                              build_pipeline, build_train_step, load_dataset,
                              train_loop)
from repro_torch.core import pipeline as port_pipeline
from repro_torch.kernels import _build, ops
from repro_torch.optim import adamw
from repro_torch.storage import DiskStore, save_graph
from repro_torch.storage.devcache import _to_device

SPEC = str(Path(__file__).resolve().parent.parent / "benchmarks" / "specs"
           / "smoke_pallas_overlap.json")
WAIT = 20.0             # every get_batch here waits at most this long


# ---------------------------------------------------------------------------
# lane mechanics over a staged stub
# ---------------------------------------------------------------------------

class _Staged:
    """Three-stage loader stub: records which thread ran which stage, can
    fail, delay or hang a stage at a batch, counts resets."""

    backend = "staged"
    fanouts = (3, 2)

    def __init__(self, fail_stage=None, fail_at=None, delay_s=0.0,
                 hang_stage=None, hang_at=None, hang_s=1.5):
        self.calls = {"sample": [], "resolve": [], "admit": []}
        self.threads = {"sample": set(), "resolve": set(), "admit": set()}
        self.fail_stage, self.fail_at = fail_stage, fail_at
        self.delay_s = delay_s
        self.hang_stage, self.hang_at = hang_stage, hang_at
        self.hang_s = hang_s
        self.hung = False
        self.resets = 0
        self.closed = False

    def pipeline_stages(self):
        return [("sample", self._sample), ("resolve", self._resolve),
                ("admit", self._admit)]

    def _run(self, stage, idx):
        if self.fail_stage == stage and idx == self.fail_at:
            raise RuntimeError(f"boom in {stage} at {idx}")
        if self.hang_stage == stage and (self.hang_at is None
                                         or idx == self.hang_at) \
                and not self.hung \
                and threading.current_thread().name.startswith("overlap-"):
            self.hung = self.hang_at is not None   # None: hang every time
            time.sleep(self.hang_s)
        if self.delay_s:
            time.sleep(self.delay_s)
        self.calls[stage].append(idx)
        self.threads[stage].add(threading.get_ident())

    def _sample(self, idx):
        self._run("sample", idx)
        return {"idx": idx}

    def _resolve(self, payload):
        self._run("resolve", payload["idx"])
        return payload

    def _admit(self, payload):
        self._run("admit", payload["idx"])
        return dict(payload, val=2 * payload["idx"])

    def get_batch(self, idx):
        return self._admit(self._resolve(self._sample(idx)))

    def reset_staged_state(self):
        self.resets += 1

    def stats(self):
        return {"backend": self.backend}

    def close(self):
        self.closed = True


def test_lanes_keep_order_each_on_its_own_thread():
    inner = _Staged()
    ov = OverlappedLoader(inner, depth=2, stage_depth=2)
    try:
        for i in range(6):
            assert ov.get_batch(i, timeout=WAIT)["val"] == 2 * i
        me = threading.get_ident()
        lanes = set()
        for stage in ("sample", "resolve", "admit"):
            assert me not in inner.threads[stage]
            assert len(inner.threads[stage]) == 1
            lanes |= inner.threads[stage]
            assert inner.calls[stage][:6] == list(range(6))
        assert len(lanes) == 3
        s = ov.stats()
        assert s["stages"] == ["sample", "resolve", "admit"]
        assert s["prefetched"] == 6 and s["prefetch_restarts"] == 0
    finally:
        ov.close()
    assert inner.closed


def test_lanes_run_concurrently():
    delay, n = 0.03, 8
    ov = OverlappedLoader(_Staged(delay_s=delay), depth=2, stage_depth=2)
    try:
        t0 = time.perf_counter()
        for i in range(n):
            ov.get_batch(i, timeout=WAIT)
        wall = time.perf_counter() - t0
        assert wall < 0.8 * 3 * n * delay, f"no overlap: {wall:.3f}s"
        s = ov.stats()
        assert all(s["stage_s"][k] > 0 for k in ("sample", "resolve",
                                                 "admit"))
        assert s["overlap_factor"] > 1.2
    finally:
        ov.close()


@pytest.mark.parametrize("stage", ["sample", "resolve", "admit"])
def test_lane_error_propagates_promptly_then_recovers(stage):
    inner = _Staged(fail_stage=stage, fail_at=2)
    ov = OverlappedLoader(inner, depth=2, stage_depth=2, lane_timeout=10.0)
    try:
        assert ov.get_batch(0, timeout=WAIT)["idx"] == 0
        assert ov.get_batch(1, timeout=WAIT)["idx"] == 1
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match=f"boom in {stage} at 2"):
            ov.get_batch(2, timeout=WAIT)
        assert time.perf_counter() - t0 < 5.0
        assert ov.get_batch(3, timeout=WAIT)["idx"] == 3    # clean restart
        s = ov.stats()
        assert s["lane_failures"] == 1 and s["prefetch_restarts"] == 1
        assert inner.resets == 1
    finally:
        ov.close()


def test_restart_on_a_jump():
    inner = _Staged()
    ov = OverlappedLoader(inner, depth=2)
    try:
        assert ov.get_batch(0, timeout=WAIT)["idx"] == 0
        assert ov.get_batch(50, timeout=WAIT)["idx"] == 50
        assert ov.get_batch(51, timeout=WAIT)["idx"] == 51
        assert ov.stats()["prefetch_restarts"] == 1
        assert 30 not in inner.calls["sample"]
    finally:
        ov.close()


def test_clean_shutdown_with_stages_in_flight():
    inner = _Staged(delay_s=0.02)
    ov = OverlappedLoader(inner, depth=4, stage_depth=2)
    ov.get_batch(0, timeout=WAIT)
    threads = list(ov._threads)
    t0 = time.perf_counter()
    ov.close()
    assert time.perf_counter() - t0 < 5.0
    assert inner.closed and not ov._threads
    assert not any(t.is_alive() for t in threads)


def test_single_produce_stage_without_pipeline_stages():
    class _Plain:
        backend, fanouts = "plain", (3, 2)

        def get_batch(self, idx):
            return idx * 10

        def stats(self):
            return {}

        def close(self):
            pass

    ov = OverlappedLoader(_Plain(), depth=2)
    try:
        assert [ov.get_batch(i, timeout=WAIT) for i in range(4)] == \
            [0, 10, 20, 30]
        assert ov.stats()["stages"] == ["produce"]
    finally:
        ov.close()


def test_watchdog_restarts_a_stalled_lane_and_replays():
    inner = _Staged(hang_stage="sample", hang_at=2, hang_s=1.5)
    ov = OverlappedLoader(inner, depth=2, stage_depth=2, lane_timeout=0.3,
                          max_lane_restarts=3)
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for i in range(5):
                assert ov.get_batch(i, timeout=WAIT)["val"] == 2 * i
        assert any("missed their heartbeat" in str(x.message) for x in w)
        s = ov.stats()
        assert s["lane_stall_restarts"] >= 1 and not s["degraded"]
        assert inner.resets == s["prefetch_restarts"] >= 1
    finally:
        ov.close()


def test_degrades_loudly_past_the_restart_budget():
    inner = _Staged(hang_stage="admit", hang_at=None, hang_s=2.0)
    ov = OverlappedLoader(inner, depth=2, stage_depth=2, lane_timeout=0.3,
                          max_lane_restarts=1)
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for i in range(4):
                assert ov.get_batch(i, timeout=WAIT)["val"] == 2 * i
        assert any("degrading permanently" in str(x.message) for x in w)
        s = ov.stats()
        assert s["degraded"] and s["lane_stall_restarts"] >= 2
        assert inner.resets >= 2            # the restart and the degrade
        me = threading.get_ident()
        assert me in inner.threads["admit"]     # sync composition
    finally:
        ov.close()


def test_prefetch_keeps_order_restarts_and_propagates():
    inner = _Staged(fail_stage="resolve", fail_at=3)
    pf = PrefetchingLoader(inner, depth=2)
    try:
        assert [pf.get_batch(i, timeout=WAIT)["val"] for i in range(3)] == \
            [0, 2, 4]
        assert threading.get_ident() not in inner.threads["sample"]
        with pytest.raises(RuntimeError, match="boom in resolve at 3"):
            pf.get_batch(3, timeout=WAIT)
        assert pf.get_batch(10, timeout=WAIT)["val"] == 20
        s = pf.stats()
        assert s["prefetched"] == 4 and s["prefetch_restarts"] == 1
    finally:
        pf.close()
    assert inner.closed


def test_cpu_hand_offs_are_no_ops():
    payload = {"a": [torch.ones(2), (np.zeros(1), torch.zeros(1))],
               "b": PrefetchSpec()}
    assert [t.shape for t in port_pipeline._tensors(payload)] == \
        [(2,), (1,)]
    assert port_pipeline._mark(None) is None
    port_pipeline._receive(payload, None, None)
    assert port_pipeline._cuda_device(_Staged()) is None
    arr = np.arange(5, dtype=np.int32)
    t = _to_device(arr, "cpu")
    assert t.device.type == "cpu" and t.tolist() == list(range(5))


# ---------------------------------------------------------------------------
# the overlap spec against the synchronous path and the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reddit():
    return jload_dataset("reddit"), load_dataset("reddit")


def _io_fixed(io):
    """The per-batch counters the lanes' interleaving cannot move: the
    device caches' (planned serially in batch order), the faults', the
    store's requests and the blocks they touched (whether a block read
    hits the shared page cache depends on which lane reached it first)."""
    return {"devcache": io["devcache"], "edgecache": io["edgecache"],
            "faults": io["faults"], "requests": io["requests"],
            "blocks_touched": io["hits"] + io["misses"]}


@pytest.fixture
def counted(monkeypatch):
    """The four GNN kernel wrappers, counting as their CUDA versions do
    (the plain CPU path counts nothing)."""
    for name in ("neighbor_sample", "neighbor_sample_cached",
                 "feature_gather_rows", "feature_gather_cached"):
        real = getattr(ops, name)

        def wrap(*a, _real=real, _name=name, **kw):
            kernels.count_launch(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, wrap)


def test_overlap_spec_batches_equal_sync_and_reference(reddit, counted):
    spec = PipelineSpec.load(SPEC)
    assert spec.prefetch.overlap and spec.prefetch.plan_ahead == 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_config.build_pipeline(ref_config.PipelineSpec.load(SPEC),
                                        reddit[0])
    over = build_pipeline(spec, reddit[1], device="cpu")
    sync = build_pipeline(spec.replace(prefetch=PrefetchSpec()), reddit[1],
                          device="cpu")
    try:
        assert isinstance(over.loader, OverlappedLoader)
        mine = kernels.thread_launches()
        got = [over.get_batch(i, timeout=WAIT) for i in range(4)]
        consumer = kernels.thread_launches()
        assert consumer == mine                 # launched from the lanes
        for i, b in enumerate(got):
            a, w = sync.get_batch(i), ref.get_batch(i)
            for x, y, z in zip(b.hop_ids + b.hop_feats + [b.labels],
                               a.hop_ids + a.hop_feats + [a.labels],
                               w.hop_ids + w.hop_feats + [w.labels]):
                assert torch.equal(x, y), f"batch {i}"
                np.testing.assert_array_equal(x.numpy(), np.asarray(z))
            assert _io_fixed(b.trace.io) == _io_fixed(a.trace.io) \
                == _io_fixed(w.trace.io), f"batch {i}"
            assert b.launches == a.launches, f"batch {i}"
            assert b.launches["neighbor_sample_cached"] > 0
            assert b.launches["feature_gather_cached"] > 0
        s = over.stats()
        assert s["plan_ahead"] == 2 and s["planner_warm_ranges"] > 0
        assert s["store"]["planner"]["warmed_nodes"] >= 4 * spec.batch_size
        assert s["prefetch_restarts"] == 0 and not s["degraded"]
        assert s["stage_s"]["sample"] > 0
    finally:
        ref.close()
        over.close()
        sync.close()


def test_overlap_spec_losses_equal_sync_and_match_reference(reddit,
                                                            monkeypatch):
    monkeypatch.setattr(jgnn, "COMPUTE_DTYPE", jnp.float32)
    g = reddit[1]
    kw = dict(feat_dim=g.feat_dim, hidden=16,
              n_classes=int(g.labels.max()) + 1, fanouts=(3, 2))
    jmodel = jgnn.GraphSAGE(jgnn.GNNConfig(**kw))
    params = jmodel.init(jax.random.key(0))
    init = jax.device_get(params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_config.build_pipeline(ref_config.PipelineSpec.load(SPEC),
                                        reddit[0])
    want = []
    try:
        jopt = jadamw(1e-2)
        jstate = {"params": params, "opt": jopt.init(params),
                  "step": jnp.zeros((), jnp.int32)}
        jtrain_loop(ref, jbuild_train_step(ref, jmodel, jopt), jstate,
                    steps=4,
                    on_step=lambda i, s, m: want.append(float(m["loss"])))
    finally:
        ref.close()

    spec = PipelineSpec.load(SPEC)
    runs = {}
    for mode, s in (("overlap", spec),
                    ("sync", spec.replace(prefetch=PrefetchSpec()))):
        pipe = build_pipeline(s, g, device="cpu")
        try:
            model = GraphSAGE(GNNConfig(**kw), device="cpu",
                              compute_dtype=torch.float32)
            model.load_state_dict(params_from_jax(init))
            opt = adamw(1e-2)
            state = {"opt": opt.init(dict(model.named_parameters())),
                     "step": 0}
            out = runs[mode] = []
            train_loop(pipe, build_train_step(pipe, model, opt), state,
                       steps=4,
                       on_step=lambda i, s, m: out.append(float(m["loss"])))
        finally:
            pipe.close()
    assert runs["overlap"] == runs["sync"]
    np.testing.assert_allclose(runs["overlap"], want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the frontier planner's reads
# ---------------------------------------------------------------------------

def test_warm_nodes_bills_only_the_planner(reddit, tmp_path):
    g = reddit[1]
    save_graph(g, str(tmp_path))
    nodes = np.random.default_rng(0).integers(0, g.num_nodes, 40)
    stats = []
    for cls in (DiskStore, JDiskStore):
        st = cls(str(tmp_path), cache_mb=64.0, io_threads=4)
        ctx = st.make_io_context()
        with st.io_attribution(ctx):
            n = st.warm_nodes(nodes)
        assert n > 0
        deadline = time.perf_counter() + WAIT   # the pool reads them async
        while st.stats()["planner"]["requests"] < n \
                and time.perf_counter() < deadline:
            time.sleep(0.01)
        s = st.stats()
        st.close()
        assert not any(ctx.counters().values())
        assert s["planner"]["requests"] == n
        assert s["planner"]["warmed_nodes"] == np.unique(nodes).size
        assert s["requests"] == n       # the store's totals count them too
        stats.append((n, s["planner"]))
    assert stats[0] == stats[1]
    serial = DiskStore(str(tmp_path), cache_mb=64.0)
    try:
        assert serial.warm_nodes(nodes) == 0    # no pool: nothing to do
    finally:
        serial.close()


# ---------------------------------------------------------------------------
# the kernel layer from several threads
# ---------------------------------------------------------------------------

def test_concurrent_first_builds_run_one_compile(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(log)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
        "time.sleep(0.5)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n")
    stub.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    names = ("neighbor_sample", "feature_gather")
    results, errors = [], []

    def first_use():
        try:
            results.append(_build.build(names))
        except Exception as e:          # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    compiled = log.read_text().split()
    assert sorted(os.path.basename(c) for c in compiled) == \
        ["feature_gather.cu", "neighbor_sample.cu"]
    assert sorted(len(r) for r in results) == [0, 2]
    for n in names:
        assert _build.lib_path(n).read_text() == "lib"
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_launch_counts_lose_nothing_across_threads():
    kernels.reset_launches()
    n_threads, per = 8, 10_000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    mine = []
    try:
        def bump():
            for _ in range(per):
                kernels.count_launch("feature_gather_cached")
            mine.append(kernels.thread_launches()["feature_gather_cached"])

        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert kernels.LAUNCHES["feature_gather_cached"] == n_threads * per
    assert mine == [per] * n_threads
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())
