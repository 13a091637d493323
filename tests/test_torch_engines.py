"""The port's storage simulator (``repro_torch.storage.engines``,
``storage.e2e``, the trace-replay pieces of ``storage.blockdev``) and the
loaders' cost replay, against the reference's ``repro.storage``.

On reddit --large-scale: each engine's ``BatchCost`` on the same numpy
``sample_khop`` traces equals the reference's field for field (the
stateful page-cache and scratchpad models over a warm-up trace too),
and so do ``throughput``, ``e2e_train``, ``capacity_report``,
``block_trace`` and the ``PinnedCache`` counters.  The device loaders'
simulated delay of a batch equals the reference loader's; with no engine
nothing is paid.  A host run over the disk store with ``engine='mmap'``
pays a delay, and its measured totals equal the store's counters (the
reference's ``MeasuredEngine`` raises there: the trace nests its fault
counters).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import load_dataset as jload_dataset
from repro.core import make_loader as jmake_loader
from repro.core import sample_khop as jsample_khop
from repro.storage import (ENGINES as JENGINES, PinnedCache as JPinnedCache,
                           block_trace as jblock_trace,
                           capacity_report as jcapacity_report,
                           e2e_train as je2e_train,
                           make_engine as jmake_engine,
                           throughput as jthroughput)
from repro_torch.core import load_dataset, make_loader, sample_khop
from repro_torch.core import config as port_config
from repro_torch.launch import train as port_train
from repro_torch.storage import (ENGINES, PinnedCache, block_trace,
                                 capacity_report, e2e_train, make_engine,
                                 throughput)

ROOT = Path(__file__).resolve().parent.parent
BATCH, FANOUTS = 256, (5, 2)


@pytest.fixture(scope="module")
def large():
    return (jload_dataset("reddit", large_scale=True),
            load_dataset("reddit", large_scale=True))


def _traces(sampler, g, n=3):
    rng = np.random.default_rng(0)
    return [sampler(g, rng.integers(0, g.num_nodes, BATCH), FANOUTS,
                    seed=s) for s in range(n)]


def _cost(c) -> dict:
    return dataclasses.asdict(c)


def test_engines_are_the_references():
    assert list(ENGINES) == list(JENGINES)


@pytest.mark.parametrize("name", list(ENGINES))
def test_batch_cost_equals_reference(large, name):
    jg, g = large
    want_traces, traces = _traces(jsample_khop, jg), _traces(sample_khop, g)
    for a, b in zip(traces, want_traces):
        for x, y in zip(a.hops, b.hops):
            np.testing.assert_array_equal(x, y)
    port, ref = make_engine(name, g), jmake_engine(name, jg)
    for a, b in zip(traces, want_traces):          # warm-up, then the cost
        got, want = port.batch_cost(a), ref.batch_cost(b)
        assert _cost(got) == _cost(want)
        assert port.feature_time(a) == ref.feature_time(b)
    assert throughput(got, 12) == jthroughput(want, 12)
    r, w = e2e_train(port, traces[0], workers=12), \
        je2e_train(ref, want_traces[0], workers=12)
    assert dataclasses.asdict(r) == dataclasses.asdict(w)


def test_block_trace_pinned_cache_and_capacity_equal_reference(large):
    jg, g = large
    t = _traces(sample_khop, g, 1)[0].touched_nodes
    got, want = block_trace(g, t), jblock_trace(jg, t)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert got.raw_block_bytes(4096) == want.raw_block_bytes(4096)
    port, ref = PinnedCache(g, 64), JPinnedCache(jg, 64)
    misses = [(port.access_run(int(f), int(n)), ref.access_run(int(f), int(n)))
              for f, n in zip(got.first_block, got.n_blocks)]
    assert [a for a, _ in misses] == [b for _, b in misses]
    assert port.counters() == ref.counters()
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        PinnedCache(g, 8, pinned_budget=9)
    assert capacity_report() == jcapacity_report()


@pytest.mark.parametrize("backend", ["pallas", "isp"])
def test_device_loaders_replay_the_references_cost(large, backend):
    jg, g = large
    kw = dict(batch_size=64, fanouts=FANOUTS, seed=3)
    port = make_loader(backend, g, storage_engine=make_engine("mmap", g),
                       device="cpu", **kw)
    ref = jmake_loader(backend, jg, storage_engine=jmake_engine("mmap", jg),
                       **kw)
    plain = make_loader(backend, g, device="cpu", **kw)
    for idx in range(2):
        got = port.storage_delay(port.storage_cost_trace(idx))
        want = ref.storage_delay(ref.storage_cost_trace(idx))
        assert got == want > 0
    paid = port.stats()["simulated_storage_s"]
    assert paid == ref.stats()["simulated_storage_s"]
    mb, mb0 = port.get_batch(2), plain.get_batch(2)
    assert port.stats()["simulated_storage_s"] > paid
    assert plain.stats()["simulated_storage_s"] == 0.0
    for a, b in zip(mb.hop_ids + mb.hop_feats, mb0.hop_ids + mb0.hop_feats):
        assert np.array_equal(a.numpy(), b.numpy())
    for ld in (port, ref, plain):
        ld.close()


def test_host_disk_mmap_measured_totals_equal_the_store(tmp_path):
    g = load_dataset("reddit")
    spec = port_train.parse_args(
        ["--device", "cpu", "--backend", "host", "--graph-store", "disk",
         "--cache-mb", "0.25", "--storage-engine", "mmap", "--batch", "16",
         "--fanouts", "3,2", "--store-dir", str(tmp_path / "s")]
    ).pipeline_spec
    pipe = port_config.build_pipeline(spec, g, device="cpu")
    try:
        assert "engine=mmap" in pipe.describe()
        for idx in range(4):
            mb = pipe.get_batch(idx)
            assert "faults" in mb.trace.io
        pipe.loader.pipeline.close()        # the producers are done
        assert pipe.stats()["simulated_storage_s"] > 0
        report = pipe.engine.report()
        assert report["engine"] == "measured:mmap"
        assert report["batches"] >= 4
        assert report["measured_totals"] == pipe.store.io_counters()
    finally:
        pipe.close()


def test_isp_vs_mmap_twin_prints_the_references_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = [subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
           for name in ("isp_vs_mmap_torch.py", "isp_vs_mmap.py")]
    for r in out:
        assert r.returncode == 0, r.stderr[-2000:]
    assert out[0].stdout == out[1].stdout
    assert "SSD->host transfer reduction" in out[0].stdout
