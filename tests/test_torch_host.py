"""The host backend of the port (``core.sampler``'s numpy samplers,
``core.pipeline``'s ``make_host_producer`` and
``ProducerConsumerPipeline``, ``core.loader.HostSubgraphLoader``) against
the reference's ``host`` backend on the CPU: reddit, batch 8, fanouts
(3, 2), seed 0.

``sample_khop`` and ``saint_random_walk`` give the reference's ids and
I/O deltas over an in-memory graph and over a ``DiskStore``; the
producer's minibatches equal the reference's; the pipeline consumes in
order, re-issues a straggler, skips past a forward jump and raises a
producer's error at the consumer; a 4-step fp32 loss trajectory matches
within 1e-5; ``smoke_host`` and ``smoke_disk_host`` train through
``build_pipeline``; an ``optimal`` page cache under one worker counts as
the reference's; and the CLI trains with ``--backend host``.
"""

import os
import subprocess
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
from repro.core import make_host_producer as jmake_host_producer
from repro.core import sample_khop as jsample_khop
from repro.core import saint_random_walk as jsaint_random_walk
from repro.core import train_loop as jtrain_loop
from repro.optim import adamw as jadamw
from repro.storage import DiskStore as JDiskStore
from repro.storage import InMemoryStore as JInMemoryStore
from repro_torch.convert import params_from_jax
from repro_torch.core import (GNNConfig, GraphSAGE, PipelineSpec,
                              build_pipeline, build_train_step,
                              load_dataset, train_loop)
from repro_torch.core.loader import HostSubgraphLoader
from repro_torch.core.pipeline import (ProducerConsumerPipeline,
                                       make_host_producer)
from repro_torch.core.sampler import sample_khop, saint_random_walk
from repro_torch.optim import adamw
from repro_torch.storage import DiskStore, InMemoryStore, save_graph

ROOT = Path(__file__).resolve().parent.parent
SPEC_DIR = ROOT / "benchmarks" / "specs"
BATCH, FANOUTS, SEED = 8, (3, 2), 0


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    jg, g = jload_dataset("reddit"), load_dataset("reddit")
    path = str(tmp_path_factory.mktemp("host-store"))
    save_graph(g, path)
    return jg, g, path


def _stores(graphs, kind):
    """(port store, reference store) of ``kind`` over the same graph."""
    jg, g, path = graphs
    if kind == "csr":
        return g, jg
    if kind == "mem":
        return InMemoryStore(g), JInMemoryStore(jg)
    return (DiskStore(path, cache_mb=0.25),
            JDiskStore(path, cache_mb=0.25))


def _close(*stores):
    for s in stores:
        close = getattr(s, "close", None)
        if close is not None:
            close()


# ---------------------------------------------------------------------------
# the numpy samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["csr", "mem", "disk"])
@pytest.mark.parametrize("sampler", ["khop", "saint"])
def test_host_samplers_bit_equal_to_reference(graphs, kind, sampler):
    port, ref = _stores(graphs, kind)
    try:
        for seed in (0, 3, 41):
            t = np.random.default_rng(seed).integers(
                0, graphs[1].num_nodes, BATCH).astype(np.int32)
            if sampler == "khop":
                got = sample_khop(port, t, FANOUTS, seed=seed)
                want = jsample_khop(ref, t, FANOUTS, seed=seed)
            else:
                got = saint_random_walk(port, t, 3, seed=seed)
                want = jsaint_random_walk(ref, t, 3, seed=seed)
            assert len(got.hops) == len(want.hops)
            for a, b in zip(got.hops, want.hops):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(got.touched_nodes,
                                          want.touched_nodes)
            np.testing.assert_array_equal(got.subgraph_nodes,
                                          want.subgraph_nodes)
            assert got.io == want.io
            if kind == "disk":
                assert got.io["requests"] > 0
        if kind == "disk":
            assert port.io_counters() == ref.io_counters()
    finally:
        _close(port, ref)


@pytest.mark.parametrize("kind", ["mem", "disk"])
@pytest.mark.parametrize("sampler", ["khop", "saint"])
def test_host_producer_minibatches_equal_reference(graphs, kind, sampler):
    port, ref = _stores(graphs, kind)
    try:
        kw = dict(seed=SEED, sampler=sampler, walk_length=3)
        produce = make_host_producer(port, BATCH, FANOUTS, **kw)
        jproduce = jmake_host_producer(ref, BATCH, FANOUTS, **kw)
        for idx in range(3):
            got, want = produce(idx), jproduce(idx)
            np.testing.assert_array_equal(got.targets, want.targets)
            for a, b in zip(got.hop_ids + got.hop_feats + [got.labels],
                            want.hop_ids + want.hop_feats + [want.labels]):
                assert a.dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, b)
            assert got.trace.io == want.trace.io, f"batch {idx}"
    finally:
        _close(port, ref)


# ---------------------------------------------------------------------------
# ProducerConsumerPipeline
# ---------------------------------------------------------------------------

def test_pipeline_consumes_in_order_and_is_deterministic(graphs):
    g = graphs[1]
    prod = make_host_producer(g, BATCH, FANOUTS)
    pipe = ProducerConsumerPipeline(prod, n_workers=3, queue_depth=4)
    try:
        got = [pipe.get_batch(i) for i in range(6)]
        for i, b in enumerate(got):
            again = prod(i)
            np.testing.assert_array_equal(b.targets, again.targets)
            np.testing.assert_array_equal(b.hop_feats[2], again.hop_feats[2])
        assert got[0].hop_feats[2].shape == (BATCH, 3, 2, g.feat_dim)
    finally:
        pipe.close()
    assert pipe.stats.consumer_idle_s > 0
    assert len(pipe.stats.produce_times) >= 6


def test_pipeline_reissues_a_straggler():
    calls = {"n": 0}
    lock = threading.Lock()

    def produce(idx):
        with lock:
            calls["n"] += 1
            first = idx == 5 and calls["n"] == 6
        if first:                        # the first attempt at 5 stalls
            time.sleep(0.8)
        return {"idx": idx}

    pipe = ProducerConsumerPipeline(produce, n_workers=3, queue_depth=2,
                                    straggler_factor=2.0)
    try:
        seen = [pipe.get_batch(i, timeout=10.0)["idx"] for i in range(8)]
        assert seen == list(range(8))
        assert pipe.stats.reissued >= 1
    finally:
        pipe.close()


def test_pipeline_jumps_past_unconsumable_indices():
    produced = []

    def produce(idx):
        produced.append(idx)
        return idx

    pipe = ProducerConsumerPipeline(produce, n_workers=2, queue_depth=2)
    try:
        assert pipe.get_batch(0) == 0
        assert pipe.get_batch(10) == 10        # resume-style forward jump
        assert pipe.get_batch(11) == 11
        assert not [k for k in pipe._results if k < 10]
        assert all(i < 2 or i >= 10 for i in produced)
    finally:
        pipe.close()


def test_pipeline_raises_a_producer_error_at_the_consumer():
    def produce(idx):
        if idx == 2:
            raise ValueError("bad batch 2")
        return idx

    pipe = ProducerConsumerPipeline(produce, n_workers=2, queue_depth=4)
    try:
        assert [pipe.get_batch(i) for i in range(2)] == [0, 1]
        t0 = time.perf_counter()
        with pytest.raises(ValueError, match="bad batch 2"):
            pipe.get_batch(2, timeout=20.0)
        assert time.perf_counter() - t0 < 5.0    # promptly, not at timeout
        assert pipe.get_batch(3) == 3
    finally:
        pipe.close()


# ---------------------------------------------------------------------------
# the loader, the specs and the losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mem", "disk"])
def test_host_loss_trajectory_matches_reference(graphs, kind, monkeypatch):
    jg, g, path = graphs
    monkeypatch.setattr(jgnn, "COMPUTE_DTYPE", jnp.float32)
    kw = dict(feat_dim=g.feat_dim, hidden=16,
              n_classes=int(g.labels.max()) + 1, fanouts=FANOUTS)
    spec = PipelineSpec.load(str(SPEC_DIR / (
        "smoke_host.json" if kind == "mem" else "smoke_disk_host.json")))
    jmodel = jgnn.GraphSAGE(jgnn.GNNConfig(**kw))
    params = jmodel.init(jax.random.key(0))
    init = jax.device_get(params)
    ref = ref_config.build_pipeline(
        ref_config.PipelineSpec.from_dict(spec.to_dict()), jg)
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
    pipe = build_pipeline(spec, g, device="cpu")
    try:
        assert isinstance(pipe.loader, HostSubgraphLoader)
        assert (pipe.store is not None) == (kind == "disk")
        model = GraphSAGE(GNNConfig(**kw), device="cpu",
                          compute_dtype=torch.float32)
        model.load_state_dict(params_from_jax(init))
        opt = adamw(1e-2)
        state = {"opt": opt.init(dict(model.named_parameters())), "step": 0}
        got = []
        _, stats = train_loop(
            pipe, build_train_step(pipe, model, opt), state, steps=4,
            on_step=lambda i, s, m: got.append(float(m["loss"])))
        assert stats.steps == 4
        s = pipe.stats()
        assert s["backend"] == "host" and s["duplicates_dropped"] >= 0
    finally:
        pipe.close()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["smoke_host", "smoke_disk_host"])
def test_host_specs_batches_equal_reference(graphs, name):
    """Four producers fill the page cache in an order that varies from
    run to run, so per-batch hits and misses are compared as a sum."""
    jg, g, _ = graphs
    path = str(SPEC_DIR / f"{name}.json")
    ref = ref_config.build_pipeline(ref_config.PipelineSpec.load(path), jg)
    port = build_pipeline(PipelineSpec.load(path), g, device="cpu")
    try:
        assert port.describe() == ref.describe()
        assert port.notes == ref.notes
        for idx in range(3):
            got, want = port.get_batch(idx), ref.get_batch(idx)
            np.testing.assert_array_equal(got.targets, want.targets)
            for a, b in zip(got.hop_ids + got.hop_feats + [got.labels],
                            want.hop_ids + want.hop_feats + [want.labels]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert got.hop_feats[0].dtype == torch.float32
            assert got.labels.dtype == torch.int32
            gi, wi = got.trace.io, want.trace.io
            if wi is None:                      # in memory: no counters
                assert gi is None
                continue
            assert gi["requests"] == wi["requests"]
            assert gi["hits"] + gi["misses"] == wi["hits"] + wi["misses"]
        assert got.launches == {}
    finally:
        port.close()
        ref.close()


def _optimal_host_spec(n_workers, straggler_factor):
    return PipelineSpec.from_dict(dict(
        PipelineSpec.load(str(SPEC_DIR / "smoke_disk_host.json")).to_dict(),
        backend=dict(name="host", n_workers=n_workers, queue_depth=8,
                     straggler_factor=straggler_factor, axis="data"),
        cache_tiers=[dict(tier="host", policy="optimal", capacity_mb=0.25,
                          rows=0, edge_blocks=0, pinned_fraction=0.5,
                          arrays=[], oracle_window=4)]))


@pytest.mark.parametrize("n_workers", [1, 4])
def test_host_optimal_counters_equal_reference(graphs, n_workers):
    """One worker and a straggler factor too large to re-issue make the
    order of ``oracle_advance`` calls fixed, so the counters must equal
    the reference's; under four workers only the values and hits +
    misses are fixed."""
    jg, g, _ = graphs
    spec = _optimal_host_spec(n_workers, 1e6 if n_workers == 1 else 4.0)
    ref = ref_config.build_pipeline(
        ref_config.PipelineSpec.from_dict(spec.to_dict()), jg)
    port = build_pipeline(spec, g, device="cpu")
    lru = build_pipeline(PipelineSpec.load(
        str(SPEC_DIR / "smoke_disk_host.json")).replace(
            backend=spec.backend,
            cache_tiers=(spec.cache_tiers[0].__class__(
                tier="host", policy="lru", capacity_mb=0.25,
                arrays=()),)), g, device="cpu")
    try:
        assert port.store.policy == "optimal"
        for idx in range(8):
            got, want = port.get_batch(idx), ref.get_batch(idx)
            base = lru.get_batch(idx)
            for a, b, c in zip(got.hop_feats + [got.labels],
                               want.hop_feats + [want.labels],
                               base.hop_feats + [base.labels]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                assert torch.equal(a, c)
            # per batch: the producers run ahead of the consumer by a
            # varying number of batches, so the store's totals are not
            # comparable at any one moment
            gi, wi = got.trace.io, want.trace.io
            if n_workers == 1:
                assert gi == wi, f"batch {idx}"
            assert gi["requests"] == wi["requests"]
            assert gi["hits"] + gi["misses"] == wi["hits"] + wi["misses"]
        rep = port.store._oracle_replayer
        stats = rep.stats()
        assert stats["errors"] == 0 and stats["timeouts"] == 0
        assert stats["batches_replayed"] >= 8
        if n_workers == 1:
            assert port.stats()["reissued"] == 0
    finally:
        for pipe in (port, ref, lru):
            pipe.close()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "8", "--hidden", "16", "--log-every",
         "1", *args], capture_output=True, text=True, env=env, timeout=300)


@pytest.mark.parametrize("flags", [
    ["--backend", "host", "--fanouts", "3,2"],
    ["--backend", "host", "--sampler", "saint", "--walk-length", "3",
     "--graph-store", "disk", "--cache-mb", "0.25",
     "--cache-policy", "optimal", "--cache-oracle-window", "4"]])
def test_cli_trains_with_the_host_backend(flags):
    out = _cli(flags)
    assert out.returncode == 0, out.stderr
    assert "backend=host" in out.stdout
    assert out.stdout.count("  step ") == 3
    if "disk" in flags:
        assert "disk-store I/O" in out.stdout
        assert "'errors': 0, 'timeouts': 0" in out.stdout


def test_cli_refuses_saint_on_pallas(capsys):
    from repro_torch.launch import train as port_train
    with pytest.raises(SystemExit) as e:
        port_train.parse_args(["--device", "cpu", "--backend", "pallas",
                               "--sampler", "saint"])
    assert e.value.code == 2
    assert "saint" in capsys.readouterr().err
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        args = port_train.parse_args(["--device", "cpu", "--backend",
                                      "host", "--sampler", "saint"])
    assert args.pipeline_spec.effective_fanouts == (5,)
