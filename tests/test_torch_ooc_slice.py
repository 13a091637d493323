"""The out-of-core slice as a whole against the reference's ``pallas``
backend over a ``DiskStore``: reddit, batch 8, fanouts (3, 2), seed 0,
a 0.25 MB page cache, and device caches small enough that the feature
cache splits every batch into segments and the edge-block cache splits
hops into chunks.

For each cache configuration the minibatches (hop ids, features, labels)
and every per-batch ``trace.io`` counter (store, devcache, edgecache) are
bit-equal to the reference's ``build_pipeline``, and the ids equal the
port's own in-memory loader's; the cached kernels launch at each planned
chunk's and segment's own length, where the reference pads.  A 4-step fp32 loss trajectory matches
within 1e-5, and the CLI trains out of core on the CPU and rejects
invalid flag combinations.
"""

import json
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.gnn as jgnn
from repro.core import (BackendSpec, CacheTierSpec, PipelineSpec,
                        SamplerSpec, StoreSpec, build_pipeline)
from repro.core import build_train_step as jbuild_train_step
from repro.core import load_dataset as jload_dataset
from repro.core import train_loop as jtrain_loop
from repro.optim import adamw as jadamw
from repro_torch.convert import params_from_jax
from repro_torch.core import (GNNConfig, GraphSAGE, PallasSubgraphLoader,
                              build_train_step, load_dataset, train_loop)
from repro_torch.core import config as port_config
from repro_torch.launch import train as port_train
from repro_torch.optim import adamw
from repro_torch.kernels import ops
from repro_torch.storage import (DeviceEdgeBlockCache, DeviceFeatureCache,
                                 DiskStore, save_graph)

BATCH, FANOUTS, SEED, CACHE_MB = 8, (3, 2), 0, 0.25

# name -> (feature rows, edge blocks, device policy, host policy)
CONFIGS = {
    "features-lru": (24, 0, "lru", "lru"),
    "features-pinned": (24, 0, "pinned", "lru"),
    "edges16-lru": (0, 16, "lru", "lru"),
    "edges16-pinned": (0, 16, "pinned", "pinned"),
    "edges6-lru": (0, 6, "lru", "lru"),
    "both-lru": (24, 16, "lru", "lru"),
    "both-pinned": (24, 16, "pinned", "pinned"),
}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    jg, g = jload_dataset("reddit"), load_dataset("reddit")
    port_dir = str(tmp_path_factory.mktemp("port-store"))
    save_graph(g, port_dir)
    return jg, g, port_dir


def _pipelines(graphs, tmp_path, config):
    """(reference pipeline, port loader, port store) for ``config``."""
    jg, g, port_dir = graphs
    rows, blocks, policy, host_policy = CONFIGS[config]
    spec = PipelineSpec(
        backend=BackendSpec(name="pallas"),
        sampler=SamplerSpec(fanouts=FANOUTS),
        store=StoreSpec(kind="disk", path=str(tmp_path / "ref")),
        cache_tiers=(CacheTierSpec(tier="host", capacity_mb=CACHE_MB,
                                   policy=host_policy, arrays=()),
                     CacheTierSpec.device(rows=rows, edge_blocks=blocks,
                                          policy=policy)),
        batch_size=BATCH, seed=SEED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = build_pipeline(spec, jg)
    store = DiskStore(port_dir, cache_mb=CACHE_MB, policy=host_policy)
    tier = port_config.CacheTierSpec.device(rows=rows, edge_blocks=blocks,
                                            policy=policy)
    port = PallasSubgraphLoader(
        g, batch_size=BATCH, fanouts=FANOUTS, seed=SEED, device="cpu",
        store=store, device_cache=tier, edge_cache=tier)
    return ref, port, store


@pytest.mark.parametrize("config", list(CONFIGS))
def test_minibatches_and_io_counters_bit_equal(graphs, tmp_path, config):
    ref, port, store = _pipelines(graphs, tmp_path, config)
    mem = PallasSubgraphLoader(graphs[1], batch_size=BATCH, fanouts=FANOUTS,
                               seed=SEED, device="cpu")
    try:
        for idx in range(3):
            want, got = ref.get_batch(idx), port.get_batch(idx)
            np.testing.assert_array_equal(got.targets,
                                          np.asarray(want.targets))
            for g_ids, w_ids, m_ids in zip(got.hop_ids, want.hop_ids,
                                           mem.get_batch(idx).hop_ids):
                assert g_ids.dtype == torch.int32
                np.testing.assert_array_equal(g_ids.numpy(),
                                              np.asarray(w_ids))
                np.testing.assert_array_equal(g_ids.numpy(), m_ids.numpy())
            for g_f, w_f in zip(got.hop_feats, want.hop_feats):
                assert g_f.dtype == torch.float32
                np.testing.assert_array_equal(g_f.numpy(), np.asarray(w_f))
            np.testing.assert_array_equal(got.labels.numpy(),
                                          np.asarray(want.labels))
            assert got.trace.io == want.trace.io, f"batch {idx}"
            np.testing.assert_array_equal(got.trace.subgraph_nodes,
                                          want.trace.subgraph_nodes)
        loader = ref.loader
        for fam in ("devcache", "edgecache"):
            cache = getattr(port, fam)
            if cache is None:
                assert getattr(loader, fam) is None
                continue
            np.testing.assert_array_equal(
                cache.table.numpy(), np.asarray(getattr(loader, fam).table))
            np.testing.assert_array_equal(
                cache.slot_of.numpy(),
                np.asarray(getattr(loader, fam).slot_of))
        assert store.io_counters() == ref.store.io_counters()
        d = port.stats()["dispatches"]
        rows, blocks = CONFIGS[config][:2]
        assert (d["feature_segments"] > 3) == bool(rows)   # > 1 per batch
        assert (d["edge_chunks"] > 6) == bool(blocks)      # > 1 per hop
    finally:
        ref.close()
        port.close()
        store.close()


@pytest.mark.parametrize("config", ["both-lru", "both-pinned"])
def test_cached_kernels_launch_at_the_plans_own_lengths(graphs, tmp_path,
                                                        config, monkeypatch):
    """Every ``neighbor_sample_cached`` launch takes its planned chunk's
    targets and every ``feature_gather_cached`` launch its segment's ids,
    unpadded (the reference pads both to powers of two for jit), while
    the minibatches and every ``trace.io`` counter stay equal to the
    reference's."""
    planned = {"chunks": [], "segments": []}
    launched = {"chunks": [], "segments": []}

    def record_plan(fn):
        def plan(self, *a, **kw):
            out = fn(self, *a, **kw)
            planned["chunks"] += [sl.stop - sl.start for sl, _ in out]
            return out
        return plan

    def record_rows(fn):
        def plan_rows(self, *a, **kw):
            out = fn(self, *a, **kw)
            planned["segments"] += [ps.ids.size for ps in out.segments]
            return out
        return plan_rows

    sample, gather = ops.neighbor_sample_cached, ops.feature_gather_cached

    def sample_rec(indptr, cache, block_slots, targets, rand, **kw):
        assert rand.shape[0] == targets.shape[0]
        launched["chunks"].append(targets.shape[0])
        return sample(indptr, cache, block_slots, targets, rand, **kw)

    def gather_rec(cache, slot_of, ids):
        launched["segments"].append(ids.numel())
        return gather(cache, slot_of, ids)

    monkeypatch.setattr(DeviceEdgeBlockCache, "plan",
                        record_plan(DeviceEdgeBlockCache.plan))
    monkeypatch.setattr(DeviceFeatureCache, "plan_rows",
                        record_rows(DeviceFeatureCache.plan_rows))
    monkeypatch.setattr(ops, "neighbor_sample_cached", sample_rec)
    monkeypatch.setattr(ops, "feature_gather_cached", gather_rec)
    ref, port, store = _pipelines(graphs, tmp_path, config)
    try:
        for idx in range(3):
            want, got = ref.get_batch(idx), port.get_batch(idx)
            for g_t, w_t in zip(got.hop_ids + got.hop_feats + [got.labels],
                                want.hop_ids + want.hop_feats
                                + [want.labels]):
                np.testing.assert_array_equal(g_t.numpy(), np.asarray(w_t))
            assert got.trace.io == want.trace.io, f"batch {idx}"
    finally:
        ref.close()
        port.close()
        store.close()
    for kind in ("chunks", "segments"):
        assert launched[kind] == planned[kind] and len(planned[kind]) > 3
        assert any(n & (n - 1) for n in launched[kind]), kind   # unpadded


def test_stats_and_epoch_counters(graphs, tmp_path):
    ref, port, store = _pipelines(graphs, tmp_path, "both-lru")
    try:
        port.get_batch(0)
        port.start_epoch()
        mb = port.get_batch(1)
        s = port.stats()
        assert s["store"]["kind"] == "disk"
        assert s["devcache"]["array"] == "features"
        assert s["edgecache"]["array"] == "topology"
        for fam in ("devcache", "edgecache"):
            epoch = dict(s[f"{fam}_epoch"])
            assert epoch == mb.trace.io[fam]
        assert [n for n, _ in port.pipeline_stages()] == ["sample", "resolve",
                                                          "admit"]
        port.reset_staged_state()
        assert port.devcache.resets == port.edgecache.resets == 1
        np.testing.assert_array_equal(port.get_batch(2).hop_ids[2].numpy(),
                                      np.asarray(ref.get_batch(2).hop_ids[2]))
    finally:
        ref.close()
        store.close()


def test_loss_trajectory_matches_reference_fp32(graphs, tmp_path,
                                                monkeypatch):
    ref, port, store = _pipelines(graphs, tmp_path, "both-pinned")
    monkeypatch.setattr(jgnn, "COMPUTE_DTYPE", jnp.float32)
    g = graphs[1]
    kw = dict(feat_dim=g.feat_dim, hidden=16,
              n_classes=int(g.labels.max()) + 1, fanouts=FANOUTS)
    try:
        jmodel = jgnn.GraphSAGE(jgnn.GNNConfig(**kw))
        jopt = jadamw(1e-2)
        params = jmodel.init(jax.random.key(0))
        init = jax.device_get(params)
        jstate = {"params": params, "opt": jopt.init(params),
                  "step": jnp.zeros((), jnp.int32)}
        want = []
        jtrain_loop(ref, jbuild_train_step(ref, jmodel, jopt), jstate,
                    steps=4,
                    on_step=lambda i, s, m: want.append(float(m["loss"])))
        model = GraphSAGE(GNNConfig(**kw), device="cpu",
                          compute_dtype=torch.float32)
        model.load_state_dict(params_from_jax(init))
        opt = adamw(1e-2)
        state = {"opt": opt.init(dict(model.named_parameters())), "step": 0}
        got = []
        train_loop(port, build_train_step(port, model, opt), state, steps=4,
                   on_step=lambda i, s, m: got.append(float(m["loss"])))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    finally:
        ref.close()
        store.close()


SRC = Path(__file__).resolve().parent.parent / "src"
SMALL = ["--device", "cpu", "--backend", "pallas", "--batch", "8",
         "--fanouts", "3,2", "--hidden", "16", "--log-every", "1", "--steps",
         "2"]


def _cli(args):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True,
                          timeout=300, env=env)


def test_cli_trains_out_of_core_on_cpu_and_cleans_up():
    out = _cli(SMALL + ["--graph-store", "disk", "--cache-mb", "0.25",
                        "--device-cache-rows", "24",
                        "--edge-cache-blocks", "16"])
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("loss=") == 2
    for line in ("device devcache: 24 rows (pinned, 12 pinned)",
                 "device edgecache: 16 blocks (pinned, 8 pinned)",
                 "disk-store I/O:"):
        assert line in out.stdout, line
    path = re.search(r"graph store: disk at (\S+)", out.stdout).group(1)
    assert not os.path.exists(path)            # the run's temp dir is gone


def test_cli_disk_without_device_tier_proceeds_in_memory(tmp_path):
    out = _cli(SMALL + ["--graph-store", "disk", "--store-dir",
                        str(tmp_path / "s")])
    assert out.returncode == 0, out.stderr
    assert "proceeding in-memory" in out.stdout
    assert "disk-store I/O" not in out.stdout
    assert not (tmp_path / "s").exists()


@pytest.mark.parametrize("flags", [["--overlap", "1"],
                                   ["--prefetch", "-1"],
                                   ["--spec", "engine.json"],
                                   ["--fault-eio", "1.5"],
                                   ["--storage-engine", "nvme"],
                                   ["--backend", "isp"],
                                   ["--cache-policy", "optimal"],
                                   ["--device-cache-policy", "optimal"],
                                   ["--device-cache-oracle-window", "4"],
                                   ["--backend", "isp", "--store-mode",
                                    "isp"],
                                   ["--device-cache-pinned-fraction", "2"],
                                   ["--io-retries", "0"]])
def test_cli_rejects_deferred_and_invalid_flags(flags, capsys, tmp_path):
    """Invalid values fail validation: an engine outside ``ENGINES`` (on
    the command line, or in a spec file), a device cache tier on the isp
    backend, the isp backend over the ISP service's store mode,
    ``--overlap 1`` without ``--prefetch``, an ``optimal`` tier without
    its oracle window and a window without ``optimal``."""
    if flags[0] == "--spec":
        spec = tmp_path / flags[1]
        d = port_config.PipelineSpec(
            backend=port_config.BackendSpec(name="pallas"),
            store=port_config.StoreSpec(kind="disk")).to_dict()
        spec.write_text(json.dumps(dict(d, engine="nvme")))
        flags = ["--spec", str(spec)]
    with pytest.raises(SystemExit) as e:
        port_train.parse_args(["--device", "cpu", "--backend", "pallas",
                               "--graph-store", "disk",
                               "--device-cache-rows", "8", *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "error:" in err
    if flags[0] == "--spec":
        assert "engine must be one of" in err


def test_cli_defaults_are_the_references():
    args = port_train.parse_args(["--device", "cpu"])
    assert (args.graph_store, args.cache_mb, args.cache_policy,
            args.device_cache_rows, args.edge_cache_blocks,
            args.device_cache_policy, args.device_cache_pinned_fraction,
            args.verify_blocks, args.io_retries, args.io_retry_backoff,
            args.io_deadline) == ("mem", None, "lru", 0, 0, "pinned", 0.5,
                                  0, 3, 0.005, 30.0)
    assert args.device_tier is None
