"""The port's spec layer (``repro_torch.core.config``) against the
reference's ``repro.core.config``.

Every spec file in ``benchmarks/specs``, the golden file and a checkpoint
manifest's ``pipeline_spec`` load to equal dicts in both packages;
``from_dict`` rejects the same inputs with the same messages; the
generated flags build equal specs from a table of argvs, with and without
``--spec``; the four specs the port runs without overlap give hop ids,
features, labels and every per-batch ``trace.io`` counter bit-equal to the
reference's ``build_pipeline`` over the same spec on reddit; and the six
specs of the later slices (oracle, host backend, telemetry, the ISP
service, the mesh ISP backend) parse and build.  No spec is refused.
"""

import argparse
import glob
import json
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.config as ref_config
from repro import checkpoint as ref_ckpt
from repro.core import load_dataset as jload_dataset
from repro_torch.core import config as port_config
from repro_torch.core import load_dataset, make_loader
from repro_torch.core.loader import _effective_plan_ahead
from repro_torch.launch import train as port_train
from repro_torch.storage import DEFAULT, DiskStore, save_graph

ROOT = Path(__file__).resolve().parent.parent
SPEC_DIR = ROOT / "benchmarks" / "specs"
GOLDEN = ROOT / "tests" / "data" / "golden_pipeline_spec.json"
SPEC_FILES = sorted(Path(p).stem for p in glob.glob(str(SPEC_DIR / "*.json")))
PORTED = ("smoke_pallas", "smoke_pallas_devcache_disk",
          "smoke_pallas_edgecache", "train_pallas_outofcore",
          "smoke_pallas_overlap", "smoke_pallas_overlap_faults",
          "smoke_pallas_optimal", "smoke_host", "smoke_disk_host",
          "smoke_pallas_overlap_obs", "smoke_pallas_isp", "smoke_isp")
#: spec file -> the ROADMAP item it waits on (none: every spec runs)
REFUSED = {}
#: the specs refused before the oracle, the host backend, telemetry, the
#: ISP service and the mesh ISP backend were ported
LATER = ("smoke_host", "smoke_disk_host", "smoke_isp", "smoke_pallas_isp",
         "smoke_pallas_optimal", "smoke_pallas_overlap_obs")


def _path(name: str) -> str:
    return str(SPEC_DIR / f"{name}.json")


def test_spec_files_are_split_between_ported_and_refused():
    assert len(SPEC_FILES) == 12
    assert sorted(PORTED + tuple(REFUSED)) == SPEC_FILES


# ---------------------------------------------------------------------------
# serialization: every file loads to the reference's dict, round-trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", [_path(n) for n in SPEC_FILES]
                         + [str(GOLDEN)], ids=SPEC_FILES + ["golden"])
def test_spec_files_load_equal(path):
    port = port_config.PipelineSpec.load(path)
    ref = ref_config.PipelineSpec.load(path)
    assert port.to_dict() == ref.to_dict()
    with open(path) as f:
        assert json.loads(port.to_json()) == json.load(f)
    assert port_config.PipelineSpec.from_json(port.to_json()) == port
    assert port_config.PipelineSpec.from_dict(port.to_dict()) == port


def test_checkpoint_manifest_spec_loads(tmp_path):
    spec = ref_config.PipelineSpec.load(_path("train_pallas_outofcore"))
    ref_ckpt.save(str(tmp_path), 3, {"w": np.zeros(2, np.float32)},
                  manifest_extra={"pipeline_spec": spec.to_dict()})
    d = ref_ckpt.read_manifest(str(tmp_path))["pipeline_spec"]
    port = port_config.PipelineSpec.from_dict(d)
    assert port.to_dict() == spec.to_dict()
    assert port == port_config.PipelineSpec.load(
        _path("train_pallas_outofcore"))


# ---------------------------------------------------------------------------
# validation: the same inputs fail with the same messages
# ---------------------------------------------------------------------------

def _golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def _tier(d, tier):
    return next(t for t in d["cache_tiers"] if t["tier"] == tier)


#: case -> an edit of the golden spec's dict that makes it invalid
#: (the reference's tests/test_config.py cases and the fields' own checks)
INVALID = {
    "unknown-top-field": lambda d: d.update(cache_mb=4.0),
    "unknown-sampler-field": lambda d: d["sampler"].update(fanout=10),
    "unknown-obs-field": lambda d: d["obs"].update(span_depth=3),
    "unknown-tier-field": lambda d: _tier(d, "device").update(slots=3),
    "unknown-isp-field": lambda d: d["store"].update(
        mode="isp", isp={"transport": "unix", "port": 1}),
    "device-tier-on-host": lambda d: d["backend"].update(name="host"),
    "device-tier-on-isp": lambda d: d["backend"].update(name="isp"),
    "saint-on-pallas": lambda d: d["sampler"].update(family="saint"),
    "host-tier-needs-disk": lambda d: d["store"].update(kind="mem"),
    "duplicate-tiers": lambda d: d["cache_tiers"].append(
        dict(_tier(d, "device"))),
    "rows-without-features": lambda d: _tier(d, "device").update(
        arrays=["topology"]),
    "features-without-rows": lambda d: _tier(d, "device").update(rows=0),
    "blocks-without-topology": lambda d: _tier(d, "device").update(
        arrays=["features"]),
    "host-tier-rows": lambda d: _tier(d, "host").update(rows=8),
    "host-capacity-zero": lambda d: _tier(d, "host").update(capacity_mb=0),
    "bad-backend": lambda d: d["backend"].update(name="gpu"),
    "bad-policy": lambda d: _tier(d, "device").update(policy="mru"),
    "bad-engine": lambda d: d.update(engine="tape"),
    "empty-fanouts": lambda d: d["sampler"].update(fanouts=[]),
    "zero-fanout": lambda d: d["sampler"].update(fanouts=[3, 0]),
    "batch-zero": lambda d: d.update(batch_size=0),
    "workers-zero": lambda d: d["backend"].update(n_workers=0),
    "walk-zero": lambda d: d["sampler"].update(walk_length=0),
    "obs-interval-zero": lambda d: d["obs"].update(metrics_interval_s=0),
    "overlap-without-depth": lambda d: d["prefetch"].update(depth=0),
    "stage-depth-zero": lambda d: d["prefetch"].update(stage_depth=0),
    "plan-ahead-negative": lambda d: d["prefetch"].update(plan_ahead=-1),
    "depth-negative": lambda d: d["prefetch"].update(depth=-1,
                                                     overlap=False),
    "lane-timeout-zero": lambda d: d["prefetch"].update(lane_timeout_s=0),
    "lane-restarts-negative": lambda d: d["prefetch"].update(
        max_lane_restarts=-1),
    "io-threads-zero": lambda d: d["store"].update(io_threads=0),
    "lock-shards-zero": lambda d: d["store"].update(lock_shards=0),
    "block-bytes-small": lambda d: d["store"].update(block_bytes=256),
    "bad-store-kind": lambda d: d["store"].update(kind="tape"),
    "isp-mode-needs-disk": lambda d: (d["store"].update(kind="mem",
                                                        mode="isp"),
                                      d.update(cache_tiers=[])),
    "isp-mode-isp-backend": lambda d: (d["store"].update(mode="isp"),
                                       d["backend"].update(name="isp"),
                                       d.update(cache_tiers=[
                                           _tier(d, "host")])),
    "isp-mode-optimal-host": lambda d: (
        d["store"].update(mode="isp"),
        _tier(d, "host").update(policy="optimal", oracle_window=4)),
    "isp-window-zero": lambda d: d["store"].update(
        mode="isp", isp={"transport": "unix", "address": None,
                         "window": 0, "server_cache": True}),
    "optimal-without-window": lambda d: _tier(d, "device").update(
        policy="optimal"),
    "window-without-optimal": lambda d: _tier(d, "device").update(
        oracle_window=4),
    "pinned-fraction-above-one": lambda d: _tier(d, "device").update(
        pinned_fraction=1.5),
    "retry-attempts-zero": lambda d: d["store"]["retry"].update(
        max_attempts=0),
    "retry-jitter": lambda d: d["store"]["retry"].update(jitter=2.0),
    "fault-rate": lambda d: d["store"].update(faults={"eio_rate": 1.5}),
    "fault-stall-batch": lambda d: d["store"].update(
        faults={"lane_stall_batch": 2}),
    "bitflip-needs-verify": lambda d: d["store"].update(
        faults={"bitflip_rate": 0.1}),
}


@pytest.mark.parametrize("case", list(INVALID))
def test_from_dict_rejects_what_the_reference_rejects(case):
    msgs = []
    for config in (ref_config, port_config):
        d = _golden()
        INVALID[case](d)
        with pytest.raises(ValueError) as e:
            config.PipelineSpec.from_dict(d)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_defaults_and_normal_forms_equal():
    assert port_config.PipelineSpec().to_dict() == \
        ref_config.PipelineSpec().to_dict()
    for config in (ref_config, port_config):
        s = config.StoreSpec(kind="disk", faults={"eio_rate": 0.0})
        assert s.faults is None and s.isp is None      # canonical forms
        s = config.StoreSpec(kind="disk", mode="isp")
        assert s.isp == config.IspSpec()
    assert port_config.CacheTierSpec.device(rows=8, edge_blocks=2).arrays \
        == ("features", "topology")
    assert port_config.PipelineSpec.load(
        _path("smoke_pallas_edgecache")).effective_fanouts == (3, 2)


# ---------------------------------------------------------------------------
# the generated flags
# ---------------------------------------------------------------------------

def _kwargs(kw: dict) -> dict:
    """A flag's argparse keywords without the help text, its type by
    name (each package has its own ``_parse_fanouts``)."""
    return {k: (v.__name__ if callable(v) else v) for k, v in kw.items()
            if k != "help"}


def test_flag_table_is_the_references_for_the_ported_fields():
    ref = ref_config.FLAG_TABLE
    for flag, (path, kw) in port_config.FLAG_TABLE.items():
        assert ref[flag][0] == path, flag
        assert _kwargs(kw) == _kwargs(ref[flag][1]), flag
    assert set(ref) == set(port_config.FLAG_TABLE)


def _parse(config, argv):
    ap = argparse.ArgumentParser()
    config.add_pipeline_args(ap, overrides={"backend": "pallas"})
    return ap.parse_args(argv)


ARGVS = {
    "defaults": [],
    "batch-seed-fanouts": ["--batch", "16", "--seed", "3", "--fanouts",
                           "4,3"],
    "tiers": ["--graph-store", "disk", "--cache-mb", "2.5",
              "--cache-policy", "pinned", "--device-cache-rows", "48",
              "--edge-cache-blocks", "16", "--device-cache-policy", "lru"],
    "overlap": ["--graph-store", "disk", "--prefetch", "2", "--overlap", "1",
                "--stage-depth", "3", "--plan-ahead", "2", "--io-threads",
                "4"],
    "store-retry-verify": ["--graph-store", "disk", "--store-dir", "/x",
                           "--lock-shards", "2", "--verify-blocks", "1",
                           "--io-retries", "5", "--io-retry-backoff", "0.01",
                           "--io-deadline", "5"],
    "edge-tier-fraction": ["--edge-cache-blocks", "16",
                           "--device-cache-pinned-fraction", "0.25"],
    "lane-supervision": ["--prefetch", "2", "--lane-timeout", "5",
                         "--max-lane-restarts", "1"],
    "spec": ["--spec", _path("train_pallas_outofcore")],
    "spec-overrides": ["--spec", _path("train_pallas_outofcore"), "--batch",
                       "128", "--device-cache-rows", "96"],
    "spec-explicit-defaults": ["--spec", _path("smoke_pallas_overlap"),
                               "--prefetch", "0", "--overlap", "0",
                               "--device-cache-rows", "0"],
    "spec-backend": ["--spec", _path("smoke_pallas_edgecache"), "--backend",
                     "pallas", "--graph-store", "mem"],
    "spec-to-disk": ["--spec", _path("smoke_pallas"), "--graph-store",
                     "disk", "--device-cache-rows", "24"],
    "faults-direct-io": ["--graph-store", "disk", "--verify-blocks", "1",
                         "--direct-io", "1", "--fault-seed", "7",
                         "--fault-eio", "0.08", "--fault-short-read", "0.04",
                         "--fault-bitflip", "0.04", "--fault-stall", "0.01",
                         "--fault-stall-s", "0.12"],
    "spec-faults-off": ["--spec", _path("smoke_pallas_overlap_faults"),
                        "--fault-eio", "0", "--fault-short-read", "0",
                        "--fault-bitflip", "0", "--fault-stall", "0"],
    "host-saint": ["--backend", "host", "--sampler", "saint",
                   "--walk-length", "3", "--graph-store", "disk"],
    "optimal-tiers": ["--graph-store", "disk", "--cache-policy", "optimal",
                      "--cache-oracle-window", "6", "--device-cache-rows",
                      "32", "--edge-cache-blocks", "16",
                      "--device-cache-policy", "optimal",
                      "--device-cache-oracle-window", "4"],
    "spec-optimal-window": ["--spec", _path("smoke_pallas_optimal"),
                            "--cache-oracle-window", "4",
                            "--device-cache-oracle-window", "2"],
    "spec-host-to-optimal": ["--spec", _path("smoke_disk_host"),
                             "--cache-policy", "optimal",
                             "--cache-oracle-window", "2"],
}


@pytest.mark.parametrize("argv", list(ARGVS.values()), ids=list(ARGVS))
def test_spec_from_args_matches_reference(argv):
    port = port_config.spec_from_args(_parse(port_config, argv))
    ref = ref_config.spec_from_args(_parse(ref_config, argv))
    assert port.to_dict() == ref.to_dict()
    a, b = _parse(port_config, argv), _parse(ref_config, argv)
    port_config.fill_pipeline_flag_defaults(a)
    ref_config.fill_pipeline_flag_defaults(b)
    for flag in port_config.FLAG_TABLE:
        dest = flag.lstrip("-").replace("-", "_")
        assert getattr(a, dest) == getattr(b, dest), flag


def test_cli_backend_default_is_pallas_and_flags_reach_the_spec():
    """The launcher's backend defaults to ``isp``, as the reference's
    does; ``--backend pallas`` takes the device tiers."""
    assert port_train.parse_args(
        ["--device", "cpu"]).pipeline_spec.backend.name == "isp"
    args = port_train.parse_args(["--device", "cpu", "--backend", "pallas",
                                  "--graph-store", "disk", "--prefetch",
                                  "2", "--overlap", "1",
                                  "--edge-cache-blocks", "16"])
    spec = args.pipeline_spec
    assert spec.backend.name == "pallas"
    assert spec.prefetch.overlap and spec.prefetch.depth == 2
    assert args.device_tier == spec.device_cache_tier()
    assert args.device_tier.arrays == ("topology",)
    assert args.device_cache_policy == DEFAULT.devcache.policy
    lm = port_train.parse_args(["--device", "cpu", "--arch", "qwen2-0.5b",
                                "--reduced"])
    assert lm.pipeline_spec is None and lm.batch == 64


# ---------------------------------------------------------------------------
# the specs the port runs: batches and counters equal the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reddit():
    return jload_dataset("reddit"), load_dataset("reddit")


def _assert_batches_equal(got, want, idx):
    np.testing.assert_array_equal(got.targets, np.asarray(want.targets))
    for x, y in zip(got.hop_ids + got.hop_feats + [got.labels],
                    want.hop_ids + want.hop_feats + [want.labels]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=f"batch {idx}")
    if want.trace is not None:
        assert got.trace.io == want.trace.io, f"batch {idx}"
    else:
        assert got.trace is None


@pytest.mark.parametrize("name", PORTED[:4])
def test_ported_specs_match_reference(reddit, name):
    spec = port_config.PipelineSpec.load(_path(name))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_config.build_pipeline(
            ref_config.PipelineSpec.load(_path(name)), reddit[0])
    port = port_config.build_pipeline(spec, reddit[1], device="cpu")
    try:
        assert port.notes == ref.notes
        assert port.describe() == ref.describe()
        assert (port.store is None) == (ref.store is None)
        for idx in range(2):
            _assert_batches_equal(port.get_batch(idx), ref.get_batch(idx),
                                  idx)
        if port.store is not None:
            assert port.store.io_counters() == ref.store.io_counters()
            tmp = port.store.path
    finally:
        ref.close()
        port.close()
    if port.store is not None:
        assert not os.path.exists(tmp)      # the pipeline's temp dir is gone


@pytest.mark.parametrize("name", LATER)
def test_later_specs_are_refused_before_anything_opens(name, tmp_path):
    """The specs of the later slices are refused no more: each parses,
    builds and yields a batch (the telemetry spec's files go to the
    test's directory)."""
    assert name not in REFUSED
    files = (["--trace-out", str(tmp_path / "t.json"), "--metrics-out",
              str(tmp_path / "m.jsonl")]
             if name == "smoke_pallas_overlap_obs" else [])
    args = port_train.parse_args(["--device", "cpu", "--spec", _path(name),
                                  *files])
    g = load_dataset("reddit")
    with port_config.build_pipeline(args.pipeline_spec, g,
                                    device="cpu") as pipe:
        assert pipe.backend == args.pipeline_spec.backend.name
        mb = pipe.get_batch(0)
        assert mb.hop_feats[-1].shape == (
            args.pipeline_spec.batch_size,
            *args.pipeline_spec.sampler.fanouts, g.feat_dim)
    if files:
        assert (tmp_path / "t.json").exists()


def test_make_loader_shim_equals_build_pipeline(reddit, tmp_path):
    g = reddit[1]
    save_graph(g, str(tmp_path))
    tier = port_config.CacheTierSpec.device(rows=24, edge_blocks=16)
    spec = port_config.PipelineSpec(
        backend=port_config.BackendSpec(name="pallas"),
        sampler=port_config.SamplerSpec(fanouts=(3, 2)),
        store=port_config.StoreSpec(kind="disk"), cache_tiers=(tier,),
        batch_size=8)
    stores = [DiskStore(str(tmp_path)) for _ in range(2)]
    try:
        a = make_loader("pallas", g, batch_size=8, fanouts=(3, 2),
                        store=stores[0], device_cache=tier, device="cpu")
        b = port_config.build_pipeline(spec, g, store=stores[1],
                                       device="cpu")
        for idx in range(2):
            x, y = a.get_batch(idx), b.get_batch(idx)
            for s, t in zip(x.hop_ids + x.hop_feats, y.hop_ids + y.hop_feats):
                assert torch.equal(s, t)
            assert x.trace.io == y.trace.io
        b.close()
        assert stores[1]._fd                # a caller's store stays open
    finally:
        for st in stores:
            st.close()
    with pytest.raises(KeyError, match="unknown backend"):
        make_loader("mesh", g)


@pytest.mark.parametrize("cache_mb", [0.25, 64.0])
def test_effective_plan_ahead_matches_reference(reddit, tmp_path, cache_mb):
    from repro.core.loader import _effective_plan_ahead as ref_plan
    from repro.storage import DiskStore as JDiskStore
    save_graph(reddit[1], str(tmp_path))
    port, ref = (DiskStore(str(tmp_path), cache_mb=cache_mb),
                 JDiskStore(str(tmp_path), cache_mb=cache_mb))
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            got = _effective_plan_ahead(2, port, 64)
            want = ref_plan(2, ref, 64)
        assert got == want == (0 if cache_mb < 1 else 2)
        assert len(w) == (2 if cache_mb < 1 else 0)
        if w:
            assert str(w[0].message) == str(w[1].message)
    finally:
        port.close()
        ref.close()
