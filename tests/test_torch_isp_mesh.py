"""The port's mesh ISP backend (``repro_torch.core.partition``,
``core.isp``, ``launch.mesh``, the ``isp`` loader) against the
reference's ``repro.core.partition``/``repro.core.isp`` and against the
port's own ``pallas`` backend.

On reddit (1,024 nodes): ``partition_graph`` equals the reference's
array for array at 1, 3 and 4 shards; ``ISPGraph``'s hop ids, features,
labels and edge chunks equal the reference's bit for bit at 1 shard
in-process and at 4 shards against one subprocess that runs the
reference on 4 placeholder CPU devices; the isp loader's batches equal
the pallas loader's at 1 and 4 shards (the reference's own parity
oracle); the fused step lowers the loss over 10 steps; the launcher's
``--backend isp`` (its default) prints the pallas backend's losses.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import ISPGraph as JISPGraph
from repro.core import load_dataset as jload_dataset
from repro.core import partition_graph as jpartition_graph
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro_torch import rng
from repro_torch.core import (GNNConfig, GraphSAGE, ISPGraph,
                              build_isp_train_step, load_dataset,
                              make_loader, partition_graph)
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parent.parent
FANOUTS = (5, 2)
KEY = 3


@pytest.fixture(scope="module")
def reddit():
    return jload_dataset("reddit"), load_dataset("reddit")


def _targets(g, n=64):
    return np.random.default_rng(0).integers(0, g.num_nodes, n).astype(
        np.int32)


def _mesh(shards):
    return make_mesh((shards, 1), ("data", "model"), device="cpu")


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_partition_graph_equals_reference(reddit, shards):
    want, got = jpartition_graph(reddit[0], shards), \
        partition_graph(reddit[1], shards)
    for name in ("indptr", "indices", "features", "labels", "node_offset",
                 "n_local"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.n_shards, got.n_max) == (want.n_shards, want.n_max)
    assert got.edge_imbalance() == want.edge_imbalance()


def _port_isp(g, shards):
    return ISPGraph(partition_graph(g, shards), _mesh(shards))


def _port_outputs(eng, g):
    t = _targets(g)
    hops = eng.sample_khop(t, FANOUTS, key=rng.key(KEY))
    maxd = int(g.degrees().max())
    return {**{f"hop{i}": h for i, h in enumerate(hops)},
            **{f"feat{i}": eng.gather_features(h)
               for i, h in enumerate(hops)},
            "labels": eng.gather_labels(hops[0]),
            "chunks": eng.fetch_edge_chunks(t[:16], maxd)}


def _assert_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = torch.from_numpy(np.array(w))
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_isp_graph_one_shard_equals_reference(reddit):
    jg, g = reddit
    jeng = JISPGraph(jpartition_graph(jg, 1), jmake_host_mesh())
    t = _targets(g)
    hops = jeng.sample_khop(jax.numpy.asarray(t), FANOUTS,
                            key=jax.random.key(KEY))
    want = {**{f"hop{i}": h for i, h in enumerate(hops)},
            **{f"feat{i}": jeng.gather_features(h)
               for i, h in enumerate(hops)},
            "labels": jeng.gather_labels(hops[0]),
            "chunks": jeng.fetch_edge_chunks(jax.numpy.asarray(t[:16]),
                                             int(g.degrees().max()))}
    _assert_equal(_port_outputs(_port_isp(g, 1), g), want)


REF_4_SHARDS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.core import ISPGraph, load_dataset, partition_graph
from repro.launch.mesh import make_mesh

g = load_dataset("reddit")
eng = ISPGraph(partition_graph(g, 4), make_mesh((4, 1), ("data", "model")))
t = np.random.default_rng(0).integers(0, g.num_nodes, 64).astype(np.int32)
hops = eng.sample_khop(jnp.asarray(t), (5, 2), key=jax.random.key(3))
out = {f"hop{i}": np.asarray(h) for i, h in enumerate(hops)}
out.update({f"feat{i}": np.asarray(eng.gather_features(h))
            for i, h in enumerate(hops)})
out["labels"] = np.asarray(eng.gather_labels(hops[0]))
out["chunks"] = np.asarray(eng.fetch_edge_chunks(jnp.asarray(t[:16]),
                                                 int(g.degrees().max())))
np.savez(sys.argv[1], **out)
"""


def test_isp_graph_four_shards_equals_reference(reddit, tmp_path):
    path = tmp_path / "ref4.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_4_SHARDS, str(path)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    with np.load(path) as want:
        _assert_equal(_port_outputs(_port_isp(reddit[1], 4), reddit[1]),
                      dict(want))


@pytest.mark.parametrize("shards", [1, 4])
def test_isp_loader_equals_pallas_loader(reddit, shards):
    g = reddit[1]
    kw = dict(batch_size=16, fanouts=FANOUTS, seed=5, device="cpu")
    isp = make_loader("isp", g, mesh=_mesh(shards), **kw)
    pallas = make_loader("pallas", g, **kw)
    assert isp.engine.mesh.shape["data"] == shards
    for idx in range(3):
        a, b = isp.get_batch(idx), pallas.get_batch(idx)
        np.testing.assert_array_equal(a.targets, b.targets)
        for x, y in zip(a.hop_ids + a.hop_feats + [a.labels],
                        b.hop_ids + b.hop_feats + [b.labels]):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert a.launches == {}
    assert isp.stats()["simulated_storage_s"] == 0.0


def test_mesh_places_shards():
    assert make_host_mesh("cpu").devices == (torch.device("cpu"),)
    m = _mesh(4)
    assert m.shape == {"data": 4, "model": 1}
    assert m.devices == (torch.device("cpu"),) * 4
    # a 'model' axis: the GNN's shards are the 'data' positions only
    m22 = make_mesh((2, 2), ("data", "model"), device="cpu")
    assert m22.shape == {"data": 2, "model": 2}
    assert m22.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="size >= 1"):
        make_mesh((2, 0), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="partitions"):
        ISPGraph(partition_graph(load_dataset("reddit"), 2), m)


def test_isp_train_step_lowers_the_loss_at_four_shards(reddit):
    g = reddit[1]
    eng = _port_isp(g, 4)
    torch.manual_seed(0)
    gnn = GraphSAGE(GNNConfig(feat_dim=g.feat_dim, hidden=32,
                              n_classes=int(g.labels.max()) + 1,
                              fanouts=FANOUTS), device="cpu")
    opt = adamw(3e-3)
    step = build_isp_train_step(eng, gnn, opt, FANOUTS)
    state = {"opt": opt.init(dict(gnn.named_parameters())), "step": 0}
    t = torch.from_numpy(_targets(g))
    losses = []
    for _ in range(10):
        state, m = step(state, t, rng.key(7))
        losses.append(float(m["loss"]))
    assert state["step"] == 10
    assert losses[-1] < losses[0], losses


SMALL = ["--device", "cpu", "--steps", "3", "--batch", "8", "--fanouts",
         "3,2", "--hidden", "16", "--log-every", "1"]


def test_cli_isp_prints_the_pallas_losses(capsys):
    runs = {name: port_train.main(SMALL + flags)
            for name, flags in (("isp", ["--backend", "isp"]),
                                ("pallas", ["--backend", "pallas"]),
                                ("default-4", ["--devices", "4"]))}
    out = capsys.readouterr().out
    assert "mesh of 4 shard(s)" in out
    losses = {k: v[1] for k, v in runs.items()}
    assert len(losses["isp"]) == 3
    assert losses["isp"] == losses["pallas"] == losses["default-4"]
    assert runs["default-4"][2]["backend"] == "isp"
    assert port_train.parse_args(["--device", "cpu"]).pipeline_spec \
        .backend.name == "isp"


def test_cli_refuses_an_lm_mesh_and_trains_smoke_isp(capsys):
    """An LM's ``--devices 2`` is the (2, 1) process mesh (ROADMAP item
    16, part 1, ``tests/test_torch_lm_mesh.py`` trains it); a ``model``
    axis in training is tensor parallelism (item 16, part 2a): ``--mesh
    2x2`` parses to the (2, 2) process mesh and trains
    (``tests/test_torch_tp.py`` holds its losses to the reference's)."""
    args = port_train.parse_args(["--device", "cpu", "--arch", "qwen2-0.5b",
                                  "--reduced", "--devices", "2"])
    assert args.mesh_dims == (2, 1) and args.pipeline_spec is None
    args = port_train.parse_args(["--device", "cpu", "--arch", "qwen2-0.5b",
                                  "--reduced", "--mesh", "2x2"])
    assert args.mesh_dims == (2, 2) and args.pipeline_spec is None
    _, losses, stats = port_train.main(
        ["--device", "cpu", "--spec",
         str(ROOT / "benchmarks" / "specs" / "smoke_isp.json"), "--steps",
         "2", "--hidden", "16"])
    assert stats["backend"] == "isp" and len(losses) == 2
    assert all(np.isfinite(losses))


def test_quickstart_twin_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable,
                        str(ROOT / "examples" / "quickstart_torch.py"),
                        "isp", "--device", "cpu"], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "backend: isp on cpu" in r.stdout
    assert r.stdout.count("loss=") == 3
    assert "steps/s, consumer idle" in r.stdout
