"""The port's checkpoints (``repro_torch.checkpoint``) and resume, on the
CPU, against the reference's ``repro.checkpoint``.

* Round trip, atomic publishing, the async writer and prune, as the
  reference's ``tests/test_checkpoint.py`` checks them; a bfloat16 leaf
  is refused.
* The two packages read each other's checkpoints: a GNN state and the
  reduced qwen2-0.5b LM state, keys equal and every leaf bit-equal; a
  manifest's ``pipeline_spec`` loads in both packages' ``PipelineSpec``.
* Mid-epoch resume is repr-exact against the uninterrupted run: through
  the library over the out-of-core pipeline (synchronous and overlapped),
  through ``launch.train.main`` for the GNN (``--resume`` refusals
  included) and for the reduced LM.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.config as ref_config
import repro.core.gnn as jgnn
import repro.models.transformer as jtransformer
from repro import checkpoint as jckpt
from repro.models.registry import get_config as jget_config
from repro.optim import adamw as jadamw
from repro.train.steps import init_train_state as jinit_train_state
from repro_torch import checkpoint as ckpt
from repro_torch.core import (GNNConfig, GraphSAGE, PipelineSpec,
                              build_pipeline, build_train_step, load_dataset,
                              train_loop)
from repro_torch.core import config as port_config
from repro_torch.launch import train as port_train
from repro_torch.models.params import init_params
from repro_torch.models.registry import get_config
from repro_torch.models.transformer import LM, build_defs
from repro_torch.optim import adamw
from repro_torch.storage import RetrySpec, save_graph
from repro_torch.train.steps import init_train_state

FANOUTS = (3, 2)
LM_ARCH = "qwen2-0.5b"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach().cpu()
                                    if isinstance(tree, torch.Tensor)
                                    else tree)}


def _assert_bit_equal(got: dict, want: dict):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# the store itself
# ---------------------------------------------------------------------------

def _state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.zeros(3)},
            "opt": {"m": {"w": torch.ones(2, 3), "b": torch.ones(3)}},
            "idx": torch.arange(4, dtype=torch.int64),
            "step": 5}


def test_roundtrip_and_manifest(tmp_path):
    state = _state()
    path = ckpt.save(str(tmp_path), 5, state,
                     manifest_extra={"note": "x"})
    assert path.endswith("step_00000005.npz")
    restored, step = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 5
    assert restored["step"].dtype == torch.int32
    assert restored["step"].shape == () and int(restored["step"]) == 5
    state["step"] = np.asarray(5, np.int32)
    _assert_bit_equal(restored, state)
    m = ckpt.read_manifest(str(tmp_path))
    assert m["step"] == 5 and m["note"] == "x"
    assert m["keys"] == sorted(["params/w", "params/b", "opt/m/w",
                                "opt/m/b", "idx", "step"])
    with np.load(path) as z:
        assert z.files == m["keys"]         # written in sorted order
    like = {"params": {"w": torch.zeros(1, dtype=torch.float64),
                       "b": torch.zeros(1)}}
    cast, _ = ckpt.restore(str(tmp_path), device="cpu", like=like)
    assert cast["params"]["w"].dtype == torch.float64
    assert cast["opt"]["m"]["w"].dtype == torch.float32


def test_atomic_no_partial_files(tmp_path, monkeypatch):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(4)})
    assert sorted(os.listdir(tmp_path)) == ["step_00000001.npz",
                                            "step_00000001.npz.json"]

    def crash(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", crash)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(str(tmp_path), 2, {"w": torch.ones(4)})
    assert ckpt.list_steps(str(tmp_path)) == [1]
    assert not os.path.exists(tmp_path / "step_00000002.npz.json")


def test_async_and_prune(tmp_path):
    saver = ckpt.AsyncSaver(str(tmp_path))
    w = torch.zeros(2)
    for s in (1, 2, 3, 4):
        w.fill_(float(s))
        saver.save_async(s, {"w": w})
        w.fill_(-1.0)               # an in-place update after the snapshot
    saver.wait()
    assert ckpt.list_steps(str(tmp_path)) == [1, 2, 3, 4]
    for s in (1, 2, 3, 4):
        restored, _ = ckpt.restore(str(tmp_path), s, device="cpu")
        assert restored["w"].tolist() == [float(s)] * 2
    ckpt.prune(str(tmp_path), keep=2)
    assert ckpt.list_steps(str(tmp_path)) == [3, 4]
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore(str(tmp_path / "none"), device="cpu")


def test_bf16_leaf_is_refused(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(str(tmp_path), 1, {"w": torch.ones(2, dtype=torch.bfloat16)})
    assert ckpt.list_steps(str(tmp_path)) == []
    jckpt.save(str(tmp_path), 1, {"w": jnp.ones(2, jnp.bfloat16)})
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.restore(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# each package reads the other's checkpoints
# ---------------------------------------------------------------------------

def _reference_gnn_state(g):
    model = jgnn.GraphSAGE(jgnn.GNNConfig(
        feat_dim=g.feat_dim, hidden=16, n_classes=int(g.labels.max()) + 1,
        fanouts=FANOUTS))
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(3)
    opt = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), jnp.float32), jadamw(1e-3).init(params))
    return {"params": params, "opt": opt, "step": jnp.asarray(7, jnp.int32)}


def _port_gnn_state(g):
    gnn = GraphSAGE(GNNConfig(feat_dim=g.feat_dim, hidden=16,
                              n_classes=int(g.labels.max()) + 1,
                              fanouts=FANOUTS), device="cpu")
    params = dict(gnn.named_parameters())
    opt = adamw(1e-3).init(params)
    gen = torch.Generator().manual_seed(3)
    for tree in opt.values():
        for t in tree.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    return {"params": params, "opt": opt, "step": 7}


def _reference_lm_state():
    cfg = jget_config(LM_ARCH).reduced()
    return jinit_train_state(jtransformer.LM(cfg), jadamw(1e-3),
                             jax.random.key(0))


def _port_lm_state():
    cfg = get_config(LM_ARCH).reduced()
    model = LM(cfg, init_params(build_defs(cfg), seed=0), device="cpu",
               trainable=True)
    state = init_train_state(model, adamw(1e-3))
    state["step"] = 3
    return state


@pytest.mark.parametrize("what", ["gnn", "lm"])
def test_port_restores_reference_checkpoint(what, tmp_path):
    if what == "gnn":
        g = load_dataset("reddit")
        jstate, port = _reference_gnn_state(g), _port_gnn_state(g)
    else:
        jstate, port = _reference_lm_state(), _port_lm_state()
    jckpt.save(str(tmp_path), 7, jstate)
    restored, step = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 7
    assert sorted(_flat(restored)) == sorted(_flat(port))
    _assert_bit_equal(restored, jax.device_get(jstate))


@pytest.mark.parametrize("what", ["gnn", "lm"])
def test_reference_restores_port_checkpoint(what, tmp_path):
    if what == "gnn":
        port = _port_gnn_state(load_dataset("reddit"))
        jkeys = _flat(_reference_gnn_state(load_dataset("reddit")))
    else:
        port, jkeys = _port_lm_state(), _flat(_reference_lm_state())
    ckpt.save(str(tmp_path), 3, port)
    restored, step = jckpt.restore(str(tmp_path))
    assert step == 3
    restored = jax.device_get(restored)
    assert sorted(_flat(restored)) == sorted(jkeys)
    port["step"] = np.asarray(port["step"], np.int32)
    _assert_bit_equal(restored, port)
    assert restored["step"].dtype == np.int32


def test_manifest_pipeline_spec_round_trips_both_packages(tmp_path):
    spec = PipelineSpec.load(os.path.join(
        os.path.dirname(__file__), "..", "benchmarks", "specs",
        "smoke_pallas_overlap_faults.json"))
    ckpt.save(str(tmp_path / "p"), 1, {"w": torch.ones(1)},
              manifest_extra={"pipeline_spec": spec.to_dict()})
    jspec = ref_config.PipelineSpec.from_dict(spec.to_dict())
    jckpt.save(str(tmp_path / "j"), 1, {"w": jnp.ones(1)},
               manifest_extra={"pipeline_spec": jspec.to_dict()})
    for d in ("p", "j"):
        m = ckpt.read_manifest(str(tmp_path / d))
        assert m == jckpt.read_manifest(str(tmp_path / d))
        assert PipelineSpec.from_dict(m["pipeline_spec"]) == spec
        assert ref_config.PipelineSpec.from_dict(m["pipeline_spec"]) == jspec
        assert m["pipeline_spec"] == json.loads(spec.to_json())


# ---------------------------------------------------------------------------
# mid-epoch resume
# ---------------------------------------------------------------------------

def _spec(store_dir, overlap):
    tiers = (port_config.CacheTierSpec(tier="host", capacity_mb=2.0,
                                       arrays=()),
             port_config.CacheTierSpec.device(rows=48, edge_blocks=16,
                                              policy="lru"))
    return PipelineSpec(
        backend=port_config.BackendSpec(name="pallas"),
        sampler=port_config.SamplerSpec(fanouts=FANOUTS),
        store=port_config.StoreSpec(kind="disk", path=store_dir,
                                    io_threads=2, retry=RetrySpec()),
        cache_tiers=tiers,
        prefetch=(port_config.PrefetchSpec(depth=2, overlap=True,
                                           stage_depth=2)
                  if overlap else port_config.PrefetchSpec()),
        batch_size=8, seed=0)


def _train(pipe, g, *, steps, start=0, restored=None, losses=None):
    gnn = GraphSAGE(GNNConfig(feat_dim=g.feat_dim, hidden=16,
                              n_classes=int(g.labels.max()) + 1,
                              fanouts=FANOUTS), device="cpu")
    params = dict(gnn.named_parameters())
    opt = adamw(3e-3)
    step = build_train_step(pipe, gnn, opt)
    state = {"opt": opt.init(params), "step": 0}
    if restored is not None:
        port_train._copy_into(params, restored["params"])
        port_train._copy_into(state["opt"], restored["opt"])
        state["step"] = int(restored["step"])
    losses = [] if losses is None else losses
    state, _ = train_loop(pipe, step, state, steps=steps, start=start,
                          on_step=lambda i, s, m: losses.append(
                              repr(float(m["loss"]))))
    return {"params": params, **state}, losses


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sync", "overlapped"])
def test_mid_epoch_resume_is_exact(tmp_path, overlap):
    g = load_dataset("reddit")
    store_dir = str(tmp_path / "store")
    save_graph(g, store_dir)
    spec = _spec(store_dir, overlap)
    with build_pipeline(spec, g, device="cpu") as pipe:
        _, full = _train(pipe, g, steps=8)
    with build_pipeline(spec, g, device="cpu") as pipe:
        state, first = _train(pipe, g, steps=4)
        ckpt.save(str(tmp_path / "ck"), 4, state,
                  manifest_extra={"pipeline_spec": spec.to_dict()})
    manifest = ckpt.read_manifest(str(tmp_path / "ck"))
    respec = PipelineSpec.from_dict(manifest["pipeline_spec"])
    assert respec == spec
    restored, step0 = ckpt.restore(str(tmp_path / "ck"), device="cpu")
    assert step0 == 4
    with build_pipeline(respec, g, device="cpu") as pipe:
        _, resumed = _train(pipe, g, steps=8, start=4, restored=restored,
                            losses=list(first))
    assert resumed == full


GNN_ARGV = ["--device", "cpu", "--dataset", "reddit", "--batch", "8",
            "--fanouts", "3,2", "--hidden", "16", "--log-every", "2",
            "--ckpt-every", "4"]


def test_gnn_cli_resume(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        port_train.parse_args(GNN_ARGV + ["--resume"])
    assert e.value.code == 2
    assert "--resume needs --ckpt-dir" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="no checkpoints"):
        port_train.main(GNN_ARGV + ["--resume", "--ckpt-dir",
                                    str(tmp_path / "empty")])
    flags = ["--backend", "pallas", "--graph-store", "disk",
             "--device-cache-rows", "24",
             "--edge-cache-blocks", "16", "--cache-mb", "0.25"]
    _, full, _ = port_train.main(GNN_ARGV + flags + [
        "--steps", "8", "--ckpt-dir", str(tmp_path / "a")])
    port_train.main(GNN_ARGV + flags + ["--steps", "4", "--ckpt-dir",
                                        str(tmp_path / "b")])
    assert ckpt.list_steps(str(tmp_path / "b")) == [4]
    capsys.readouterr()
    # without the flags: the data plane comes from the manifest
    _, resumed, _ = port_train.main(GNN_ARGV + [
        "--steps", "8", "--resume", "--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert "restored from the checkpoint manifest" in out
    assert "device devcache" in out
    assert [repr(x) for x in resumed] == [repr(x) for x in full[4:]]
    assert ckpt.list_steps(str(tmp_path / "b")) == [4, 8]


def test_lm_cli_resume(tmp_path, capsys):
    argv = ["--device", "cpu", "--arch", LM_ARCH, "--reduced", "--batch",
            "4", "--seq-len", "32", "--log-every", "1"]
    full = port_train.main(argv + ["--steps", "8"])["losses"]
    port_train.main(argv + ["--steps", "4", "--ckpt-dir",
                            str(tmp_path / "lm")])
    capsys.readouterr()
    resumed = port_train.main(argv + ["--steps", "8", "--ckpt-dir",
                                      str(tmp_path / "lm")])["losses"]
    assert "resumed from step 4" in capsys.readouterr().out
    assert [repr(x) for x in resumed] == [repr(x) for x in full[4:]]
    with pytest.raises(SystemExit, match="no checkpoints"):
        port_train.main(argv + ["--resume", "--ckpt-dir",
                                str(tmp_path / "none")])
