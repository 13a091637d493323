"""The port's shape cells, abstract inputs and abstract train state
(``repro_torch.launch.shapes``, ``train.steps.abstract_train_state``) on
the production meshes (``launch.mesh.make_production_mesh``), against the
reference's.

``SHAPES`` and ``cell_skip_reason`` equal the reference's for every arch
and cell.  On the (16, 16) and (2, 16, 16) meshes every leaf of
``input_specs`` (every arch, every cell) and of ``abstract_train_state``
(every arch: the parameters and AdamW's two moments) has the reference's
global shape and dtype, and this rank's local shard has the shape of the
reference's ``NamedSharding.shard_shape``: exact.  The reference's side
runs once, in a subprocess on 512 placeholder CPU devices.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.launch import shapes as ref_shapes
from repro.models.registry import get_config as ref_config
from repro_torch.distributed.sharding import (ShardingRules, batch_axes,
                                              batch_group)
from repro_torch.launch.mesh import make_production_mesh, production_mesh
from repro_torch.launch.shapes import SHAPES, cell_skip_reason, input_specs
from repro_torch.models.registry import ARCH_IDS, get_config
from repro_torch.models.transformer import abstract_lm, cache_defs
from repro_torch.optim.adamw import adamw
from repro_torch.train.steps import abstract_train_state

ROOT = Path(__file__).resolve().parents[1]
RULES = ShardingRules.default()
MESHES = ("16x16", "2x16x16")

REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.distributed.sharding import ShardingRules
from repro.launch.mesh import make_production_mesh
from repro.launch.shapes import SHAPES, input_specs
from repro.models.registry import ARCH_IDS, get_config
from repro.models.transformer import LM
from repro.optim.adamw import adamw
from repro.train.steps import abstract_train_state

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if not isinstance(tree, jax.ShapeDtypeStruct) or not tree.shape:
        return {}
    return {prefix: [list(tree.shape), str(tree.dtype),
                     list(tree.sharding.shard_shape(tree.shape))]}

rules = ShardingRules.default()
out = {}
for multi_pod in (False, True):
    mesh = make_production_mesh(multi_pod=multi_pod)
    key = "2x16x16" if multi_pod else "16x16"
    out[key] = {"state": {}, "inputs": {}}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        out[key]["state"][arch] = flat(abstract_train_state(
            LM(cfg), adamw(3e-4), rules, mesh))
        for name, shape in SHAPES.items():
            out[key]["inputs"][f"{arch}/{name}"] = flat(
                input_specs(cfg, shape, rules, mesh))
json.dump(out, open(sys.argv[1], "w"))
"""


def _flat(tree, prefix=""):
    """path -> [global shape, dtype, this rank's local shape] of every
    DTensor leaf (the port's scalars, ``step`` and ``position``, are host
    ints, the reference's 0-d abstract values: both left out)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if not isinstance(tree, torch.Tensor):
        return {}
    return {prefix: [list(tree.shape), str(tree.dtype).replace("torch.", ""),
                     list(tree.to_local().shape)]}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("shapes") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF, str(path)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300, preexec_fn=lambda: os.nice(10))
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def port():
    out = {}
    for key, multi_pod in zip(MESHES, (False, True)):
        out[key] = {"state": {}, "inputs": {}}
        with production_mesh(multi_pod, "cpu") as mesh:
            for arch in ARCH_IDS:
                cfg = get_config(arch)
                model = abstract_lm(cfg, mesh, RULES, device="cpu",
                                    trainable=True)
                out[key]["state"][arch] = _flat(abstract_train_state(
                    model, adamw(3e-4), mesh, RULES))
                for name, shape in SHAPES.items():
                    out[key]["inputs"][f"{arch}/{name}"] = _flat(
                        input_specs(cfg, shape, RULES, mesh, "cpu"))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_and_skips_are_the_references(arch):
    assert {n: (s.name, s.seq_len, s.global_batch, s.kind)
            for n, s in SHAPES.items()} == {
        n: (s.name, s.seq_len, s.global_batch, s.kind)
        for n, s in ref_shapes.SHAPES.items()}
    for name in SHAPES:
        assert cell_skip_reason(get_config(arch), SHAPES[name]) == \
            ref_shapes.cell_skip_reason(ref_config(arch),
                                        ref_shapes.SHAPES[name])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_leaves_are_the_references(reference, port, mesh, arch):
    """Every parameter and moment: global shape, dtype, local shard."""
    got, want = port[mesh]["state"][arch], reference[mesh]["state"][arch]
    assert sorted(got) == sorted(want)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_are_the_references(reference, port, mesh, arch):
    """Every cell's inputs (the decode cells' cache leaves too): global
    shape, dtype, local shard."""
    for name in SHAPES:
        key = f"{arch}/{name}"
        got, want = port[mesh]["inputs"][key], reference[mesh]["inputs"][key]
        assert got == want, key


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_defs_are_the_reference_models(arch):
    """``cache_defs`` gives the reference's ``LM.cache_defs`` tree: names,
    shapes, logical axes, bf16."""
    from repro.models.transformer import LM as RefLM

    B, S = 3, 64
    want = RefLM(ref_config(arch)).cache_defs(B, S)
    got = cache_defs(get_config(arch), B, S)
    assert sorted(got) == sorted(want)
    for k, d in want.items():
        assert (got[k].shape, got[k].logical_axes, got[k].dtype) == (
            d.shape, d.logical_axes, torch.bfloat16), k


def test_production_mesh_data_parallel_group_spans_pod_and_data():
    """The multi-pod mesh's data-parallel group is pod x data (32 ranks,
    as the rules' ``batch`` maps the rows); one pod's is data's 16."""
    with production_mesh(True, "cpu") as mesh:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert dist.get_world_size() == 512
        assert batch_axes(mesh) == ("pod", "data")
        assert dist.get_world_size(batch_group(mesh)) == 32
    assert not dist.is_initialized()
    with production_mesh(False, "cpu") as mesh:
        assert batch_axes(mesh) == ("data",)
        assert dist.get_world_size(batch_group(mesh)) == 16
        # a second production mesh of another size is refused
        with pytest.raises(RuntimeError, match="fake group of 512"):
            make_production_mesh(True, "cpu")
    assert not dist.is_initialized()
