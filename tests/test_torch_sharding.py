"""The port's logical-axis sharding (``repro_torch.distributed.sharding``)
and collectives (``repro_torch.distributed.collectives``).

``logical_to_spec`` against the reference's on 1x1, 2x1 and 2x2 meshes
(the reference's side on placeholder CPU devices in a subprocess): every
leaf of every arch's full config and the reference's own property cases
give the same spec.  The reference's ``tests/test_sharding.py`` on the
port.  ``placements`` and each collective on 2 gloo ranks, against a
one-process computation: the local shards ``distribute_tensor`` keeps
are the spec's slices, ``online_softmax_combine`` is the whole
softmax (one rank's slice wholly masked), ``all_to_all_dispatch``,
``ring_allgather_kv``, ``psum_scatter`` and ``shard_offset`` as the
reference's ``lax`` collectives define them.
"""

import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import _torch_mesh_ranks as ranks
from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardingRules,
                                              logical_to_spec, placements,
                                              tree_placements)
from repro_torch.models.params import tree_leaves
from repro_torch.models.registry import ARCH_IDS, get_config
from repro_torch.models.transformer import build_defs

ROOT = Path(__file__).resolve().parents[1]
RULES = ShardingRules.default()
MESHES = ((1, 1), (2, 1), (2, 2))
AXES = ["batch", "embed", "heads", "kv_heads", "mlp", "vocab", "seq",
        "kv_seq", "experts", None]
# the reference's property cases (tests/test_sharding.py) on every mesh
PROPERTY_CASES = [(tuple(c), tuple(2 ** (i % 4) * 3 for i in range(len(c))))
                  for n in (1, 2, 3) for c in itertools.product(AXES,
                                                                repeat=n)]

REF_SPECS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh
from repro.distributed.sharding import DEFAULT_RULES, ShardingRules, logical_to_spec
from repro.models.params import ParamDef
from repro.models.registry import ARCH_IDS, get_config
from repro.models.transformer import build_defs

cases = json.loads(sys.argv[2])
rules = ShardingRules.default()
def norm(spec):
    return [list(s) if isinstance(s, tuple) else s for s in spec]
out = {"rules": [[k, list(v) if isinstance(v, tuple) else v]
                 for k, v in DEFAULT_RULES]}
for shape in ((1, 1), (2, 1), (2, 2)):
    n = shape[0] * shape[1]
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), ("data", "model"))
    key = "x".join(map(str, shape))
    out[key] = {"archs": {}, "cases": []}
    for arch in ARCH_IDS:
        leaves = jax.tree.leaves(build_defs(get_config(arch)),
                                 is_leaf=lambda x: isinstance(x, ParamDef))
        out[key]["archs"][arch] = [
            norm(logical_to_spec(d.logical_axes, rules, mesh, d.shape))
            for d in leaves]
    for axes, dims in cases:
        out[key]["cases"].append(norm(logical_to_spec(
            tuple(axes), rules, mesh, tuple(dims))))
json.dump(out, open(sys.argv[1], "w"))
"""


def _norm(spec):
    return [list(s) if isinstance(s, tuple) else s for s in spec]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("specs") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_SPECS, str(path),
                        json.dumps(PROPERTY_CASES)], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300,
                       preexec_fn=lambda: os.nice(10))
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def on_ranks(tmp_path_factory):
    return ranks.run_ranks(ranks.sharding_task, 2,
                           tmp_path_factory.mktemp("ranks"))


def test_rules_are_the_references(reference):
    assert [[k, list(v) if isinstance(v, tuple) else v]
            for k, v in DEFAULT_RULES] == reference["rules"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_every_leaf_of_every_arch_gets_the_references_spec(reference, shape):
    sizes = dict(zip(("data", "model"), shape))
    want = reference["x".join(map(str, shape))]["archs"]
    for arch in ARCH_IDS:
        got = [_norm(logical_to_spec(d.logical_axes, RULES, sizes, d.shape))
               for d in tree_leaves(build_defs(get_config(arch)))]
        assert got == want[arch], arch


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_property_cases_get_the_references_spec(reference, shape):
    sizes = dict(zip(("data", "model"), shape))
    got = [_norm(logical_to_spec(axes, RULES, sizes, dims))
           for axes, dims in PROPERTY_CASES]
    assert got == reference["x".join(map(str, shape))]["cases"]


# the reference's tests/test_sharding.py, on the port's 1x1 mesh sizes
MESH11 = {"data": 1, "model": 1}


def test_basic_resolution():
    assert logical_to_spec(("batch", "seq"), RULES, MESH11) == ("data",)


def test_divisibility_fallback():
    assert logical_to_spec(("heads", None), RULES, MESH11, (3, 7)) \
        in (("model",), ())
    assert logical_to_spec(("heads", "embed"), RULES,
                           {"data": 2, "model": 2}, (3, 8)) == \
        (None, "data")


def test_no_axis_reuse():
    spec = logical_to_spec(("heads", "mlp"), RULES, MESH11, (4, 4))
    flat = [a for s in spec if s is not None
            for a in (s if isinstance(s, tuple) else (s,))]
    assert len(flat) == len(set(flat))


def test_unknown_axis_raises():
    with pytest.raises(KeyError):
        logical_to_spec(("nonexistent",), RULES, MESH11)


@given(st.lists(st.sampled_from(
    ["batch", "embed", "heads", "kv_heads", "mlp", "vocab", "seq", None]),
    min_size=1, max_size=5),
    st.integers(1, 4), st.integers(1, 4))
@settings(max_examples=40, deadline=None)
def test_spec_property(axes, dpow, mpow):
    """Any axes on any mesh: no mesh axis twice, every sharded dim
    divisible by its mesh size."""
    sizes = {"data": 2 ** (dpow - 1), "model": 2 ** (mpow - 1)}
    dims = tuple(2 ** (i % 4) * 3 for i in range(len(axes)))
    spec = logical_to_spec(tuple(axes), RULES, sizes, dims)
    flat = []
    for i, s in enumerate(spec):
        if s is None:
            continue
        names = s if isinstance(s, tuple) else (s,)
        flat.extend(names)
        assert dims[i] % int(np.prod([sizes[a] for a in names])) == 0
    assert len(flat) == len(set(flat))


class _Names:
    """A mesh's names and sizes, as ``placements`` reads them."""

    def __init__(self, shape):
        self.mesh_dim_names = ("data", "model")
        self.shape = shape


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Names((2, 2))
    assert placements(("data", "model"), mesh) == (Shard(0), Shard(1))
    assert placements((None, "model", "data"), mesh) == (Shard(2), Shard(1))
    assert placements((("data", "model"),), mesh) == (Shard(0), Shard(0))
    assert placements((), mesh) == (Replicate(), Replicate())
    defs = build_defs(get_config("qwen2-0.5b"))
    pl = tree_placements(defs, RULES, mesh)
    # wq (L, d, H, Dh): embed over data, heads over model
    assert pl["blocks"]["wq"] == (Shard(1), Shard(2))
    assert pl["blocks"]["attn_norm"] == (Shard(1), Replicate())


def _slices(spec, shape):
    """The local shard each rank of a mesh of ``shape`` holds for a
    (4, 6, 8) tensor under ``spec``."""
    full = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    out = []
    for rank in range(2):
        coords = dict(zip(("data", "model"), np.unravel_index(rank, shape)))
        idx = [slice(None)] * 3
        for dim, s in enumerate(spec):
            if s is None:
                continue
            names = s if isinstance(s, tuple) else (s,)
            n = int(np.prod([dict(zip(("data", "model"), shape))[a]
                             for a in names]))
            c = 0
            for a in names:
                c = c * dict(zip(("data", "model"), shape))[a] + coords[a]
            size = full.shape[dim] // n
            idx[dim] = slice(c * size, (c + 1) * size)
        out.append(full[tuple(idx)])
    return out


def test_placements_shard_as_the_spec_says(on_ranks):
    for shape in ((2, 1), (1, 2)):
        for axes in ranks.PLACEMENT_CASES:
            spec = logical_to_spec(axes, RULES,
                                   dict(zip(("data", "model"), shape)),
                                   (4, 6, 8))
            want = _slices(spec, shape)
            for rank, got in enumerate(on_ranks):
                g_spec, _, local = got["placed"][(shape, axes)]
                assert g_spec == spec
                np.testing.assert_array_equal(local.numpy(), want[rank])


def test_constrain_redistributes_a_dtensor_and_keeps_a_tensor(on_ranks):
    """``constrain`` of a replicated DTensor to ("embed", "mlp", None) on
    the (2, 1) mesh leaves each rank its half of dim 0; a plain tensor
    comes back as it is."""
    want = _slices(("data",), (2, 1))
    for rank, got in enumerate(on_ranks):
        np.testing.assert_array_equal(got["constrained"].numpy(), want[rank])
        assert got["plain_kept"]


def test_online_softmax_combine_is_the_whole_softmax(on_ranks):
    """Rank 1's slice is wholly masked (its max -1e30): its scale is 0,
    and the result is the softmax over rank 0's keys alone."""
    s, v = ranks._rand(1, 2, 3, 10), ranks._rand(2, 2, 10, 5)
    want = torch.einsum("bhs,bsd->bhd", torch.softmax(s[..., :5], -1),
                        v[:, :5])
    for got in on_ranks:
        assert torch.isfinite(got["combine"]).all()
        torch.testing.assert_close(got["combine"], want, rtol=1e-5,
                                   atol=1e-6)


def test_collectives_as_the_references_define_them(on_ranks):
    xs = [np.arange(24, dtype=np.float32).reshape(4, 6) + 100 * r
          for r in range(2)]
    y = np.arange(16, dtype=np.float32).reshape(4, 4) * 3
    for r, got in enumerate(on_ranks):
        # lax.all_to_all(tiled): chunk r of every rank, concatenated
        np.testing.assert_array_equal(
            got["a2a"].numpy(),
            np.concatenate([x[2 * r:2 * r + 2] for x in xs], axis=1))
        np.testing.assert_array_equal(
            got["a2a_untiled"].numpy(),
            np.stack([x.reshape(2, 2, 6)[r] for x in xs], axis=2))
        assert [float(b[0, 0]) for b in got["ring"]] == [r, (r - 1) % 2]
        np.testing.assert_array_equal(got["scatter0"].numpy(),
                                      y[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["scatter1"].numpy(),
                                      y[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["scatter_untiled"].numpy(), y[r])
        assert got["offset"] == 7 * r
