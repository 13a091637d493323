"""The port's roofline terms (``repro_torch.roofline.analysis``) and what
a traced step counts, against the reference's ``repro/roofline``.

* ``model_flops``, ``LM.param_count`` and ``active_param_count`` equal
  the reference's for every arch and cell: exact.
* ``compute_terms_from_costs`` given the reference's v5e constants equals
  the reference's field for field (within 1e-12 relative: the same
  float arithmetic); ``tests/test_roofline.py``'s bounds case on the
  H100's constants.
* A float32 (8, 1024) ``all_reduce`` over 8 ranks (each holding its
  (1, 1024) row) counts the ring link bytes that the reference's
  ``analyze`` gives its ``psum`` (8 placeholder devices, a subprocess):
  exact.
* The traced FLOPs of the reduced qwen2 train step at (4, 64) lie within
  0.8-2.0 x 8 N tokens, as ``tests/test_roofline.py`` holds the
  reference's; the reference's ``analyze`` count of the same step is
  printed beside them.
* The fake trace of a reduced train step on a (1, 2) mesh issues exactly
  the collectives (kind, bytes, group) that a real 2-rank gloo step
  issues, and its tensor-parallel all_reduces are the real step's
  ``collectives.TRAFFIC``: count and bytes exact.
* ``StepCounter``'s FLOPs equal ``FlopCounterMode``'s on the same step.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import _torch_mesh_ranks as ranks
from repro.roofline import analysis as ref_analysis
from repro_torch.launch.shapes import SHAPES, ShapeCell
from repro_torch.launch.dryrun import trace_step
from repro_torch.models.registry import ARCH_IDS, get_config
from repro_torch.models.transformer import abstract_lm
from repro_torch.roofline import analysis

ROOT = Path(__file__).resolve().parents[1]
# the reduced train step of tests/test_roofline.py
TINY = ShapeCell("tiny", 64, 4, "train")
MESH_ARCH, MESH_B, MESH_S = "qwen2-0.5b", 4, 16
# heads and kv heads that split over 2 ranks
MESH_DERIVED = {"num_heads": 4, "num_kv_heads": 2}

PSUM = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.roofline.hlo_parse import analyze
from repro.distributed.compat import shard_map
mesh = make_mesh((8,), ("x",))
g = shard_map(lambda a: jax.lax.psum(a, "x"), mesh=mesh, in_specs=P("x"),
              out_specs=P(), check_vma=False)
c = jax.jit(g).lower(jnp.zeros((8, 1024), jnp.float32)).compile()
costs = analyze(c.as_text(), 8)
json.dump({"counts": costs.collective_counts, "link_bytes": costs.link_bytes,
           "result_bytes": costs.collective_bytes}, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def psum(tmp_path_factory):
    path = tmp_path_factory.mktemp("psum") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", PSUM, str(path)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300, preexec_fn=lambda: os.nice(10))
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def real_step(tmp_path_factory):
    """Rank 0's counts of one real train step on 2 gloo ranks."""
    return ranks.run_ranks(ranks.dryrun_task, 2,
                           tmp_path_factory.mktemp("ranks"), MESH_ARCH,
                           MESH_DERIVED, MESH_B, MESH_S)


class _FakeGroup:
    """A fake process group of ``world`` ranks (this process rank 0) and
    a ``DeviceMesh`` of ``shape`` over ``axes`` on it, for the body of a
    ``with``."""

    def __init__(self, shape, axes):
        self.shape, self.axes = shape, axes

    def __enter__(self):
        from torch.distributed.device_mesh import DeviceMesh
        from torch.testing._internal.distributed.fake_pg import FakeStore

        world = 1
        for n in self.shape:
            world *= n
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        return DeviceMesh("cpu", torch.arange(world).reshape(self.shape),
                          mesh_dim_names=self.axes)

    def __exit__(self, *exc):
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_and_model_flops_are_the_references(arch):
    from repro.models.registry import get_config as ref_config
    from repro.models.transformer import LM as RefLM

    ref = RefLM(ref_config(arch))
    model = abstract_lm(get_config(arch), device="cpu")
    assert model.param_count() == ref.param_count()
    assert model.active_param_count() == ref.active_param_count()
    for name, shape in SHAPES.items():
        assert analysis.model_flops(model.cfg, shape,
                                    model.active_param_count()) == \
            ref_analysis.model_flops(ref.cfg, shape, ref.active_param_count())


class _Costs:
    def __init__(self, flops, hbm_bytes, link_bytes):
        self.flops, self.hbm_bytes, self.link_bytes = (flops, hbm_bytes,
                                                      link_bytes)


@pytest.mark.parametrize("costs", [
    (197e12, 819e9 / 2, 50e9 / 4), (1e9, 5e12, 1e3), (3e11, 1e8, 9e11),
    (0.0, 0.0, 0.0)], ids=["compute", "memory", "collective", "zero"])
def test_terms_on_the_references_constants_are_the_references(costs):
    """The reference's arithmetic, field for field, on v5e's rates."""
    c = _Costs(*costs)
    for n_chips, mf in ((256, 197e12 * 256), (512, 3.7e15), (1, 0.0)):
        got = analysis.compute_terms_from_costs(
            c, n_chips, mf, peak_flops=ref_analysis.PEAK_FLOPS,
            hbm_bw=ref_analysis.HBM_BW, link_bw=ref_analysis.LINK_BW)
        want = ref_analysis.compute_terms_from_costs(c, n_chips, mf)
        got, want = got.to_json(), want.to_json()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0) \
                if isinstance(v, float) else got[k] == v, k


def test_roofline_terms_bounds_on_the_h100():
    """``tests/test_roofline.py``'s bounds case on the H100's rates."""
    c = _Costs(analysis.PEAK_FLOPS, analysis.HBM_BW / 2,
               analysis.LINK_BW / 4)
    terms = analysis.compute_terms_from_costs(c, 256,
                                              analysis.PEAK_FLOPS * 256)
    assert terms.bound == "compute"
    assert abs(terms.compute_s - 1.0) < 1e-6
    assert abs(terms.roofline_fraction - 1.0) < 1e-6
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW,
            analysis.HBM_BYTES) == (989e12, 3.35e12, 450e9, 80e9)


def test_all_reduce_link_bytes_are_the_references_psum(psum):
    """(8, 1024) float32 over 8 ranks, one (1, 1024) row a rank, summed:
    the reference's ``analyze`` of its ``psum`` and the port's count."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard

    with _FakeGroup((8,), ("x",)) as mesh:
        counter = analysis.StepCounter()
        with FakeTensorMode(), counter:
            x = DTensor.from_local(torch.zeros(1, 1024), mesh, [Shard(0)],
                                   run_check=False)
            with counter.step():
                dist.all_reduce(x.to_local(), group=mesh.get_group("x"))
    got = counter.collectives
    assert got.counts == {"all-reduce": 1} == psum["counts"]
    assert got.result_bytes == {"all-reduce": 4096} == psum["result_bytes"]
    assert got.link_bytes_per_chip == psum["link_bytes"] == 2 * 4096 * 7 / 8


def test_reduced_train_step_flops_match_analytic():
    """Traced FLOPs of the reduced qwen2 step at (4, 64), one process:
    ~8 N tokens (forward 2ND, backward 4ND, the remat's re-forward 2ND),
    as the reference's own test bounds its count; printed beside the
    reference's ``analyze`` of the same step."""
    import jax

    from repro.distributed.sharding import ShardingRules as RefRules
    from repro.launch.mesh import make_host_mesh
    from repro.launch.shapes import ShapeCell as RefCell
    from repro.launch.shapes import input_specs as ref_specs
    from repro.models.registry import get_config as ref_config
    from repro.models.transformer import LM as RefLM
    from repro.optim import adamw as ref_adamw
    from repro.roofline.hlo_parse import analyze
    from repro.train.steps import abstract_train_state, build_train_step

    cfg = get_config("qwen2-0.5b").reduced()
    costs = trace_step(cfg, TINY, None, device="cpu")
    n = abstract_lm(cfg, device="cpu").param_count()
    analytic = 8 * n * TINY.global_batch * TINY.seq_len
    assert 0.8 * analytic < costs.flops < 2.0 * analytic, (costs.flops,
                                                           analytic)
    assert costs.hbm_bytes > 0 and costs.peak_bytes > costs.state_bytes > 0
    model = RefLM(ref_config("qwen2-0.5b").reduced())
    mesh, rules, opt = make_host_mesh(), RefRules.default(), ref_adamw(1e-3)
    shape = RefCell("tiny", 64, 4, "train")
    with mesh:
        step = build_train_step(model, opt, mesh, rules)
        st = abstract_train_state(model, opt, rules, mesh)
        compiled = jax.jit(step, donate_argnums=0).lower(
            st, ref_specs(model.cfg, shape, rules, mesh)).compile()
    ref = analyze(compiled.as_text(), 1)
    print(f"reduced qwen2 train step at (4, 64): port {costs.flops:.4e} "
          f"FLOPs, reference {ref.flops:.4e} ({costs.flops / ref.flops:.3f}"
          f"x), 8 N tokens {analytic:.4e}")


def test_step_counter_flops_are_flop_counter_modes():
    """The registry applied by ``StepCounter`` counts what
    ``FlopCounterMode`` counts on the same traced step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.optim.adamw import adamw
    from repro_torch.train.steps import build_train_step, init_train_state

    cfg = get_config("qwen2-0.5b").reduced()
    counter = analysis.StepCounter()
    with FakeTensorMode(), counter:
        model = abstract_lm(cfg, device="cpu", trainable=True)
        opt = adamw(3e-4)
        state = init_train_state(model, opt)
        batch = {k: torch.zeros(2, 16, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        step = build_train_step(model, opt)
        with counter.step(), FlopCounterMode(display=False) as fc:
            step(state, batch)
    assert counter.flops == fc.get_total_flops() > 0


def test_fake_step_issues_the_real_steps_collectives(real_step,
                                                     monkeypatch):
    """A (1, 2) tensor-parallel train step traced on fake tensors issues
    the collectives rank 0 of a real 2-rank gloo step issues, in order;
    its all_reduces of more than one float32 (the tensor-parallel ones;
    the others are the clip's per-leaf squared sums, over each mesh dim
    that shards a leaf) are the real step's ``TRAFFIC``."""
    import dataclasses

    calls = []
    add = analysis.CollectiveStats.add

    def record(self, kind, nbytes, group):
        calls.append((kind, nbytes, group))
        add(self, kind, nbytes, group)

    monkeypatch.setattr(analysis.CollectiveStats, "add", record)
    cfg = dataclasses.replace(get_config(MESH_ARCH).reduced(),
                              **MESH_DERIVED)
    with _FakeGroup((1, 2), ("data", "model")) as mesh:
        trace_step(cfg, ShapeCell("t", MESH_S, MESH_B, "train"), mesh,
                   device="cpu")
    real = real_step[0]
    assert [tuple(c) for c in real["calls"]] == calls
    tp = [c for c in calls if c[0] == "all-reduce" and c[1] > 4]
    assert len(tp) == real["traffic"]["all_reduce"] > 0
    assert sum(c[1] for c in tp) == real["traffic"]["bytes"]
    # over "model" (2 ranks), and the clip's sums over "data" (1 rank)
    assert {c[2] for c in tp} == {2} and {c[2] for c in calls} == {1, 2}
