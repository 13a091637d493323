"""Tensor parallelism over the process mesh's ``model`` axis in the port
(``LM(..., mesh=)``, ``distributed.sharding.TensorParallel``), on gloo
ranks on the CPU, against the port's one-process runs and the
reference's runs on placeholder CPU devices.

- Every leaf's gradient: on equal weights and batch, in float32
  activations, the forward logits and every leaf's gradient (through
  ``build_train_step``: the sums over ``model`` in the layers and the
  reduce-scatter over ``data``) at (1, 2) and (2, 2) against one process,
  for the reduced config of every LM arch (each family: dense, vl, moe,
  ssm, hybrid, encdec) and two derived configs: "fallback", where the
  rules keep q heads, kv heads and vocab whole (5, 5 and 257 over M 2)
  while the SSM heads and ``mlp`` split, and "pick", whose 3 kv heads
  stay whole while its 6 q heads split (each rank's q heads read kv
  heads 0, 0, 1 or 1, 2, 2: no block of whole groups).  The gradients
  agree within a relative 1e-5 (the L2 norm of the difference over the
  leaf's), where a missing or doubled sum over ``model`` shows as an
  error of order 1, and so does AdamW's global norm over the shards (a
  leaf whole on the ``model`` ranks counted once); seamless-m4t-large-v2 within 5e-5, its near-argmax
  attention (``ROADMAP.md``, "Not faults") magnifying float32 reordering
  (its largest gap, 2.1e-5, is its ``enc_final_norm``).
- Shards: each rank's local shard of every parameter equals the block
  that the reference's ``NamedSharding`` puts on the device at that mesh
  position (``devices_indices_map``); the weights each rank draws as
  blocks equal ``convert.lm_params_from_jax``'s cut of the whole tree.
- Losses: the launcher at ``--mesh 1x2`` and ``2x2`` (4 steps) against
  the reference launcher's on 4 placeholder devices, step 1 within 2e-3,
  later steps within 3e-2 (bf16 activations, rounded at different places
  in the two frameworks, as ``tests/test_torch_init.py`` states); the
  dense family at both meshes, moe and hybrid at (1, 2), ssm, vl and the
  "fallback" config (in both packages) at (2, 2).
- Decode: prefill and greedy decode through ``build_prefill_step``/
  ``build_serve_step`` on the (1, 2) mesh against one process, with the
  cache split on S (M divides S) and on the rank's heads (it does not):
  ids equal and logits within 1e-5 of the largest in float32 for one
  arch of every family and the derived configs (seamless-m4t-large-v2 within 5e-5, as above: its largest gap
  is 1.3e-5 of the largest logit); in bf16 (dense and the derived configs: the partial sums round
  to bf16 before their sum) ids equal and logits within 0.05.
- Checkpoints written at (1, 2) resume at (2, 1) and at one process, and
  one written at (2, 1) resumes at (1, 2), with the uninterrupted run's
  losses within 3e-2.
- The GNN at ``--devices 4 --mesh 2x2`` (``--backend pallas`` and
  ``isp``: the graph sharded on ``data``, the ``model`` positions
  replicated) logs the reference launcher's losses.

The ranks spawn once a mesh (``tests/_torch_mesh_ranks.py``: 2 threads
each, niced, their own timeouts), beside one reference subprocess.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_mesh_ranks as ranks
from repro_torch.launch import train as port_train
from repro_torch.models import transformer
from repro_torch.models.params import cast_tree, init_params, tree_leaves
from repro_torch.models.registry import ARCH_IDS
from repro_torch.models.transformer import LM, build_defs
from repro_torch.train.steps import build_train_step, init_train_state

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-5
GRAD_TOL_NEAR_ARGMAX = 5e-5            # seamless-m4t-large-v2
# "expert-ffn": each expert's hidden-dim sum is split in two halves added
# after, another order than one process's; this config's float32
# gradients lie up to 3.3e-4 from float64's (its routing amplifies
# rounding), and the reordered sums move them by ~1.6e-5
GRAD_TOL_FFN_SPLIT = 5e-5
F32_LOGIT_TOL, BF16_LOGIT_TOL = 1e-5, 0.05
STEP1_TOL, LOSS_TOL = 2e-3, 3e-2
STEPS = 4

DERIVED = {"fallback": ("hymba-1.5b", dict(num_heads=5, num_kv_heads=5,
                                           vocab_size=257)),
           "pick": ("qwen2-0.5b", dict(num_heads=6, num_kv_heads=3)),
           # 3 experts do not split over 2 ranks: each expert's hidden
           # dim does (as mixtral's 8 over the production mesh's 16)
           "expert-ffn": ("mixtral-8x7b", dict(num_experts=3))}
CONFIGS = {**{a: (a, None) for a in ARCH_IDS}, **DERIVED}
BF16_DECODE = ("qwen2-0.5b", "gemma3-1b", "fallback", "pick")
# decode: one arch a family (the dense family's kv-pick case is gemma3),
# and the derived configs; mamba2's cache has no S to split
DECODE_CONFIGS = ("qwen2-0.5b", "gemma3-1b", "qwen2-vl-7b",
                  "moonshot-v1-16b-a3b", "mamba2-370m", "hymba-1.5b",
                  "seamless-m4t-large-v2", "fallback", "pick")
# the ranks' sessions do a few minutes of CPU work; under a loaded host
# (the suite's other workers) they may take several times that
RANKS_TIMEOUT_S = 900
LM_ARGV = ["--reduced", "--batch", "4", "--seq-len", "32", "--steps",
           str(STEPS), "--log-every", "1"]
# the launcher's loss runs: name -> (config, mesh)
LOSS_RUNS = {"qwen2-0.5b@1x2": ("qwen2-0.5b", "1x2"),
             "moonshot-v1-16b-a3b@1x2": ("moonshot-v1-16b-a3b", "1x2"),
             "hymba-1.5b@1x2": ("hymba-1.5b", "1x2"),
             "qwen2-0.5b@2x2": ("qwen2-0.5b", "2x2"),
             "mamba2-370m@2x2": ("mamba2-370m", "2x2"),
             "qwen2-vl-7b@2x2": ("qwen2-vl-7b", "2x2"),
             "fallback@2x2": ("fallback", "2x2")}
GNN_ARGV = ["--arch", "graphsage", "--dataset", "reddit", "--steps", "2",
            "--batch", "8", "--fanouts", "3,2", "--log-every", "1",
            "--devices", "4", "--mesh", "2x2"]
CKPT_ARGV = ["--arch", "qwen2-0.5b"] + LM_ARGV


def _lm_argv(config: str, mesh: str) -> tuple[list, dict | None]:
    arch, derived = CONFIGS[config]
    return ["--arch", arch, "--mesh", mesh] + LM_ARGV, derived


# the reference on 4 placeholder devices: each leaf's block on each
# device of the (1, 2) and (2, 2) meshes, then the launcher runs (a
# derived config through a patched get_config), their stdout kept
REF_SCRIPT = r"""
import contextlib, dataclasses, io, json, os, sys, types
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
out_path, spec = sys.argv[1], json.loads(sys.argv[2])
import jax, numpy as np
from jax.sharding import Mesh
from repro.distributed.sharding import ShardingRules
from repro.launch import train as launcher
from repro.models import registry
from repro.models.params import param_shardings
from repro.models.transformer import build_defs

real = registry.get_config

def config(arch, derived):
    cfg = real(arch).reduced()
    return dataclasses.replace(cfg, **derived) if derived else cfg

def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], prefix + k + "/")]
    return [(prefix[:-1], tree)]

out = {"shards": {}, "logs": {}}
rules = ShardingRules.default()
for shape in ((1, 2), (2, 2)):
    mesh = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    for name, (arch, derived) in spec["configs"].items():
        defs = build_defs(config(arch, derived))
        sh = dict(leaves(param_shardings(defs, rules, mesh)))
        d = dict(leaves(defs, ""))
        got = {}
        for leaf, s in sh.items():
            m = s.devices_indices_map(d[leaf].shape)
            got[leaf] = [[[sl.start or 0, d[leaf].shape[i] if sl.stop is None
                           else sl.stop] for i, sl in enumerate(m[dev])]
                         for dev in mesh.devices.reshape(-1)]
        out["shards"][f"{name}@{shape[0]}x{shape[1]}"] = got
for name, (argv, arch, derived) in spec["runs"].items():
    registry.get_config = (real if not derived else
                           (lambda _a, c=config(arch, derived): types.SimpleNamespace(
                               family=c.family, reduced=lambda: c)))
    sys.argv = ["train"] + argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launcher.main()
    out["logs"][name] = buf.getvalue()
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="2",
                XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")


def _losses(log: str) -> list:
    return [float(line.split("loss=")[1].split()[0])
            for line in log.splitlines() if "loss=" in line]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    spec = {"configs": {k: list(v) for k, v in CONFIGS.items()},
            "runs": {}}
    for name, (config, mesh) in LOSS_RUNS.items():
        argv, derived = _lm_argv(config, mesh)
        spec["runs"][name] = [argv + ["--devices", "4"],
                              CONFIGS[config][0], derived]
    for backend in ("pallas", "isp"):
        spec["runs"][f"gnn-{backend}"] = [GNN_ARGV + ["--backend", backend],
                                          "graphsage", None]
    ref_path = tmp / "ref.json"
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(ref_path), json.dumps(spec)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, preexec_fn=lambda: os.nice(10))
    try:
        grads = {shape: [(f"{n}@{shape}", a, d, shape)
                         for n, (a, d) in CONFIGS.items()]
                 for shape in ((1, 2), (2, 2))}
        decode = [(f"{n}/{dt}/{extra}", *CONFIGS[n], dt, extra)
                  for n, dt, extra in DECODE_CASES]
        lm_runs = {w: {name: _lm_argv(*LOSS_RUNS[name])
                       for name in LOSS_RUNS
                       if (w == 4) == LOSS_RUNS[name][1].startswith("2")}
                   for w in (2, 4)}
        lm_runs[2]["uninterrupted"] = (["--mesh", "1x2"] + CKPT_ARGV, None)
        d = {k: str(tmp / k) for k in ("c12", "c12_one", "c21")}
        ckpt = {"save12": (["--mesh", "1x2"] + _steps(CKPT_ARGV, 2), None,
                           d["c12"], d["c12_one"]),
                "resume21": (["--mesh", "2x1"] + CKPT_ARGV, None, d["c12"],
                             None),
                "save21": (["--mesh", "2x1"] + _steps(CKPT_ARGV, 2), None,
                           d["c21"], None),
                "resume12": (["--mesh", "1x2"] + CKPT_ARGV, None, d["c21"],
                             None)}
        two = ranks.run_ranks(ranks.tp_task, 2, tmp / "w2", grads[(1, 2)],
                              decode, lm_runs[2], ckpt,
                              timeout_s=RANKS_TIMEOUT_S)
        four = ranks.run_ranks(ranks.tp_task, 4, tmp / "w4", grads[(2, 2)],
                               [], lm_runs[4], {}, timeout_s=RANKS_TIMEOUT_S)
        one_resumed = port_train.main(CKPT_ARGV + ["--device", "cpu",
                                                   "--ckpt-dir",
                                                   d["c12_one"]])
        gnn = {b: port_train.main(GNN_ARGV + ["--backend", b, "--device",
                                               "cpu"])[1]
               for b in ("pallas", "isp")}
        _, err = ref.communicate(timeout=RANKS_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with open(ref_path) as f:
        want = json.load(f)
    # the shards of every rank, the rest of rank 0
    shards = {k: [r["grads"][k].pop("shards") for r in world]
              for world in (two, four) for k in world[0]["grads"]}
    return {"grads": {**two[0]["grads"], **four[0]["grads"]},
            "shards": shards, "decode": two[0]["decode"],
            "runs": {**two[0]["runs"], **four[0]["runs"]},
            "one_resumed": one_resumed, "gnn": gnn, "ref": want}


def _steps(argv: list, n: int) -> list:
    argv = list(argv)
    argv[argv.index("--steps") + 1] = str(n)
    return argv


@pytest.fixture(scope="module")
def one_process():
    """Every config's one-process float32 logits, loss and gradients on
    the test's global batch (through ``build_train_step``)."""
    saved = transformer.COMPUTE_DTYPE
    transformer.COMPUTE_DTYPE = torch.float32
    out = {}
    try:
        for name, (arch, derived) in CONFIGS.items():
            cfg = ranks.tp_config(arch, derived)
            model = LM(cfg, device="cpu", trainable=True)
            batch = ranks.tp_batch(cfg, torch.float32)
            with torch.no_grad():
                logits = model(batch)[0]
            rec = ranks._Recording()
            step = build_train_step(model, rec.opt)
            _, m = step(init_train_state(model, rec.opt), batch)
            out[name] = {"logits": logits, "loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "grads": dict(zip(ranks._names(model.defs),
                                           tree_leaves(rec.grads))),
                         "params": dict(zip(ranks._names(model.defs),
                                            tree_leaves(model.param_tree())))}
    finally:
        transformer.COMPUTE_DTYPE = saved
    return out


GRAD_CASES = [(n, s) for s in ("1x2", "2x2") for n in CONFIGS]


@pytest.mark.parametrize("name,shape", GRAD_CASES)
def test_every_leaf_gradient_matches_one_process(runs, one_process, name,
                                                 shape):
    got = runs["grads"][f"{name}@{tuple(int(x) for x in shape.split('x'))}"]
    want = one_process[name]
    rows = ranks.TP_B // int(shape[0])
    lg = want["logits"][:rows]
    assert float((got["logits"] - lg).abs().max()) <= \
        F32_LOGIT_TOL * float(lg.abs().max())
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    tol = {"seamless-m4t-large-v2": GRAD_TOL_NEAR_ARGMAX,
           "expert-ffn": GRAD_TOL_FFN_SPLIT}.get(name, GRAD_TOL)
    # AdamW's global norm over the shards counts each leaf once
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        tol * want["grad_norm"]
    got_g = dict(zip(ranks._names(build_defs(ranks.tp_config(
        *CONFIGS[name]))), tree_leaves(got["grads"])))
    assert sorted(got_g) == sorted(want["grads"])
    for leaf, g in want["grads"].items():
        err = float((got_g[leaf] - g).norm() / max(float(g.norm()), 1e-30))
        assert err <= tol, (leaf, err)


@pytest.mark.parametrize("name,shape", GRAD_CASES)
def test_each_rank_holds_the_reference_block(runs, one_process, name,
                                             shape):
    """Rank r's shard of every parameter in the train state is the block
    of the whole leaf that the reference's ``NamedSharding`` puts on
    device r (the mesh position r in row-major order)."""
    key = f"{name}@{tuple(int(x) for x in shape.split('x'))}"
    want = runs["ref"]["shards"][f"{name}@{shape}"]
    per_rank = runs["shards"][key]
    assert len(per_rank) == int(shape[0]) * int(shape[-1])
    for r, shards in enumerate(per_rank):
        assert sorted(shards) == sorted(want)
        for leaf, (spec, local) in shards.items():
            whole = one_process[name]["params"][leaf]
            index = tuple(slice(lo, hi) for lo, hi in want[leaf][r])
            assert torch.equal(local, whole[index]), (r, leaf, spec)


@pytest.mark.parametrize("name,shape", GRAD_CASES)
def test_carried_params_are_the_drawn_shards(runs, name, shape):
    """``convert.lm_params_from_jax(tree, tp=model.tp)`` of a whole tree
    gives each rank the shards that ``LM(..., mesh=)`` draws as blocks of
    the seed's leaves, bit for bit."""
    key = f"{name}@{tuple(int(x) for x in shape.split('x'))}"
    assert runs["grads"][key]["carried_equal_drawn"]


def test_fallback_layouts(runs):
    """The derived configs' layouts: "fallback" keeps q heads, kv heads
    and the vocab whole at M 2 and splits the SSM heads and ``mlp``;
    "expert-ffn" keeps its 3 experts whole and splits each one's hidden
    dim;
    "pick" splits its 6 q heads and keeps its 3 kv heads (each rank's
    attention reads all 3, one a q head: not a block of whole groups);
    gemma3-1b splits its 4 q heads and keeps its 1 kv head."""
    fb = runs["grads"]["fallback@(1, 2)"]
    assert fb["tp"]["wq"] is None and fb["tp"]["wk"] is None
    assert fb["tp"]["embed"] is None and fb["tp"]["unembed"] is None
    assert fb["tp"]["A_log"] == 1 and fb["tp"]["w_gate"] == 2
    pick = runs["grads"]["pick@(1, 2)"]
    assert pick["tp"]["wq"] == 2 and pick["tp"]["wk"] is None
    assert pick["kv_heads"] == 3
    g3 = runs["grads"]["gemma3-1b@(1, 2)"]
    assert g3["tp"]["wq"] == 2 and g3["tp"]["wk"] is None
    assert g3["kv_heads"] == 1
    ffn = runs["grads"]["expert-ffn@(1, 2)"]
    assert ffn["tp"]["w_gate"] == 3 and ffn["tp"]["w_down"] == 2
    assert ffn["tp"]["router"] is None


@pytest.mark.parametrize("name", list(LOSS_RUNS))
def test_launcher_losses_match_the_reference(runs, name):
    got = runs["runs"][name]["losses"]
    want = _losses(runs["ref"]["logs"][name])
    assert len(got) == len(want) == STEPS
    assert abs(got[0] - want[0]) <= STEP1_TOL, (got, want)
    for a, b in zip(got[1:], want[1:]):
        assert abs(a - b) <= LOSS_TOL, (got, want)
    assert runs["runs"][name]["mesh"] == tuple(
        int(x) for x in LOSS_RUNS[name][1].split("x"))


DECODE_CASES = [(n, dt, extra) for n in DECODE_CONFIGS
                for dt in ("float32", "bfloat16") for extra in (0, 1)
                if (dt == "float32" or n in BF16_DECODE)
                and (extra == 0 or n != "mamba2-370m")]


@pytest.mark.parametrize("name,dtype,extra", DECODE_CASES)
def test_decode_matches_one_process(runs, name, dtype, extra):
    """``extra`` 0: prompt + generation (20) divides M, the cache splits
    on S; 1: it does not, the decode kernel's plain version runs on the
    rank's heads."""
    got = runs["decode"][f"{name}/{dtype}/{extra}"]
    saved = transformer.COMPUTE_DTYPE
    transformer.COMPUTE_DTYPE = getattr(torch, dtype)
    try:
        cfg = ranks.tp_config(*CONFIGS[name])
        params = init_params(build_defs(cfg), seed=0)
        if dtype == "bfloat16":
            params = cast_tree(params, torch.bfloat16)
        from repro_torch.launch.shapes import make_batch
        batch = ranks.as_inputs(make_batch(cfg, 2, ranks.TP_PROMPT,
                                           kind="prefill"),
                                transformer.COMPUTE_DTYPE)
        ids, logits, cache = ranks.tp_decode(
            LM(cfg, params, device="cpu"), cfg, batch, ranks.TP_PROMPT,
            ranks.TP_GEN, ranks.TP_PROMPT + ranks.TP_GEN + extra)
    finally:
        transformer.COMPUTE_DTYPE = saved
    assert got["split"] == (extra == 0 and "k" in cache)
    assert torch.equal(got["ids"], ids)
    err = float((got["logits"] - logits).abs().max())
    if dtype == "float32":
        tol = GRAD_TOL_NEAR_ARGMAX if name == "seamless-m4t-large-v2" \
            else F32_LOGIT_TOL
        assert err <= tol * float(logits.abs().max()), err
    else:
        assert err <= BF16_LOGIT_TOL, err


def test_checkpoints_resume_across_mesh_shapes(runs):
    """Written at (1, 2): resumed at (2, 1) and at one process; written
    at (2, 1): resumed at (1, 2); each logs the uninterrupted (1, 2)
    run's last steps."""
    full = runs["runs"]["uninterrupted"]["losses"]
    assert runs["runs"]["save12"]["losses"] == pytest.approx(full[:2],
                                                             abs=1e-6)
    for resumed in (runs["runs"]["resume21"], runs["one_resumed"],
                    runs["runs"]["resume12"]):
        assert len(resumed["losses"]) == STEPS - 2
        for a, b in zip(resumed["losses"], full[2:]):
            assert abs(a - b) <= LOSS_TOL, (resumed["losses"], full)
    assert runs["runs"]["resume21"]["mesh"] == (2, 1)
    assert runs["runs"]["resume12"]["mesh"] == (1, 2)


@pytest.mark.parametrize("backend", ["pallas", "isp"])
def test_gnn_on_a_2x2_mesh_logs_the_reference_losses(runs, backend):
    got = runs["gnn"][backend]
    want = _losses(runs["ref"]["logs"][f"gnn-{backend}"])
    assert len(got) == len(want) == 2
    assert abs(got[0] - want[0]) <= STEP1_TOL, (got, want)
    assert abs(got[1] - want[1]) <= LOSS_TOL, (got, want)


def test_an_lm_on_a_model_axis_needs_a_tensor_parallel_model():
    """A whole-weight LM refuses a train state on a mesh whose ``model``
    axis splits leaves (its parameters would be taken for shards)."""
    from repro_torch.train.steps import _check_layout

    model = LM(ranks.tp_config("qwen2-0.5b"), device="cpu", trainable=True)
    with pytest.raises(ValueError, match="LM\\(..., mesh=mesh\\)"):
        _check_layout(model, {"data": 1, "model": 2})
    _check_layout(model, {"data": 2, "model": 1})
