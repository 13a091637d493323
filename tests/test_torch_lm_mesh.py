"""The port's LM on a process mesh, on 2 gloo ranks on the CPU, against
the reference's runs on placeholder CPU devices and the port's own run
on one process.

- ``--devices 2`` training of qwen2-0.5b reduced (batch 8, 2
  microbatches): losses against the reference launcher's ``--devices 2``
  run, step 1 within 2e-3 and later steps within 3e-2 (the two
  frameworks round their bf16 activations at different places, as
  ``tests/test_torch_init.py`` states), and against the port's one-rank
  run within the same (its gap is printed); each rank holds the shard of
  every parameter and AdamW moment that the reference's rules give.
- moonshot-v1-16b-a3b reduced at 2 ranks, global dispatch: losses as
  above; on equal inputs, the kept assignments, expert ids and aux loss
  of each rank's rows equal one rank's routing of the whole batch.
- the microbatch row order: each rank's rows are those the reference's
  ``(mb, B / mb)`` reshape sharded over ``data`` puts on its device.
- microbatches whose rows the data ranks do not divide (the reference
  trains wherever the ranks and the microbatches each divide the batch):
  the layout over every such (B <= 64, mb, D) puts each row on one rank
  in passes of one size, each microbatch in one pass of its ranks; qwen2
  at 2 ranks (batch 6, 2 microbatches) and qwen2 and moonshot at 4 ranks
  (a second session, 1 thread a rank; batch 8, 4 microbatches) log the
  reference's losses within the tolerances above, and at 4 ranks each
  microbatch's routing by the 2 ranks that hold it equals one process's
  routing of that microbatch alone.
- MoE dispatch groups over the ranks that hold a microbatch, where a
  group straddles two ranks, spans several, or lies whole on one (2
  ranks at G 3 and 4, 4 ranks at G 2 and 6, the side-by-side layout at
  G 2 and 3): the ranks' keep flags, expert ids, slot tables (rebuilt at
  their offsets) and aux loss equal one process's routing of the
  microbatch; a rank's place in the token order is its rank in the
  sub-group; one float32 step at G 3 on a (2, 2) mesh against the
  reference's train step and one process's gradients.
- the sequence-sharded decode at M 2 against the reference's
  ``sharded_decode_attention`` on a (1, 2) mesh within 1e-5 (float32
  partials, different summation order), with a step whose position lies
  before rank 1's slice (rank 1 adds nothing) and a window that leaves
  rank 0's slice out; the caches each rank writes bit-equal.  Greedy
  serving of gemma3-1b reduced through ``build_serve_step(model, mesh)``
  against one process: ids equal, logits within 0.05.
- checkpoints: one written at 2 ranks resumes at 1 and one written at 1
  resumes at 2 (losses within 3e-2 of the uninterrupted run), and a
  restore with placements gives each rank its slice of the stored array
  bit for bit (the twin of the reference's
  ``test_elastic_restore_across_mesh_shapes``).
- the example twins (the reference's runs all in one subprocess on 2
  placeholder devices): ``examples/train_lm_torch.py`` against
  ``examples/train_lm.py`` (10 steps; losses within 3e-2) and
  ``examples/serve_decode_torch.py`` against ``examples/serve_decode.py``
  (ids equal up to near-ties of their bf16 logits: at most 2 of their
  32 differ).
"""

import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro_torch.distributed.sharding import ShardingRules, logical_to_spec
from repro_torch.launch import train
from repro_torch.launch.shapes import make_batch
from repro_torch.models import moe
from repro_torch.models.params import init_params, tree_leaves
from repro_torch.models.registry import get_config
from repro_torch.models.transformer import LM, build_defs
from repro_torch.train.steps import build_prefill_step, build_serve_step

ROOT = Path(__file__).resolve().parents[1]
STEP1_TOL, LOSS_TOL = 2e-3, 3e-2
SERVE_LOGIT_TOL = 0.05
TWIN_STEPS = 10

# reference runs in one process on 2 placeholder devices: the sharded
# decode and the batch rows (into the npz, if one is named), then each of
# the runs named (the launcher or an example), its stdout kept
REF_SCRIPT = r"""
import contextlib, io, json, os, runpy, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
out_npz, tests, root, runs = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, tests)
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import _torch_mesh_ranks as ranks
from repro.models.attention import sharded_decode_attention

out = {}
if out_npz.endswith(".npz"):
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    fn = jax.jit(sharded_decode_attention(mesh, batch_axes=None))
    (ck, cv), steps = ranks.decode_inputs()
    ck, cv = jnp.asarray(ck), jnp.asarray(cv)
    for i, ((pos, window), (q, nk, nv)) in enumerate(zip(
            ranks.DECODE["steps"], steps)):
        o, ck, cv = fn(jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), ck, cv,
                       jnp.int32(pos), jnp.int32(window))
        out[f"out{i}"] = np.asarray(o)
    out["k"], out["v"] = np.asarray(ck), np.asarray(cv)
    # the rows each device of a (2, 1) mesh holds: the train step's batch
    # sharding, and its (mb, B / mb) reshape with the second dim on 'data'
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    rows = np.arange(8)
    for mb in (1, 2):
        x = jax.device_put(rows.reshape(mb, 8 // mb),
                           NamedSharding(mesh, P(None, "data")))
        for s in x.addressable_shards:
            out[f"rows_mb{mb}_dev{s.device.id}"] = np.asarray(s.data).reshape(-1)
    np.savez(out_npz, **out)

from repro.launch import train as launcher
logs = {}
for name, argv in json.loads(runs).items():
    sys.argv = argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if argv[0].endswith(".py"):
            runpy.run_path(os.path.join(root, argv[0]), run_name="__main__")
        else:
            launcher.main()
    logs[name] = buf.getvalue()
with open(out_npz + ".json", "w") as f:
    json.dump(logs, f)
"""


def _env():
    """The subprocesses' environment: few threads each (two of them run
    at once beside the ranks; the suite's other workers share the
    cores)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    return env


def _start(args):
    """A subprocess, niced by 10: the suite's other workers (and the
    servers their tests wait on) come first."""
    return subprocess.Popen([sys.executable] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(),
                            cwd=ROOT, preexec_fn=lambda: os.nice(10))


def _finish(proc, timeout=400):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (out[-3000:], err[-3000:])
    return out


def _losses(stdout: str) -> list:
    return [float(line.split("loss=")[1].split()[0])
            for line in stdout.splitlines() if "loss=" in line]


def _ids(stdout: str) -> list:
    return [json.loads(line.split(":", 1)[1]) for line in stdout.splitlines()
            if line.strip().startswith("seq")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of this module: the reference's (two subprocesses,
    started first), the 2 ranks (which also run the training example's
    twin on their group), and the port's one-rank runs and the serving
    example's twin (in this process)."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    ref_npz = tmp / "ref.npz"
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    launcher = ["repro.launch.train", "--devices", "2", "--steps", "3"]
    ref_runs = {"ref_qwen": launcher + ranks.QWEN_ARGV,
                "ref_moe": launcher + ranks.MOE_ARGV}
    ref_examples = {"ref_train_ex": ["examples/train_lm.py", "qwen2-0.5b",
                                     str(TWIN_STEPS)],
                    "ref_serve_ex": ["examples/serve_decode.py"]}
    # the side-by-side microbatches' runs (the reference's losses do not
    # depend on its mesh: 2 placeholder devices stand for 4)
    ref_side = {"ref_qwen_side": launcher + ranks.QWEN_SIDE_ARGV}
    ref_side.update({"ref_" + k: launcher + v
                     for k, v in ranks.SIDE_ARGV.items()})
    procs = {
        "ref": _start(["-c", REF_SCRIPT, str(ref_npz), str(ROOT / "tests"),
                       str(ROOT), json.dumps(ref_runs)]),
        "ref_ex": _start(["-c", REF_SCRIPT, str(tmp / "examples"),
                          str(ROOT / "tests"), str(ROOT),
                          json.dumps(ref_examples)]),
        "ref_side": _start(["-c", REF_SCRIPT, str(tmp / "side"),
                            str(ROOT / "tests"), str(ROOT),
                            json.dumps(ref_side)]),
    }
    try:
        ckpt_in, ckpt_out = str(tmp / "ckpt_1rank"), str(tmp / "ckpt_2rank")
        one = {"saved": ranks._train(ranks.QWEN_ARGV + [
            "--steps", "2", "--ckpt-dir", ckpt_in])}
        # both sessions at this worker's own priority: niced by 10 under
        # the whole suite's load, the 2-rank one ran about 10x slower and
        # outlasted its join guard
        on = ranks.run_ranks(ranks.lm_mesh_task, 2, tmp / "ranks",
                             ckpt_in, ckpt_out, str(ROOT), TWIN_STEPS,
                             nice=0)
        # the 4-rank session (1 thread a rank) once the 2-rank one has
        # ended, beside this process's one-rank runs
        with ThreadPoolExecutor(1) as pool:
            side = pool.submit(ranks.run_ranks, ranks.side_task, 4,
                               tmp / "ranks4", threads=1, nice=0)
            one["qwen"] = ranks._train(ranks.QWEN_ARGV + ["--steps", "3"])
            one["four"] = ranks._train(ranks.QWEN_ARGV + ["--steps", "4"])
            one["resumed"] = ranks._train(ranks.QWEN_ARGV + [
                "--steps", "4", "--ckpt-dir", ckpt_out])
            one["moonshot"] = ranks._train(ranks.MOE_ARGV + ["--steps", "3"])
            four = side.result()
        outs = {k: _finish(p) for k, p in procs.items()}
        outs["train_ex"] = on[0]["train_ex"]
        outs["serve_ex"] = ranks.run_example(str(ROOT), [
            "examples/serve_decode_torch.py", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    with np.load(ref_npz) as z:
        ref = dict(z)
    for logs in ("ref.npz.json", "examples.json", "side.json"):
        outs.update(json.loads((tmp / logs).read_text()))
    return {"ranks": on, "four": four, "one": one, "out": outs, "ref": ref,
            "ckpt_in": ckpt_in}


def _close(got, want, what):
    assert len(got) == len(want), (what, got, want)
    assert abs(got[0] - want[0]) <= STEP1_TOL, (what, got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL,
                               err_msg=what)


def test_two_ranks_train_as_the_references_devices_2(runs):
    got = runs["ranks"][0]["qwen"]
    assert runs["ranks"][1]["qwen"] is None        # rank 0 reports
    assert got["world"] == 2 and tuple(got["mesh"]) == (2, 1)
    want = _losses(runs["out"]["ref_qwen"])
    _close(got["losses"], want, "port --devices 2 vs reference --devices 2")
    one = runs["one"]["qwen"]["losses"]
    _close(got["losses"], one, "port --devices 2 vs port --devices 1")
    print(f"[lm_mesh] qwen2 losses: 2 ranks {got['losses']}, 1 rank {one}, "
          f"reference {want}; largest gap to the reference "
          f"{max(abs(a - b) for a, b in zip(got['losses'], want)):.4g}")


def test_each_rank_holds_the_rules_shard_of_every_leaf(runs):
    defs = tree_leaves(build_defs(get_config("qwen2-0.5b").reduced()))
    rules = ShardingRules.default()
    want = []
    for d in defs:
        spec = logical_to_spec(d.logical_axes, rules,
                               {"data": 2, "model": 1}, d.shape)
        shape = list(d.shape)
        for dim, s in enumerate(spec):
            if s == "data":
                shape[dim] //= 2
        want.append(tuple(shape))
    assert any(w != d.shape for w, d in zip(want, defs))
    for got in runs["ranks"]:
        for part in ("params", "m", "v"):
            assert got["shards"][part] == want, part


def test_moe_two_ranks_route_and_train_as_one(runs):
    """Global dispatch: each rank's rows keep the assignments, take the
    experts and give the aux loss that one rank's routing of the whole
    batch does (some assignments dropped, so the offsets matter)."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    router = init_params(build_defs(cfg), seed=0)["blocks"]["router"][0]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (ranks.ROUTE["B"], ranks.ROUTE["S"], cfg.d_model))
        .astype(np.float32))
    whole = moe.route(router, x, top_k=cfg.experts_per_token,
                      capacity_factor=ranks.ROUTE["capacity_factor"],
                      routing=cfg.routing)
    assert not bool(whole.keep.all())
    keep = torch.cat([r["route"]["keep"] for r in runs["ranks"]], dim=1)
    idx = torch.cat([r["route"]["expert_idx"] for r in runs["ranks"]], 1)
    assert torch.equal(keep, whole.keep)
    assert torch.equal(idx, whole.expert_idx)
    for r in runs["ranks"]:
        torch.testing.assert_close(r["route"]["aux"], whole.aux, rtol=1e-6,
                                   atol=0)
    got = runs["ranks"][0]["moonshot"]["losses"]
    _close(got, _losses(runs["out"]["ref_moe"]),
           "moonshot 2 ranks vs reference --devices 2")
    _close(got, runs["one"]["moonshot"]["losses"],
           "moonshot 2 ranks vs 1 rank")


def test_microbatch_rows_are_the_references(runs):
    from repro_torch.data.tokens import rank_rows

    for mb in (1, 2):
        for rank in range(2):
            np.testing.assert_array_equal(
                rank_rows(8, rank, 2, mb),
                runs["ref"][f"rows_mb{mb}_dev{rank}"])
    np.testing.assert_array_equal(rank_rows(8, 1, 2, 2), [2, 3, 6, 7])
    # 4 ranks do not divide 6 rows: the reference's device_put fails too
    with pytest.raises(ValueError):
        rank_rows(6, 0, 4, 1)


@pytest.mark.parametrize("D", (1, 2, 3, 4, 6, 8))
def test_microbatch_layout_puts_each_row_on_one_rank(D):
    """Every (B <= 64, mb) that the reference trains on D data ranks (D and
    mb each divide B): each row lies on exactly one rank, every pass has
    the same size, each microbatch's rows lie in one pass on ``share``
    ranks, and where D divides a microbatch's rows they are the rows of
    the layout before microbatches ran side by side."""
    from repro_torch.data.tokens import microbatch_layout, rank_rows

    for B in range(D, 65, D):
        for mb in (n for n in range(1, B + 1) if B % n == 0):
            m = B // mb
            lay = microbatch_layout(B, mb, D)
            assert lay.share * lay.side == D and lay.side * lay.passes == mb
            rows = [rank_rows(B, r, D, mb) for r in range(D)]
            assert all(len(x) == lay.passes * lay.rows for x in rows)
            np.testing.assert_array_equal(np.sort(np.concatenate(rows)),
                                          np.arange(B))
            # (rank, pass) of each row
            owner = {int(row): (r, n // lay.rows)
                     for r in range(D) for n, row in enumerate(rows[r])}
            for j in range(mb):
                holders = {owner[row] for row in range(j * m, (j + 1) * m)}
                assert len(holders) == lay.share
                assert len({i for _, i in holders}) == 1
            if m % D == 0:
                per = m // D
                for r in range(D):
                    np.testing.assert_array_equal(rows[r], np.concatenate([
                        np.arange(j * m + r * per, j * m + (r + 1) * per)
                        for j in range(mb)]))
    with pytest.raises(ValueError, match="microbatches"):
        microbatch_layout(6 * D, 4 * 6 * D + 1, D)
    if D > 1:
        with pytest.raises(ValueError, match="data ranks"):
            microbatch_layout(D + 1, 1, D)


def test_two_ranks_run_microbatches_side_by_side(runs):
    """--batch 6 --microbatches 2 at 2 ranks: each rank runs one of the
    reference's 3-row microbatches, routed locally."""
    got = runs["ranks"][0]["qwen_side"]
    assert got["world"] == 2
    _close(got["losses"], _losses(runs["out"]["ref_qwen_side"]),
           "port --devices 2 --batch 6 vs reference")


@pytest.mark.parametrize("name", ranks.SIDE_ARGV)
def test_four_ranks_share_microbatches_as_the_reference(runs, name):
    """--batch 8 --microbatches 4 at 4 ranks: 2 ranks a 2-row microbatch,
    2 passes of one row a rank; losses against the reference's."""
    got = runs["four"][0][name]
    assert [r[name] for r in runs["four"][1:]] == [None] * 3
    assert got["world"] == 4 and tuple(got["mesh"]) == (4, 1)
    _close(got["losses"], _losses(runs["out"]["ref_" + name]),
           f"port 4 ranks vs reference: {name}")


def test_four_ranks_route_each_microbatch_as_one(runs):
    """Each of the reference's microbatches is one dispatch group on the
    ranks that hold it: their kept assignments, expert ids and aux loss
    equal one process's routing of that microbatch alone (some
    assignments dropped, so the offsets between the ranks matter)."""
    r = ranks.ROUTE_SIDE
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    router = init_params(build_defs(cfg), seed=0)["blocks"]["router"][0]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (r["B"], r["S"], cfg.d_model)).astype(np.float32))
    four = runs["four"]
    lay = four[0]["layout"]
    assert tuple(lay) == (2, 2, 2, 1)
    m, dropped = r["B"] // r["mb"], 0
    for j in range(r["mb"]):
        whole = moe.route(router, x[j * m:(j + 1) * m],
                          top_k=cfg.experts_per_token,
                          capacity_factor=r["capacity_factor"],
                          routing=cfg.routing)
        dropped += int((~whole.keep).sum())
        s, i = j % lay.side, j // lay.side
        holders = four[s * lay.share:(s + 1) * lay.share]
        for t, h in enumerate(holders):
            np.testing.assert_array_equal(
                h["rows"][i * lay.rows:(i + 1) * lay.rows],
                np.arange(j * m + t * lay.rows, j * m + (t + 1) * lay.rows))
        for key in ("keep", "expert_idx"):
            assert torch.equal(torch.cat([h["route"][i][key]
                                          for h in holders], dim=1),
                               getattr(whole, key)), (j, key)
        for h in holders:
            torch.testing.assert_close(h["route"][i]["aux"], whole.aux,
                                       rtol=1e-6, atol=0)
    assert dropped > 0


def _routes_as_one(parts: list, whole, what: str) -> None:
    """The routes of a microbatch's ranks (``parts``, in its token order)
    are one process's routing ``whole`` of it: the kept assignments and
    expert ids of each rank's tokens, the slot table that its parts'
    tables make at their offsets, and the aux loss."""
    k = whole.expert_idx.shape[-1]
    G, E, C = whole.slot_tok.shape
    T = whole.expert_idx.numel() // k
    Tg, Tl = T // G, T // len(parts)
    assert torch.equal(torch.cat([p["keep"].reshape(-1) for p in parts]),
                       whole.keep.reshape(-1)), what
    assert torch.equal(torch.cat([p["expert_idx"].reshape(-1, k)
                                  for p in parts]),
                       whole.expert_idx.reshape(-1, k)), what
    slots = torch.full((G, E, C), Tg, dtype=torch.int64)
    for t, p in enumerate(parts):
        first = p["first"].tolist()
        for j, (f, end) in enumerate(zip(first, first[1:] + [Tl])):
            g = (t * Tl + f) // Tg
            for e in range(E):
                ids = p["slot_tok"][j, e]
                o = 0 if p["offset"] is None else int(p["offset"][j, e])
                n = int((ids < end - f).sum())
                # a part's tokens fill its table from slot 0, at their
                # global positions from its offset on, and no other's
                assert bool((ids[:n] < end - f).all()) and o + n <= C, what
                assert bool((slots[g, e, o:o + n] == Tg).all()), what
                slots[g, e, o:o + n] = ids[:n] + t * Tl + f - g * Tg
    assert torch.equal(slots, whole.slot_tok), what
    for p in parts:
        torch.testing.assert_close(p["aux"], whole.aux, rtol=1e-6, atol=0)


# (session, ROUTE_GROUPS case, G): each rank's share of a microbatch
ROUTE_GROUP_CASES = [(w, w, G) for w in (2, 4)
                     for G in ranks.ROUTE_GROUPS[w]["groups"]] + [
    (4, "side", G) for G in ranks.ROUTE_GROUPS["side"]["groups"]]


@pytest.mark.parametrize("world,case,G", ROUTE_GROUP_CASES,
                         ids=[f"{w}ranks-{c}-G{G}"
                              for w, c, G in ROUTE_GROUP_CASES])
def test_dispatch_groups_spanning_ranks_route_as_one(runs, world, case, G):
    """``groups`` G over the ranks that hold a microbatch, wherever its
    groups start and end (a group straddling two ranks, spanning several,
    or whole on each): the ranks' routings together are one process's
    routing of the microbatch at G, with some assignments dropped."""
    c = ranks.ROUTE_GROUPS[case]
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    router, x = ranks.route_groups_inputs(c)
    got = runs["ranks"] if world == 2 else runs["four"]
    key = "route_groups_side" if case == "side" else "route_groups"
    mb = c.get("mb", 1)
    m = c["B"] // mb
    dropped = 0
    for j in range(mb):
        whole = moe.route(router, x[j * m:(j + 1) * m],
                          top_k=cfg.experts_per_token, capacity_factor=1.0,
                          routing=cfg.routing, groups=G)
        assert whole.slot_tok.shape[0] == G
        dropped += int((~whole.keep).sum())
        if mb == 1:
            parts = [r[key][G][0] for r in got]
        else:
            # microbatch j: pass j // 2 of ranks 2 (j % 2) and 2 (j % 2) + 1
            s, i = j % 2, j // 2
            parts = [r[key][G][i] for r in got[2 * s:2 * s + 2]]
        _routes_as_one(parts, whole, f"microbatch {j}")
    assert dropped > 0


def test_a_ranks_place_in_the_token_order_is_its_sub_group_rank(runs):
    """A rank's place in the layout's pod-major order of the batch axes
    (``data.tokens.rank_rows``' rank) and its rank in the sorted process
    sub-group of ``microbatch_group`` (the place ``moe.route`` takes)
    agree on (4, 1) and on (2, 2, 1) over ("pod", "data", "model")."""
    orders = [r["order"] for r in runs["four"]]
    assert len(orders[0]) == 4
    for key in orders[0]:
        assert [o[key][0] for o in orders] == [o[key][1] for o in orders]
        assert sorted(o[key][1] for o in orders) == sorted(
            list(range(key[1])) * (4 // key[1]))


def test_moe_two_ranks_train_step_at_three_groups(runs, host_mesh, rules,
                                                  monkeypatch):
    """One float32 train step of moonshot reduced at ``moe_groups`` 3 on 2
    data ranks (group 1 straddles them; some assignments dropped), each
    splitting the experts with a second ``model`` rank (the (2, 2)
    mesh): its loss and aux within 1e-5 relative and its grad norm within
    1e-4 of the reference's train step from the same weights and batch
    (``tests/test_torch_moe.py``'s bounds), and every leaf's gradient
    within 1e-5 relative L2 of one process's (``tests/test_torch_tp.py``'s
    mesh bound)."""
    import jax
    import jax.numpy as jnp

    import repro.models.transformer as jtransformer
    from repro.launch.shapes import make_batch as jmake_batch
    from repro.models.registry import get_config as jget_config
    from repro.optim import adamw as jadamw
    from repro.optim import warmup_cosine as jwarmup_cosine
    from repro.train.steps import build_train_step as jbuild_train_step
    from repro_torch.models.params import tree_map

    step = ranks.MOE_STEP
    got = runs["four"][0]["moe_step"]
    one = ranks.moe_step()
    cfg = ranks.moe_step_config()
    jcfg = dataclasses.replace(jget_config(step["arch"]).reduced(),
                               **step["derived"])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    monkeypatch.setattr(jtransformer, "COMPUTE_DTYPE", jnp.float32)
    jmodel = jtransformer.LM(jcfg)
    jparams = tree_map(lambda t: jnp.asarray(t.numpy()),
                       init_params(build_defs(cfg), seed=0))
    jopt = jadamw(jwarmup_cosine(1e-3, 10, 50))
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    batch = jmake_batch(jcfg, step["B"], step["S"], kind="train")
    for k, v in make_batch(cfg, step["B"], step["S"], kind="train").items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(batch[k]))
    with host_mesh:
        _, want = jax.jit(jbuild_train_step(jmodel, jopt, host_mesh,
                                            rules))(jstate, batch)
    assert float(want["moe_aux"]) > 0
    for k in ("loss", "moe_aux", "grad_norm"):
        rel = 1e-4 if k == "grad_norm" else 1e-5
        assert got[k] == pytest.approx(float(want[k]), rel=rel), k
        assert one[k] == pytest.approx(float(want[k]), rel=rel), k
    assert sorted(got["grads"]) == sorted(one["grads"])
    for leaf, g in one["grads"].items():
        err = float((got["grads"][leaf] - g).norm()
                    / max(float(g.norm()), 1e-30))
        assert err <= 1e-5, (leaf, err)


def test_sharded_decode_matches_the_references(runs):
    ref = runs["ref"]
    n = ranks.DECODE["S"] // 2
    for rank, got in enumerate(runs["ranks"]):
        dec = got["decode"]
        for i, o in enumerate(dec["outs"]):
            assert torch.isfinite(o).all()
            np.testing.assert_allclose(o.numpy(), ref[f"out{i}"], rtol=0,
                                       atol=1e-5, err_msg=f"step {i}")
        for name in ("k", "v"):
            np.testing.assert_array_equal(
                dec[name].numpy(), ref[name][:, rank * n:(rank + 1) * n])


def test_sharded_serving_matches_one_process(runs):
    cfg = get_config(ranks.SERVE["arch"]).reduced()
    model = LM(cfg, init_params(build_defs(cfg), seed=0))
    P, G = ranks.SERVE["prompt"], ranks.SERVE["gen"]
    batch = make_batch(cfg, ranks.SERVE["B"], P, kind="prefill")
    logits, cache = build_prefill_step(model, P + G)(batch)
    step = build_serve_step(model)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    ids, all_logits = [tok], [logits]
    for i in range(G - 1):
        logits, cache, nxt = step(tok, cache, P + i)
        tok = nxt[:, None]
        ids.append(tok)
        all_logits.append(logits)
    for got in runs["ranks"]:
        assert got["serve_sharded"]
        assert torch.equal(got["serve"]["ids"], torch.cat(ids, 1))
        for a, b in zip(got["serve"]["logits"], all_logits):
            torch.testing.assert_close(a, b, rtol=0, atol=SERVE_LOGIT_TOL)


def test_checkpoints_restore_across_world_sizes(runs):
    """2 ranks -> 1 and 1 -> 2: the resumed runs log the uninterrupted
    run's steps 3-4; a restore with placements gives each rank its slice
    of the stored array."""
    four = runs["one"]["four"]["losses"]
    r2 = runs["ranks"][0]
    assert len(r2["saved"]["losses"]) == 2          # --mesh 2x1
    assert r2["saved"]["world"] == 2
    np.testing.assert_allclose(r2["saved"]["losses"], four[:2], rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(runs["one"]["resumed"]["losses"], four[2:],
                               rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(r2["resumed"]["losses"], four[2:], rtol=0,
                               atol=LOSS_TOL)
    from repro_torch import checkpoint as ckpt

    whole, step = ckpt.restore(runs["ckpt_in"], 2, device="cpu")
    defs = tree_leaves(build_defs(get_config("qwen2-0.5b").reduced()))
    rules = ShardingRules.default()
    for i, (d, w) in enumerate(zip(defs, tree_leaves(whole["params"]))):
        spec = logical_to_spec(d.logical_axes, rules,
                               {"data": 2, "model": 1}, d.shape)
        dim = spec.index("data") if "data" in spec else None
        for rank, got in enumerate(runs["ranks"]):
            want = w if dim is None else w.chunk(2, dim)[rank]
            assert torch.equal(got["restored"][i], want), (i, rank)


def test_train_example_twin_matches_the_references(runs):
    got, want = (_losses(runs["out"][k]) for k in ("train_ex",
                                                   "ref_train_ex"))
    assert len(got) == len(want) == TWIN_STEPS // 5
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    assert "2x1 mesh (gloo)" in runs["out"]["train_ex"]
    assert runs["out"]["train_ex"].rstrip().endswith("done")


def test_serve_example_twin_matches_the_references(runs):
    got, want = (_ids(runs["out"][k]) for k in ("serve_ex", "ref_serve_ex"))
    assert len(got) == len(want) == 2
    assert all(len(a) == len(b) == 16 for a, b in zip(got, want))
    apart = sum(x != y for a, b in zip(got, want) for x, y in zip(a, b))
    assert apart <= 2, (got, want)
    assert "decoded 15 steps x 4 seqs" in runs["out"]["serve_ex"]
