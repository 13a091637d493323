"""Multi-rank helpers of the port's mesh tests: start ``world`` ranks
under gloo on the CPU and collect what a task returns on each.

Each rank is a spawned process (niced by 10 unless the caller asks
otherwise, so that the suite's other workers and the processes they
wait on come first) with 2 torch threads that joins a gloo
process group through a file in the test's own ``tmp_path`` (so xdist
workers never share a port) with a 60 s collective timeout, runs
``task(rank, world, *args)`` and saves its result; the parent joins each
rank with a timeout of its own, so a hang fails the test instead of
eating the suite's time.  This module imports no JAX: the ranks start
with torch and the port only.
"""

from __future__ import annotations

import datetime
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

PG_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 240


def _entry(rank: int, world: int, init_file: str, out_dir: str, task,
           args, threads: int = 2, nice: int = 10) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    os.nice(nice)   # the suite's other workers (their servers) come first
    torch.set_num_threads(threads)
    path = os.path.join(out_dir, f"rank{rank}.pt")
    code = 1
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            out = task(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": out}, path)
        code = 0
    except BaseException:
        torch.save({"error": traceback.format_exc()}, path)
    finally:
        # no wait at interpreter exit for threads the group left behind
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def run_ranks(task, world: int, tmp_dir, *args,
              timeout_s: float = JOIN_TIMEOUT_S, threads: int = 2,
              nice: int = 10) -> list:
    """``task(rank, world, *args)`` on ``world`` spawned gloo ranks of
    ``threads`` torch threads each, niced by ``nice``; returns their
    results in rank order (raises with a rank's traceback if one failed,
    or if one did not end within ``timeout_s``)."""
    import torch.multiprocessing as mp

    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    init_file = os.path.join(tmp_dir, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, init_file, tmp_dir,
                                              task, args, threads, nice))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    results = []
    for r in range(world):
        path = os.path.join(tmp_dir, f"rank{r}.pt")
        got = torch.load(path, weights_only=False) \
            if os.path.exists(path) else {"error": "no result"}
        if "error" in got:
            raise RuntimeError(f"rank {r} (exit {procs[r].exitcode}, hung "
                               f"{r in hung}):\n{got['error']}")
        results.append(got["ok"])
    if hung:
        raise RuntimeError(f"ranks {hung} did not end in {timeout_s} s")
    return results


# ---------------------------------------------------------------------------
# tests/test_torch_sharding.py: placements and collectives
# ---------------------------------------------------------------------------

# logical axes of a (4, 6, 8) tensor and the (2, 1) and (1, 2) meshes
PLACEMENT_CASES = (("embed", "mlp", None), ("heads", None, "embed"),
                   (None, "kv_seq", None), ("layers", "vocab", "qkv"),
                   ("batch", "seq", "embed"))


def _rand(seed: int, *shape) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g)


def sharding_task(rank: int, world: int) -> dict:
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import (ShardingRules, constrain,
                                                  logical_to_spec,
                                                  placements)
    from repro_torch.launch.mesh import make_device_mesh

    rules = ShardingRules.default()
    full = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    out = {"placed": {}}
    for shape in ((2, 1), (1, 2)):
        mesh = make_device_mesh(shape, device="cpu")
        for axes in PLACEMENT_CASES:
            spec = logical_to_spec(axes, rules, mesh, full.shape)
            pl = placements(spec, mesh)
            local = distribute_tensor(full, mesh, pl,
                                      src_data_rank=None).to_local()
            out["placed"][(shape, axes)] = (spec, [str(p) for p in pl],
                                            local.clone())
        if shape == (2, 1):
            from torch.distributed.tensor import Replicate
            whole = distribute_tensor(full, mesh, (Replicate(), Replicate()))
            out["constrained"] = constrain(whole, ("embed", "mlp", None),
                                           rules, mesh).to_local().clone()
            out["plain_kept"] = constrain(full, ("embed",), rules,
                                          mesh) is full
    mesh = make_device_mesh((1, 2), device="cpu")
    group = (mesh, "model")
    # the decode combine: rank r's partials over its half of the keys
    s, v = _rand(1, 2, 3, 10), _rand(2, 2, 10, 5)
    half = slice(5 * rank, 5 * rank + 5)
    sl = s[..., half]
    if rank == 1:            # every key of rank 1's slice masked
        sl = torch.full_like(sl, -1e30)
    m = sl.amax(-1)
    p = torch.exp(sl - m[..., None])
    out["combine"] = col.online_softmax_combine(
        m, p.sum(-1), torch.einsum("bhs,bsd->bhd", p, v[:, half]), group)
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * rank
    out["a2a"] = col.all_to_all_dispatch(x, group, split_axis=0,
                                         concat_axis=1)
    out["a2a_untiled"] = col.all_to_all_dispatch(
        x.reshape(2, 2, 6), group, split_axis=0, concat_axis=2,
        tiled=False)
    out["ring"] = col.ring_allgather_kv(torch.full((2, 3), float(rank)),
                                        group)
    y = torch.arange(16, dtype=torch.float32).reshape(4, 4) * (rank + 1)
    out["scatter0"] = col.psum_scatter(y, group)
    out["scatter1"] = col.psum_scatter(y, group, scatter_dimension=1)
    out["scatter_untiled"] = col.psum_scatter(y[:2], group, tiled=False)
    out["offset"] = col.shard_offset(group, 7)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_lm_mesh.py: the LM on a process mesh
# ---------------------------------------------------------------------------

QWEN_ARGV = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "8",
             "--seq-len", "32", "--microbatches", "2", "--log-every", "1"]
MOE_ARGV = ["--arch", "moonshot-v1-16b-a3b", "--reduced", "--batch", "4",
            "--seq-len", "32", "--log-every", "1"]
# microbatches whose rows the data ranks do not divide: at 2 ranks 2 of
# 3 rows (one a rank), at 4 ranks 4 of 2 rows (2 ranks each, 2 passes);
# the reference's losses at --devices 2 equal its one-device run's
QWEN_SIDE_ARGV = QWEN_ARGV + ["--batch", "6", "--steps", "2"]
SIDE_ARGV = {"qwen_side4": QWEN_ARGV + ["--microbatches", "4", "--steps",
                                        "2"],
             "moe_side4": MOE_ARGV + ["--batch", "8", "--microbatches", "4",
                                      "--steps", "2"]}
# the 4-rank routing: B rows of S tokens in mb microbatches
ROUTE_SIDE = dict(B=8, S=16, mb=4, capacity_factor=1.0)
# the sharded decode's case: B, Hq, Hkv, D, S and (position, window) steps
DECODE = dict(B=2, Hq=4, Hkv=2, D=16, S=16,
              steps=((3, 0), (11, 0), (12, 4), (15, 0)))
SERVE = dict(arch="gemma3-1b", B=2, prompt=16, gen=4)
ROUTE = dict(B=4, S=16, capacity_factor=1.0)
# dispatch groups over the ranks' tokens (moonshot's reduced router, some
# assignments dropped): at 2 ranks of 24 tokens G 3 (group 1 straddles
# the ranks) and 4 (whole groups); at 4 ranks of 24 tokens G 2 (each
# group spans 2 ranks) and 6 (neither divides the other); in the 4-rank
# side-by-side layout (2 ranks a 2-row microbatch of 24 tokens) G 2
# (a group a rank) and 3 (group 1 straddles)
ROUTE_GROUPS = {2: dict(B=4, S=12, groups=(3, 4)),
                4: dict(B=8, S=12, groups=(2, 6)),
                "side": dict(B=8, S=12, mb=4, groups=(2, 3))}
# one float32 train step of moonshot reduced at 3 dispatch groups on the
# 4-rank session's (2, 2) mesh (4 rows of 48 tokens: group 1 straddles
# the 2 data ranks; the experts split over the 2 model ranks), some
# assignments dropped
MOE_STEP = dict(arch="moonshot-v1-16b-a3b", B=4, S=48,
                derived=dict(moe_groups=3, capacity_factor=1.0))


def decode_inputs():
    """The sharded decode's inputs, a numpy draw the reference's script
    makes alike: q, new_k, new_v for each step and the initial cache."""
    import numpy as np

    d = DECODE
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    cache = (f(d["B"], d["S"], d["Hkv"], d["D"]),
             f(d["B"], d["S"], d["Hkv"], d["D"]))
    steps = [(f(d["B"], d["Hq"], d["D"]), f(d["B"], 1, d["Hkv"], d["D"]),
              f(d["B"], 1, d["Hkv"], d["D"])) for _ in d["steps"]]
    return cache, steps


def _train(argv: list) -> dict | None:
    from repro_torch.launch import train
    return train.main(argv + ["--device", "cpu"])


def run_example(root: str, argv: list) -> str:
    """Run ``argv[0]`` (a script under ``root``) as ``__main__`` with
    ``argv`` in this process; returns what it printed."""
    import contextlib
    import io
    import runpy

    saved, sys.argv = sys.argv, list(argv)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(root, argv[0]), run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue()


def lm_mesh_task(rank: int, world: int, ckpt_in: str, ckpt_out: str,
                 root: str, twin_steps: int) -> dict:
    import numpy as np

    from repro_torch.distributed.sharding import (ShardingRules,
                                                  tree_placements)
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.shapes import make_batch
    from repro_torch.models import moe
    from repro_torch.models.attention import sharded_decode_attention
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.models.registry import get_config
    from repro_torch.models.transformer import LM, build_defs
    from repro_torch.optim import adamw
    from repro_torch.train.steps import (build_prefill_step,
                                         build_serve_step, init_train_state)
    from repro_torch import checkpoint as ckpt

    out = {}
    # the launcher's --devices 2 runs (this process group is the mesh)
    out["qwen"] = _train(QWEN_ARGV + ["--steps", "3", "--devices", "2"])
    out["moonshot"] = _train(MOE_ARGV + ["--steps", "3", "--devices", "2"])
    out["saved"] = _train(QWEN_ARGV + ["--steps", "2", "--mesh", "2x1",
                                       "--ckpt-dir", ckpt_out])
    out["resumed"] = _train(QWEN_ARGV + ["--steps", "4", "--devices", "2",
                                         "--ckpt-dir", ckpt_in])
    # a microbatch of 3 rows on each rank: side by side, routed locally
    out["qwen_side"] = _train(QWEN_SIDE_ARGV + ["--devices", "2"])

    mesh = make_device_mesh((2, 1), device="cpu")
    rules = ShardingRules.default()
    cfg = get_config("qwen2-0.5b").reduced()
    defs = build_defs(cfg)
    model = LM(cfg, init_params(defs, seed=0, device="cpu"), trainable=True)
    state = init_train_state(model, adamw(1e-3), mesh, rules)
    out["shards"] = {
        part: [tuple(t.to_local().shape) for t in tree_leaves(tree)]
        for part, tree in (("params", state["params"]),
                           ("m", state["opt"]["m"]),
                           ("v", state["opt"]["v"]))}
    pl = tree_placements(defs, rules, mesh)
    restored, _ = ckpt.restore(
        ckpt_in, 2, device="cpu",
        placements={"params": _pairs(pl, mesh)})
    out["restored"] = [t.to_local().clone()
                       for t in tree_leaves(restored["params"])]

    # global MoE dispatch: this rank's rows routed with every rank's
    mcfg = get_config("moonshot-v1-16b-a3b").reduced()
    router = init_params(build_defs(mcfg), seed=0)["blocks"]["router"][0]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (ROUTE["B"], ROUTE["S"], mcfg.d_model)).astype(np.float32))
    half = ROUTE["B"] // world
    with moe.global_dispatch(mesh.get_group("data")):
        r = moe.route(router, x[rank * half:(rank + 1) * half],
                      top_k=mcfg.experts_per_token,
                      capacity_factor=ROUTE["capacity_factor"],
                      routing=mcfg.routing)
    out["route"] = {"keep": r.keep, "expert_idx": r.expert_idx,
                    "aux": r.aux}

    out["route_groups"] = route_groups(mesh, rank, world, ROUTE_GROUPS[world])

    # the sequence-sharded decode on a (1, 2) mesh
    dmesh = make_device_mesh((1, 2), device="cpu")
    fn = sharded_decode_attention(dmesh)
    (ck, cv), steps = decode_inputs()
    n = DECODE["S"] // world
    ck = torch.from_numpy(ck[:, rank * n:(rank + 1) * n]).clone()
    cv = torch.from_numpy(cv[:, rank * n:(rank + 1) * n]).clone()
    outs = []
    for (pos, window), (q, nk, nv) in zip(DECODE["steps"], steps):
        outs.append(fn(torch.from_numpy(q), torch.from_numpy(nk),
                       torch.from_numpy(nv), ck, cv, pos, window))
    out["decode"] = {"outs": outs, "k": ck, "v": cv}

    # greedy serving through build_serve_step(model, mesh)
    scfg = get_config(SERVE["arch"]).reduced()
    smodel = LM(scfg, init_params(build_defs(scfg), seed=0))
    batch = make_batch(scfg, SERVE["B"], SERVE["prompt"], kind="prefill")
    logits, cache = build_prefill_step(
        smodel, SERVE["prompt"] + SERVE["gen"], dmesh)(batch)
    out["serve_sharded"] = hasattr(cache["k"], "device_mesh")
    step = build_serve_step(smodel, dmesh, rules)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    ids, all_logits = [tok], [logits]
    for i in range(SERVE["gen"] - 1):
        logits, cache, nxt = step(tok, cache, SERVE["prompt"] + i)
        tok = nxt[:, None]
        ids.append(tok)
        all_logits.append(logits)
    out["serve"] = {"ids": torch.cat(ids, 1), "logits": all_logits}
    # the training example's twin on this process group (its 2x1 mesh)
    out["train_ex"] = run_example(root, [
        "examples/train_lm_torch.py", "qwen2-0.5b", str(twin_steps),
        "--device", "cpu"])
    return out


def route_groups(mesh, rank: int, world: int, case: dict) -> dict:
    """Moonshot's routing of this rank's rows of ``case``'s batch at each
    of its dispatch groups, globally over the ``data`` ranks of ``mesh``
    (with ``mb``: each pass of this rank's rows over the ranks that hold
    its microbatch): {G: [each pass's route, as a dict of its fields]}."""
    from repro_torch.data.tokens import microbatch_layout, rank_rows
    from repro_torch.distributed.sharding import microbatch_group
    from repro_torch.models import moe
    from repro_torch.models.registry import get_config

    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    router, x = route_groups_inputs(case)
    mb = case.get("mb", 1)
    lay = microbatch_layout(case["B"], mb, world)
    rows = rank_rows(case["B"], rank, world, mb)
    out = {}
    with moe.global_dispatch(microbatch_group(mesh, lay.share)):
        for G in case["groups"]:
            out[G] = []
            for i in range(lay.passes):
                r = moe.route(router, x[rows[i * lay.rows:
                                             (i + 1) * lay.rows]],
                              top_k=cfg.experts_per_token,
                              capacity_factor=1.0, routing=cfg.routing,
                              groups=G)
                out[G].append(r._asdict())
    return out


def route_groups_inputs(case: dict) -> tuple:
    """A router of moonshot reduced's (d_model, num_experts) shape and
    ``case``'s (B, S, d_model) tokens, drawn from seeds with numpy."""
    import numpy as np

    from repro_torch.models.registry import get_config

    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    d, E = cfg.d_model, cfg.num_experts
    router = np.random.default_rng(7).standard_normal((d, E)) / np.sqrt(2)
    x = np.random.default_rng(6).standard_normal((case["B"], case["S"], d))
    return (torch.from_numpy(router.astype(np.float32)),
            torch.from_numpy(x.astype(np.float32)))


def batch_position(mesh) -> int:
    """This rank's place among the data-parallel ranks of ``mesh`` in the
    flattened (pod-major) order of its batch axes: the rank of
    ``data.tokens.rank_rows``."""
    from repro_torch.distributed.sharding import batch_axes

    coord, names = mesh.get_coordinate(), list(mesh.mesh_dim_names)
    b = 0
    for a in batch_axes(mesh):
        i = names.index(a)
        b = b * mesh.size(i) + coord[i]
    return b


def moe_step_config():
    import dataclasses

    from repro_torch.models.registry import get_config

    return dataclasses.replace(get_config(MOE_STEP["arch"]).reduced(),
                               **MOE_STEP["derived"])


def moe_step(mesh=None) -> dict:
    """One float32 ``build_train_step`` step of ``MOE_STEP`` from the
    seed-0 weights on ``mesh`` (each ``data`` rank its rows of
    ``make_batch``'s batch, the ``model`` ranks splitting the experts),
    or on one process: the loss, aux and grad norm, and every leaf's
    whole gradient by name."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.shapes import make_batch
    from repro_torch.models import transformer
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import LM
    from repro_torch.train.steps import build_train_step, init_train_state

    cfg = moe_step_config()
    rules = None if mesh is None else ShardingRules.default()
    saved = transformer.COMPUTE_DTYPE
    transformer.COMPUTE_DTYPE = torch.float32
    try:
        model = LM(cfg, device="cpu", trainable=True, mesh=mesh,
                   rules=rules)
        batch = make_batch(cfg, MOE_STEP["B"], MOE_STEP["S"], kind="train")
        if mesh is not None:
            n = MOE_STEP["B"] // mesh.size(0)
            r = mesh.get_local_rank("data")
            batch = {k: v[r * n:(r + 1) * n] for k, v in batch.items()}
        rec = _Recording()
        step = build_train_step(model, rec.opt, mesh, rules)
        _, m = step(init_train_state(model, rec.opt, mesh, rules), batch)
    finally:
        transformer.COMPUTE_DTYPE = saved
    return {"loss": float(m["loss"]), "moe_aux": float(m["moe_aux"]),
            "grad_norm": float(m["grad_norm"]),
            "grads": dict(zip(_names(model.defs), tree_leaves(rec.grads)))}


def side_task(rank: int, world: int) -> dict:
    """The 4-rank session: the launcher's runs of ``SIDE_ARGV`` on the
    (4, 1) mesh, and moonshot's routing of each microbatch by the ranks
    that hold it (``ROUTE_SIDE``: each pass of this rank's rows routed
    under ``global_dispatch(microbatch_group(...))``); moonshot's
    routing at ``ROUTE_GROUPS``' dispatch groups, a rank's place in a
    microbatch's token order, and ``MOE_STEP`` on the (2, 2) mesh.  The
    test module starts it once the 2-rank session has ended."""
    import numpy as np

    from repro_torch.data.tokens import microbatch_layout, rank_rows
    from repro_torch.distributed.sharding import microbatch_group
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.models.registry import get_config
    from repro_torch.models.transformer import build_defs

    out = {name: _train(argv + ["--devices", str(world), "--mesh",
                                f"{world}x1"])
           for name, argv in SIDE_ARGV.items()}
    mesh = make_device_mesh((world, 1), device="cpu")
    r = ROUTE_SIDE
    lay = microbatch_layout(r["B"], r["mb"], world)
    rows = rank_rows(r["B"], rank, world, r["mb"])
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    router = init_params(build_defs(cfg), seed=0)["blocks"]["router"][0]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (r["B"], r["S"], cfg.d_model)).astype(np.float32))
    out["layout"], out["rows"], out["route"] = lay, rows, []
    with moe.global_dispatch(microbatch_group(mesh, lay.share)):
        for i in range(lay.passes):
            part = rows[i * lay.rows:(i + 1) * lay.rows]
            got = moe.route(router, x[part], top_k=cfg.experts_per_token,
                            capacity_factor=r["capacity_factor"],
                            routing=cfg.routing)
            out["route"].append({"keep": got.keep,
                                 "expert_idx": got.expert_idx,
                                 "aux": got.aux})
    out["route_groups"] = route_groups(mesh, rank, world, ROUTE_GROUPS[world])
    out["route_groups_side"] = route_groups(mesh, rank, world,
                                            ROUTE_GROUPS["side"])
    out["moe_step"] = moe_step(make_device_mesh((2, world // 2),
                                                device="cpu"))
    # each rank's place in a microbatch's token order: its rank in the
    # sub-group (sorted by global rank), which ``moe.route`` takes, and
    # in the pod-major layout
    out["order"] = {}
    for shape, axes in (((world, 1), ("data", "model")),
                        ((2, world // 2, 1), ("pod", "data", "model"))):
        m = mesh if len(shape) == 2 else make_device_mesh(shape, axes,
                                                          device="cpu")
        for share in (2, world):
            out["order"][(shape, share)] = (
                dist.get_rank(microbatch_group(m, share)),
                batch_position(m) % share)
    return out


def _pairs(placements, mesh):
    if isinstance(placements, dict):
        return {k: _pairs(v, mesh) for k, v in placements.items()}
    return (mesh, placements)


# ---------------------------------------------------------------------------
# tests/test_torch_tp.py: tensor parallelism over the 'model' axis
# ---------------------------------------------------------------------------

TP_B, TP_S = 4, 16


def tp_config(arch: str, derived: dict | None = None):
    """The reduced config of ``arch`` (the chunked attention: the flash
    path's plain version runs in float32 too, but the window archs take
    the chunked path either way), with ``derived``'s fields replaced."""
    import dataclasses

    from repro_torch.models.registry import get_config

    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, **(derived or {}))


def as_inputs(batch: dict, dtype) -> dict:
    """``make_batch``'s float inputs rounded to bf16, as it makes them,
    then cast to ``dtype`` (``shapes`` binds the activation dtype when it
    is first imported: a process that imported it while a test had set
    float32 would hand out other numbers than a fresh rank does)."""
    return {k: v.to(torch.bfloat16).to(dtype) if v.is_floating_point()
            else v for k, v in batch.items()}


def tp_batch(cfg, dtype) -> dict:
    """The test's global batch: ``make_batch`` at (TP_B, TP_S), float
    inputs in ``dtype`` (``as_inputs``)."""
    from repro_torch.launch.shapes import make_batch

    return as_inputs(make_batch(cfg, TP_B, TP_S, kind="train"), dtype)


class _Recording:
    """An optimizer that keeps the gradients it is given (whole: a
    DTensor gathered) and their global norm (AdamW's clip, over the
    shards) and leaves the parameters as they are."""

    def __init__(self):
        from repro_torch.optim import Optimizer

        self.grads = None

        def update(grads, opt_state, params, step):
            from repro_torch.models.params import tree_map
            from repro_torch.optim.adamw import clip_by_global_norm

            norm = clip_by_global_norm(grads, 1.0)[1]
            self.grads = tree_map(
                lambda g: (g.full_tensor() if hasattr(g, "full_tensor")
                           else g).detach().clone(), grads)
            return {"grad_norm": norm, "lr": torch.zeros(())}

        self.opt = Optimizer(init=lambda p: {}, update=update)


def _rows(batch: dict, rank: int, ranks: int) -> dict:
    n = TP_B // ranks
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def tp_grads_task(rank: int, world: int, cases: list) -> dict:
    """For each (name, arch, derived, shape) case: the whole logits of
    this rank's rows, the loss and every leaf's whole gradient of one
    float32 train step on the ``shape`` mesh, and this rank's local shard
    of every leaf of the train state with its spec."""
    import dataclasses

    from repro_torch.distributed.sharding import (ShardingRules,
                                                  logical_to_spec)
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import moe, transformer
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.models.transformer import LM
    from repro_torch.train.steps import build_train_step, init_train_state

    saved = transformer.COMPUTE_DTYPE
    transformer.COMPUTE_DTYPE = torch.float32
    rules = ShardingRules.default()
    out = {}
    for name, arch, derived, shape in cases:
        cfg = tp_config(arch, derived)
        mesh = make_device_mesh(shape, device="cpu")
        model = LM(cfg, device="cpu", trainable=True, mesh=mesh,
                   rules=rules)
        d = mesh.get_local_rank("data")
        batch = _rows(tp_batch(cfg, torch.float32), d, shape[0])
        with torch.no_grad(), moe.global_dispatch(mesh.get_group("data")):
            logits = model(batch)[0]
        rec = _Recording()
        step = build_train_step(model, rec.opt, mesh, rules)
        state = init_train_state(model, rec.opt, mesh, rules)
        shards = {}
        for k, t in zip(_names(model.defs), tree_leaves(state["params"])):
            dd = _def_at(model.defs, k)
            shards[k] = (logical_to_spec(dd.logical_axes, rules, mesh,
                                         dd.shape), t.to_local().clone())
        _, metrics = step(state, batch)
        # the reference's whole tree carried across, cut to this rank's
        # shards: the leaves the model drew as its blocks, bit for bit
        whole = init_params(model.defs, seed=0)
        carried = lm_params_from_jax(tree_map(lambda t: t.numpy(), whole),
                                     tp=model.tp)
        drawn_equal = all(torch.equal(a, b.detach()) for a, b in zip(
            tree_leaves(carried), tree_leaves(model.param_tree())))
        out[name] = {"logits": logits, "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "grads": rec.grads, "shards": shards,
                     "carried_equal_drawn": drawn_equal,
                     "kv_heads": model._kv_heads(),
                     "tp": dict(model.tp.dims)}
    transformer.COMPUTE_DTYPE = saved
    return out


def _names(tree, prefix="") -> list:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k],
                                                        f"{prefix}{k}/")]
    return [prefix[:-1]]


def _def_at(tree, name: str):
    for k in name.split("/"):
        tree = tree[k]
    return tree


TP_PROMPT, TP_GEN = 16, 4


def tp_decode(model, cfg, batch, prompt: int, gen: int, cache_len: int):
    """Greedy prefill and ``gen - 1`` decode steps through
    ``build_prefill_step``/``build_serve_step`` on the model's own mesh
    (none: one process): (ids (B, gen), every step's logits)."""
    from repro_torch.train.steps import build_prefill_step, build_serve_step

    logits, cache = build_prefill_step(model, cache_len)(batch)
    step = build_serve_step(model)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    ids, all_logits = [tok], [logits[:, -1]]
    for i in range(gen - 1):
        logits, cache, nxt = step(tok, cache, prompt + i)
        tok = nxt[:, None]
        ids.append(tok)
        all_logits.append(logits[:, -1])
    return torch.cat(ids, 1), torch.stack(all_logits, 1), cache


def tp_decode_task(rank: int, world: int, cases: list) -> dict:
    """For each (name, arch, derived, dtype name, extra cache positions)
    case: greedy decoding of ``make_batch``'s prompt on the (1, world)
    mesh, the model tensor-parallel (rank 0 returns ids, logits and
    whether the cache was split on S)."""
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.shapes import make_batch
    from repro_torch.models import transformer
    from repro_torch.models.params import cast_tree, init_params
    from repro_torch.models.transformer import LM, build_defs

    mesh = make_device_mesh((1, world), device="cpu")
    saved = transformer.COMPUTE_DTYPE
    out = {}
    for name, arch, derived, dtype, extra in cases:
        transformer.COMPUTE_DTYPE = getattr(torch, dtype)
        cfg = tp_config(arch, derived)
        params = init_params(build_defs(cfg), seed=0)
        if dtype == "bfloat16":
            params = cast_tree(params, torch.bfloat16)
        model = LM(cfg, params, device="cpu", mesh=mesh)
        batch = as_inputs(make_batch(cfg, 2, TP_PROMPT, kind="prefill"),
                          transformer.COMPUTE_DTYPE)
        ids, logits, cache = tp_decode(model, cfg, batch, TP_PROMPT, TP_GEN,
                                       TP_PROMPT + TP_GEN + extra)
        out[name] = {"ids": ids, "logits": logits,
                     "split": hasattr(cache.get("k"), "device_mesh")}
    transformer.COMPUTE_DTYPE = saved
    return out


def tp_launch(argv: list, derived: dict | None = None):
    """``launch.train.main(argv)`` on the CPU in this rank, ``--arch``'s
    reduced config with ``derived``'s fields replaced."""
    import dataclasses
    import types

    from repro_torch.launch import train
    from repro_torch.models.registry import get_config

    saved = train.get_config
    if derived:
        arch = argv[argv.index("--arch") + 1]
        cfg = dataclasses.replace(get_config(arch).reduced(), **derived)
        train.get_config = lambda _: types.SimpleNamespace(
            family=cfg.family, reduced=lambda: cfg)
    try:
        return train.main(argv + ["--device", "cpu"])
    finally:
        train.get_config = saved


def tp_task(rank: int, world: int, grads: list, decode: list, runs: dict,
            ckpt: dict) -> dict:
    """The tensor-parallel test's work on ``world`` ranks: the gradient
    cases (``tp_grads_task``), the decode cases on (1, world)
    (``tp_decode_task``), the launcher ``runs`` ({name: (argv,
    derived)}) and the checkpoint flows ({name: (argv, derived, dir,
    copy to)}: the run, then its directory copied for the next, in
    order)."""
    import shutil

    out = {"grads": tp_grads_task(rank, world, grads),
           "decode": tp_decode_task(rank, world, decode) if decode else {},
           "runs": {}}
    for name, (argv, derived) in runs.items():
        out["runs"][name] = tp_launch(argv, derived)
    for name, (argv, derived, where, copy) in ckpt.items():
        out["runs"][name] = tp_launch(argv + ["--ckpt-dir", where], derived)
        if copy and rank == 0:
            shutil.copytree(where, copy)
        dist.barrier()
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_roofline.py: a real step's collectives
# ---------------------------------------------------------------------------

def dryrun_task(rank: int, world: int, arch: str, derived: dict | None,
                B: int, S: int) -> dict:
    """One train step of the reduced ``arch`` on a (1, world) mesh, on
    real tensors, counted: ``collectives.TRAFFIC`` (the tensor-parallel
    all_reduces and their bytes) and every collective this rank issued as
    ``roofline.analysis.StepCounter`` counts it, (kind, result bytes,
    group size) in order."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.transformer import LM
    from repro_torch.optim.adamw import adamw
    from repro_torch.roofline.analysis import StepCounter
    from repro_torch.train.steps import build_train_step, init_train_state

    cfg = tp_config(arch, derived)
    mesh = make_device_mesh((1, world), device="cpu")
    model = LM(cfg, device="cpu", trainable=True, mesh=mesh)
    opt = adamw(3e-4)
    state = init_train_state(model, opt, mesh)
    step = build_train_step(model, opt, mesh)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    calls = []
    counter = StepCounter()
    add = counter.collectives.add

    def record(kind, nbytes, group):
        calls.append((kind, nbytes, group))
        add(kind, nbytes, group)

    counter.collectives.add = record
    collectives.reset_traffic()
    with counter, counter.step():
        _, metrics = step(state, batch)
    return {"traffic": dict(collectives.TRAFFIC), "calls": calls,
            "loss": float(metrics["loss"])}
