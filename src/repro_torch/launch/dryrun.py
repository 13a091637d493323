"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake tensors.

The port of the reference's ``repro/launch/dryrun.py``.  For each cell it
runs the port's real step once (``build_train_step`` with the optimizer's
update, ``build_prefill_step`` or ``build_serve_step``) on fake tensors
(``FakeTensorMode``), as rank 0 of the production mesh
(``launch.mesh.make_production_mesh``: 256 or 512 ranks of a fake process
group), on abstract state and inputs (``models.transformer.abstract_lm``,
``train.steps.abstract_train_state``, ``launch.shapes.input_specs``), and
records what that rank does (``roofline.analysis``):

  * memory: the peak of its live bytes (state, activations, gradients,
    cache) against one card's 80 GB (``fits_hbm``),
  * its FLOPs, bytes and collectives,
  * the three roofline terms on the H100 (compute / memory / collective
    seconds).

No weight is drawn, no memory is held and no card is used; ``trace_s`` is
the trace's host time (the reference's ``lower_s``/``compile_s``).  The
fake tensors sit on ``cuda``, so the LM kernels' wrappers take their fake
implementations (``kernels.ops``: each kernel's own outputs and FLOPs);
``--device cpu`` traces the plain versions (``kernels.ref``), as the
reference's host lowering takes its interpret-mode kernels.  A training
cell's backward on fake ``cuda`` tensors needs a card (autograd asks the
CUDA runtime for each tensor's stream, and a PyTorch without CUDA, or
with CUDA and no card, refuses): where there is none the default device
is ``cpu``, and every record names the device it traced.

A train cell takes the reference's microbatches wherever the reference
does (each of them and the pod x data ranks divide the global batch):
where the ranks do not divide a microbatch's rows, microbatches run side
by side (``data.tokens.microbatch_layout``), and the verbose lines print
a rank's passes and its rows in a pass.

Results are one JSON a cell under --out (default ``dryrun_out/``,
git-ignored).  A cell that fails is recorded and the run exits 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all                 # single-pod, all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod     # 2-pod pass
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import time
import traceback

import torch

DEFAULT_OUT = "dryrun_out"

# Per-(arch, shape) gradient-accumulation defaults, the reference's (sized
# there so the remat'd layer residuals fit 16 GB a chip).
TRAIN_MICROBATCHES = {
    "qwen2-0.5b": 2, "codeqwen1.5-7b": 4, "mistral-nemo-12b": 8,
    "gemma3-1b": 2, "mamba2-370m": 4, "mixtral-8x7b": 8,
    "moonshot-v1-16b-a3b": 4, "qwen2-vl-7b": 16, "hymba-1.5b": 4,
    "seamless-m4t-large-v2": 16,
}


def default_device() -> str:
    """``cuda`` where a card is visible (a training cell's backward needs
    one, see the module docstring), else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _local(x):
    """A DTensor's local shard, anything else as it is."""
    return x.to_local() if hasattr(x, "to_local") else x


def train_layout(shape, microbatches: int, mesh):
    """How a rank of ``mesh`` (None: one process) takes ``shape``'s global
    batch in ``microbatches`` microbatches: ``data.tokens.
    microbatch_layout`` over the mesh's pod x data ranks (``ValueError``
    where the reference also fails, naming the microbatches or the
    ranks)."""
    from repro_torch.data.tokens import microbatch_layout
    from repro_torch.distributed.sharding import batch_group

    ranks = (1 if mesh is None else
             torch.distributed.get_world_size(batch_group(mesh)))
    return microbatch_layout(shape.global_batch, microbatches, ranks)


def trace_step(cfg, shape, mesh, rules=None, *, microbatches: int = 1,
               ce: str = "gather", device="cuda"):
    """Run ``cfg``'s step of ``shape``'s kind once on fake tensors as rank
    0 of ``mesh`` (None: one process, no process group, as the train entry
    point runs without ``--mesh``) and count it: its
    ``roofline.analysis.StepCosts``.  Training uses the reference's
    dry-run optimizer, ``adamw(3e-4)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import (ShardingRules,
                                                  microbatch_group)
    from repro_torch.launch.shapes import input_specs
    from repro_torch.models.transformer import (COMPUTE_DTYPE, abstract_lm,
                                                seq_shards)
    from repro_torch.optim.adamw import adamw
    from repro_torch.roofline.analysis import StepCounter
    from repro_torch.train.steps import (abstract_train_state,
                                         build_prefill_step,
                                         build_serve_step, build_train_step,
                                         init_train_state)

    rules = rules or ShardingRules.default()
    if shape.kind == "train":
        # the reference's refusals; the MoE's dispatch sub-groups are made
        # here, before the fake mode
        lay = train_layout(shape, microbatches, mesh)
        if mesh is not None:
            microbatch_group(mesh, lay.share)
    counter = StepCounter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        # made before the counter: it counts the leaves the step takes
        specs = input_specs(cfg, shape, rules, mesh, device)
        with counter:
            if shape.kind == "train":
                model = abstract_lm(cfg, mesh, rules, device=device,
                                    trainable=True)
                opt = adamw(3e-4)
                state = (init_train_state(model, opt) if mesh is None else
                         abstract_train_state(model, opt, mesh, rules))
                step = build_train_step(model, opt, mesh, rules,
                                        microbatches=microbatches, ce=ce)
                args = (state, {k: _local(v) for k, v in specs.items()})
            elif shape.kind == "prefill":
                model = abstract_lm(cfg, mesh, rules, device=device,
                                    dtype=COMPUTE_DTYPE)
                step = build_prefill_step(model, None, mesh)
                args = ({k: _local(v) for k, v in specs.items()},)
            else:
                model = abstract_lm(cfg, mesh, rules, device=device,
                                    dtype=COMPUTE_DTYPE)
                step = build_serve_step(model, mesh)
                tokens = _local(specs["tokens"])
                cache = _rank_cache(model, specs["cache"], tokens.shape[0],
                                    seq_shards(mesh, shape.seq_len) > 1)
                args = (tokens, cache, specs["position"])
            counter.track(args)
            with counter.step():
                out = step(*args)
            del out
    return counter.costs()


def _rank_cache(model, specs: dict, rows: int, split: bool) -> dict:
    """The decode cache as this rank of the tensor-parallel ``model``
    holds it: K and V as ``input_specs`` gives them (the reference's
    layout: every kv head, S split over "model", rows over the batch
    axes) where the decode shards the sequence, the rank's own leaves of
    ``model.init_cache`` otherwise and for the rest (the SSM state and
    conv tail, the cross K and V: the rank's heads and channels, which
    the reference's whole-head layout leaves to its partitioner)."""
    S = specs["k"].shape[2] if "k" in specs else 1
    src = specs["cross_k"].shape[2] if "cross_k" in specs else 0
    split = split and "k" in specs
    cache = model.init_cache(rows, 1 if split else S, src)
    if split:
        cache.update(k=specs["k"], v=specs["v"])
    return cache


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             rules_overrides=None, microbatches=None, out_dir=DEFAULT_OUT,
             tag="baseline", verbose=True, cfg_overrides=None, ce="gather",
             device=None):
    import repro_torch.configs  # noqa: F401  (registers every arch)
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import PRODUCTION_MESHES, production_mesh
    from repro_torch.launch.shapes import SHAPES, cell_skip_reason
    from repro_torch.models.registry import get_config
    from repro_torch.models.transformer import abstract_lm
    from repro_torch.roofline import analysis as roofline

    device = device or default_device()
    dims = PRODUCTION_MESHES[bool(multi_pod)][0]
    n_chips = 1
    for n in dims:
        n_chips *= n
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "x".join(map(str, dims))
    cell_id = f"{arch}__{shape_name}__{mesh_name}__{tag}"
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "tag": tag, "kind": shape.kind, "n_chips": n_chips,
              "device": device, "ok": False}

    skip = cell_skip_reason(cfg, shape)
    if skip:
        record.update(skipped=True, skip_reason=skip, ok=True)
        _write(out_dir, cell_id, record, verbose)
        return record

    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
        record["cfg_overrides"] = {k: str(v) for k, v in
                                   cfg_overrides.items()}
    record["ce"] = ce
    rules = ShardingRules.default(rules_overrides)
    model = abstract_lm(cfg, device="cpu")
    record["params_total"] = model.param_count()
    record["params_active"] = model.active_param_count()
    mb = 1
    if shape.kind == "train":
        mb = microbatches or TRAIN_MICROBATCHES.get(arch, 1)
        record["microbatches"] = mb

    t0 = time.time()
    try:
        with production_mesh(multi_pod, device) as mesh:
            lay = train_layout(shape, mb, mesh) if shape.kind == "train" \
                else None
            costs = trace_step(cfg, shape, mesh, rules, microbatches=mb,
                               ce=ce, device=device)
    except Exception as e:  # noqa: BLE001 — failures are cell bugs, recorded
        record.update(error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        _write(out_dir, cell_id, record, verbose)
        return record
    t_trace = time.time() - t0

    mf = roofline.model_flops(cfg, shape, record["params_active"])
    terms = roofline.compute_terms_from_costs(costs, n_chips, mf)
    record.update(
        ok=True, trace_s=round(t_trace, 2),
        memory={"state_bytes": costs.state_bytes,
                "per_chip_live_bytes": costs.peak_bytes,
                "hbm_bytes": int(roofline.HBM_BYTES),
                "fits_hbm": bool(costs.peak_bytes < roofline.HBM_BYTES)},
        cost={"flops": costs.flops, "bytes accessed": costs.hbm_bytes},
        collectives={"counts": costs.collectives.counts,
                     "result_bytes": costs.collectives.result_bytes,
                     "link_bytes_per_chip": costs.link_bytes,
                     "max_group": costs.collectives.max_group,
                     "crosses_hosts": costs.collectives.max_group
                     > roofline.HOST_CARDS},
        roofline=terms.to_json(),
        model_flops_total=mf,
    )
    _write(out_dir, cell_id, record, verbose)
    if verbose:
        r = record["roofline"]
        print(f"  terms: compute={r['compute_s']:.4e}s "
              f"memory={r['memory_s']:.4e}s collective={r['collective_s']:.4e}s"
              f" bound={r['bound']} roofline_frac={r['roofline_fraction']:.3f}")
        print(f"  memory/chip: {costs.peak_bytes / 2**30:.2f} GiB "
              f"(fits_hbm={record['memory']['fits_hbm']}) "
              f"trace={t_trace:.1f}s")
        if lay is not None:
            print(f"  microbatches: {mb}; a rank: passes={lay.passes} "
                  f"rows_per_pass={lay.rows} "
                  f"(ranks_per_microbatch={lay.share}, "
                  f"side_by_side={lay.side})")
    return record


def _write(out_dir, cell_id, record, verbose):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_id + ".json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    if verbose:
        status = ("SKIP" if record.get("skipped")
                  else "OK" if record["ok"] else "FAIL")
        print(f"[{status}] {cell_id}"
              + (f"  ({record.get('skip_reason', '')})" if status == "SKIP"
                 else "")
              + (f"  ERROR: {record.get('error', '')}" if status == "FAIL"
                 else ""), flush=True)


def parse_set(items) -> dict:
    """``--set key=value`` items as ModelConfig overrides, each value a
    Python literal (``ast.literal_eval``)."""
    out = {}
    for kv in items:
        k, v = kv.split("=", 1)
        out[k] = ast.literal_eval(v)
    return out


def main(argv=None):
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models.registry import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--ce", default="gather", choices=("gather", "sharded"))
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override, e.g. --set remat='dots'")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the fake tensors sit (default: cuda where "
                         "a card is visible, else cpu)")
    args = ap.parse_args(argv)

    cfg_overrides = parse_set(args.set)

    cells = []
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    for a in archs:
        for s in shapes:
            cells.append((a, s))

    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    failures = 0
    for a, s in cells:
        cell_id = f"{a}__{s}__{mesh_name}__{args.tag}"
        path = os.path.join(args.out, cell_id + ".json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("ok"):
                    print(f"[CACHED] {cell_id}")
                    continue
        print(f"=== {cell_id} ===", flush=True)
        rec = run_cell(a, s, multi_pod=args.multi_pod, tag=args.tag,
                       microbatches=args.microbatches, out_dir=args.out,
                       cfg_overrides=cfg_overrides or None, ce=args.ce,
                       device=args.device)
        failures += 0 if rec["ok"] else 1
    print(f"dry-run complete: {len(cells)} cells, {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
