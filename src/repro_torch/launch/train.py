"""Training entry point of the port: GraphSAGE and the LMs (the dense,
moe, ssm and hybrid families, and qwen2-vl-7b).

GraphSAGE with near-data (ISP) subgraph generation, the graph partitioned
over a mesh of 4 shards (the default backend is ``isp``, as in the
reference; shards share the card when there are fewer cards than shards):

  python -m repro_torch.launch.train --arch graphsage --dataset reddit \\
      --steps 100 --devices 4

The kernel data plane, sampling and gathering in the hand-written CUDA
kernels:

  python -m repro_torch.launch.train --arch graphsage --backend pallas \\
      --dataset reddit --large-scale --batch 1024 --fanouts 25,10 \\
      --hidden 256 --steps 8

Out of core, with the graph on disk behind a 4 MB page cache and both
device caches:

  python -m repro_torch.launch.train --arch graphsage --backend pallas \\
      --dataset reddit --large-scale --batch 1024 --fanouts 25,10 \\
      --hidden 256 --graph-store disk --cache-mb 4 \\
      --device-cache-rows 4096 --edge-cache-blocks 128 \\
      --device-cache-policy pinned --steps 8

Out of core and overlapped, the same with ``--io-threads 4 --prefetch 2
--overlap 1 --stage-depth 2 --plan-ahead 2`` runs the sample, resolve
and admit stages on lanes of their own (``core.pipeline``), each on its
own CUDA stream.  A whole data-plane configuration loads from a spec
file, flags overriding its fields:

  python -m repro_torch.launch.train --arch graphsage \\
      --spec benchmarks/specs/smoke_pallas_overlap.json --steps 4

Belady (optimal) eviction in both tiers, from a sampler replay 8 batches
ahead (``storage.oracle``), on the out-of-core command above:

  ... --cache-policy optimal --cache-oracle-window 8 \\
      --device-cache-policy optimal --device-cache-oracle-window 8

The host backend, the paper's CPU data preparation (numpy sampling and
gathers in the producer threads of the spec's ``backend.n_workers``), in
memory or over the disk store (``--sampler saint --walk-length 3`` trains
on GraphSAINT walks):

  python -m repro_torch.launch.train --arch graphsage --backend host \\
      --dataset reddit --batch 1024 --fanouts 25,10 --hidden 256 \\
      --graph-store disk --cache-mb 4 --steps 8

``--store-mode isp`` serves the disk layout from a storage process of its
own (the in-storage processing service, ``repro_torch.isp``, over a unix
socket at ``<store dir>/.isp.sock`` unless ``--isp-address`` says
otherwise): the host backend pushes its k-hop sampling and gathers down
to it, and the pallas backend's device caches fetch their misses through
it.  ``--trace-out t.json --metrics-out m.jsonl`` write a Perfetto trace
of the lanes, the consumer and the disk reads, and JSONL snapshots of the
canonical counters (``repro_torch.obs``); every GNN run ends with the
``[obs] epoch summary`` table.  ``--storage-engine mmap|directio|isp|...``
attaches the storage simulator (``storage.engines``, the paper's machine):
each batch pays the modeled latency of its access trace, the tail line's
``simulated_storage_s`` sums it, and over a disk store the run prints the
``measured-vs-simulated`` report beside the store's real counters.

An LM of the dense family (qwen2-0.5b at full width, 4 x 4096 tokens a
step), attention through the flash forward and backward kernels:

  python -m repro_torch.launch.train --arch qwen2-0.5b --batch 4 \\
      --seq-len 4096 --steps 5 --log-every 1

The moe family (mixtral-8x7b, moonshot-v1-16b-a3b) trains alike, its
load-balancing loss added to the cross-entropy at the reference's
weight (``train.steps.MOE_AUX_WEIGHT``); at full width neither fits one
card's optimizer state, so ``--reduced`` trains the small config:

  python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b \\
      --reduced --batch 4 --seq-len 32 --steps 4 --log-every 1

The ssm and hybrid families (mamba2-370m, hymba-1.5b) train at full
width, the SSD scan through its kernel in the forward (and in each
layer's recompute under ``remat="full"``) and autograd of its plain
version in the backward (``ops.SSDChunkScan``):

  python -m repro_torch.launch.train --arch mamba2-370m --batch 4 \\
      --seq-len 4096 --steps 5 --log-every 1

Runs on the GPU (``--device cuda``, the default) through the hand-written
CUDA kernels, or on the CPU through their plain PyTorch versions with
``--device cpu``.  Without a GPU and without ``--device cpu`` it stops
with an error.  The data-plane flags are generated from the spec's field
table (``core.config.FLAG_TABLE``, ``add_pipeline_args``) and have the
reference's names and defaults, ``--backend`` defaulting to ``isp`` as
the reference's launcher sets it.  ``--devices N`` sets the GNN mesh's
``data`` axis (``launch.mesh``); an LM's mesh, and ``--mesh``, belong to
ROADMAP item 16.  Every run goes through
``core.config.build_pipeline``: ``--graph-store disk`` writes the
graph to ``--store-dir`` (or a temp directory the run owns and removes)
and reads it through a ``DiskStore``; without a device cache tier the
pallas backend never reads through the store and proceeds in memory, as
the reference does.  The LM branch is the reference's ``run_lm``: the
reference's seed-0 weights (``jax.random.normal``'s stream, drawn on the
device), ``TokenPipeline`` batches (``--batch`` through
``fill_pipeline_flag_defaults``), AdamW on ``warmup_cosine(lr, 10,
steps)``; ``--reduced`` trains the small same-family config,
``--attn-impl`` picks the flash kernels (default) or the chunked plain
path.  qwen2-vl-7b trains on the pipeline's int32 tokens, which its
``embed`` table looks up, as the reference's does.  seamless-m4t-large-v2
exits 2: ``TokenPipeline`` batches carry no ``src_embeds`` for its
encoder, where the reference's ``run_lm`` raises ``KeyError:
'src_embeds'`` (the port trains the encdec family through
``train.steps.build_train_step`` on ``launch.shapes.make_batch``
batches).  GraphSAGE starts from the reference's
``GraphSAGE.init(jax.random.key(0))`` weights, so the same flags log the
reference launcher's losses.

Checkpoints, for the GNN and the LM alike, as the reference's launcher
writes them (``repro_torch.checkpoint``, the reference's format):
``--ckpt-dir DIR`` saves every ``--ckpt-every`` steps (default 25) and
at the end, on a background writer, and a run whose ``DIR`` already
holds a checkpoint resumes from its latest step (``resumed from step
N``).  ``--resume`` demands one (an empty ``DIR`` stops with "no
checkpoints") and, without ``--spec``, rebuilds the GNN's data plane from
the checkpoint manifest's ``pipeline_spec``.  Batches are pure functions
of the step, so a resumed run logs the uninterrupted run's losses:

  python -m repro_torch.launch.train --arch graphsage --steps 4 \
      --ckpt-dir /tmp/ck --ckpt-every 2
  python -m repro_torch.launch.train --arch graphsage --steps 8 \
      --ckpt-dir /tmp/ck --resume
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import kernels, obs
from repro_torch.core import (DATASETS, GNNConfig, GraphSAGE, PipelineSpec,
                              add_pipeline_args, build_pipeline,
                              build_train_step, fill_pipeline_flag_defaults,
                              load_dataset, spec_from_args, train_loop)
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import count_params, init_params
from repro_torch.models.registry import ARCH_IDS, get_config
from repro_torch.models.transformer import LM, build_defs
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import steps as lm_steps


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="graphsage",
                    choices=("graphsage",) + ARCH_IDS)
    # the data-plane flags (--backend, --fanouts, --batch, --seed,
    # --prefetch, --overlap, --graph-store, --cache-*, --device-cache-*,
    # --edge-cache-blocks, --storage-engine, --spec, ...) are generated
    # from the spec's field table
    add_pipeline_args(ap, overrides={"backend": "isp"})
    ap.add_argument("--dataset", default="reddit", choices=tuple(DATASETS))
    ap.add_argument("--large-scale", action="store_true")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--devices", type=int, default=1,
                    help="shards of the GNN mesh's 'data' axis (the isp "
                         "backend partitions the graph over them)")
    # the LM's flags, with the reference's names and defaults
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family LM config (CPU)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn-impl", default="flash",
                    choices=("chunked", "flash"),
                    help="LM attention: the flash kernels or the chunked "
                         "plain path (sets ModelConfig.attn_impl)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir "
                         "(error if none exists); without --spec, the data "
                         "plane is rebuilt from the pipeline_spec embedded "
                         "in the checkpoint manifest, so the resumed run's "
                         "batches are bit-identical to the original's")
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir (where would the checkpoint "
                 "come from?)")
    args.pipeline_spec = None
    if args.arch == "graphsage":
        try:
            args.pipeline_spec = spec_from_args(args)
        except (ValueError, OSError) as e:
            ap.error(str(e))
    elif args.devices > 1:
        ap.error("--devices > 1 shards the GNN's mesh; an LM's mesh is "
                 "not part of the port yet (ROADMAP item 16)")
    elif get_config(args.arch).family == "encdec":
        ap.error(f"{args.arch} has an encoder over src_embeds, and "
                 "TokenPipeline batches carry no src_embeds (the "
                 "reference's run_lm raises KeyError: 'src_embeds' here); "
                 "train it through train.steps.build_train_step on "
                 "launch.shapes.make_batch(kind='train') batches")
    # resolve the "not given" sentinels for code that reads flags directly
    # (the LM's --batch); after the spec is assembled
    fill_pipeline_flag_defaults(args)
    args.device_tier = (args.pipeline_spec.device_cache_tier()
                        if args.pipeline_spec is not None else None)
    if args.batch < 1 or args.steps < 0 or args.log_every < 1 \
            or args.ckpt_every < 1 or args.devices < 1:
        ap.error("--batch, --log-every, --ckpt-every and --devices must be "
                 ">= 1, --steps >= 0")
    if args.seq_len < 1 or args.microbatches < 1 \
            or args.batch % args.microbatches:
        ap.error("--seq-len and --microbatches must be >= 1, and "
                 "--microbatches must divide --batch")
    return args


def _device(args) -> torch.device:
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[train] no CUDA device: the port trains on the "
                         "GPU; pass --device cpu to run the plain kernels "
                         "on the CPU")
    return torch.device(args.device)


def _check_resume(args) -> None:
    if args.resume and ckpt.latest_step(args.ckpt_dir) is None:
        raise SystemExit(
            f"[train] --resume: no checkpoints in {args.ckpt_dir}")


@torch.no_grad()
def _copy_into(dst: dict, src: dict, where: str = "") -> None:
    """Copy a restored tree's leaves into the live tensors of ``dst`` in
    place (parameters a module or the optimizer updates in place)."""
    if set(dst) != set(src):
        raise ValueError(f"checkpoint tree {where or '/'} has keys "
                         f"{sorted(src)}, the run {sorted(dst)}")
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k], f"{where}/{k}")
        else:
            if v.shape != src[k].shape:
                raise ValueError(f"checkpoint leaf {where}/{k} has shape "
                                 f"{tuple(src[k].shape)}, the run "
                                 f"{tuple(v.shape)}")
            v.copy_(src[k])


def _restore_latest(args, state: dict, device) -> int:
    """Restore the latest checkpoint of ``--ckpt-dir`` into ``state`` (its
    ``params`` and ``opt`` trees in place) and return its step, or 0
    when there is none."""
    if not args.ckpt_dir or ckpt.latest_step(args.ckpt_dir) is None:
        return 0
    restored, start = ckpt.restore(args.ckpt_dir, device=device)
    _copy_into(state["params"], restored["params"], "/params")
    _copy_into(state["opt"], restored["opt"], "/opt")
    state["step"] = int(restored["step"])
    print(f"[train] resumed from step {start}")
    return int(start)


def run_gnn(args) -> tuple[object, list[float], dict]:
    """Train through ``build_pipeline(args.pipeline_spec)`` (or, resuming
    without ``--spec``, the checkpoint manifest's ``pipeline_spec``);
    returns the loop's ``RunStats``, the per-step losses of the steps run
    and the pipeline's final ``stats()``."""
    device = _device(args)
    spec = args.pipeline_spec
    if args.resume:
        _check_resume(args)
        if not args.spec:
            manifest = ckpt.read_manifest(args.ckpt_dir)
            if "pipeline_spec" in manifest:
                spec = PipelineSpec.from_dict(manifest["pipeline_spec"])
                print("[train] --resume: data plane restored from the "
                      "checkpoint manifest's pipeline_spec")
    g = load_dataset(args.dataset, large_scale=args.large_scale)
    mesh = make_mesh((args.devices, 1), ("data", "model"), device=device)
    pipe = build_pipeline(spec, g, mesh=mesh, device=device)
    try:
        for note in pipe.notes:
            print(f"[train] note: {note}")
        where = (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu")
        if pipe.backend == "isp":
            where += f", mesh of {args.devices} shard(s)"
        print(f"[train] {g.name}: {g.num_nodes} nodes {g.num_edges} edges, "
              f"{pipe.describe()}, batch={spec.batch_size} "
              f"fanouts={spec.sampler.fanouts} on {where}")
        store = pipe.store
        if store is not None and getattr(store, "kind", None) == "isp":
            c = store.client
            print(f"[train] graph store: in-storage processing service at "
                  f"{c.kind}:{c.address} (pid "
                  f"{store.server_proc.pid if store.server_proc else '-'}, "
                  f"window={c.window}, block {store.block_bytes} B) — "
                  "sample+gather pushed down to the storage process")
        elif store is not None:
            print(f"[train] graph store: disk at {store.path} "
                  f"({store.nbytes_on_disk() / 2**20:.1f} MB on disk, "
                  f"page cache {store.cache_blocks} x {store.block_bytes} B "
                  f"= {store.cache_blocks * store.block_bytes / 2**20:.1f} "
                  f"MB, policy={store.policy}, "
                  f"lock_shards={store.lock_shards}, "
                  f"io_threads={store.io_threads})")
        cfg = GNNConfig(feat_dim=g.feat_dim, hidden=args.hidden,
                        n_classes=int(g.labels.max()) + 1,
                        fanouts=spec.effective_fanouts)
        gnn = GraphSAGE(cfg, device=device)
        opt = adamw(args.lr)
        step_fn = build_train_step(pipe, gnn, opt)
        params = dict(gnn.named_parameters())
        state = {"opt": opt.init(params), "step": 0}
        saver = None
        start = 0
        if args.ckpt_dir:
            # every checkpoint manifest records the data-plane spec that
            # produced it
            saver = ckpt.AsyncSaver(
                args.ckpt_dir,
                manifest_extra={"pipeline_spec": spec.to_dict()})
            full = {"params": params, **state}
            start = _restore_latest(args, full, device)
            state["step"] = full["step"]
        losses = []

        def on_step(i, state, metrics):
            losses.append(metrics["loss"])
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"  step {i+1:5d} loss={m['loss']:.4f} "
                      f"acc={m['acc']:.3f} |g|={m['grad_norm']:.3f}")
            if saver and (i + 1) % args.ckpt_every == 0:
                saver.save_async(i + 1, {"params": params, **state})

        state, stats = train_loop(pipe, step_fn, state, steps=args.steps,
                                  start=start, on_step=on_step)
        if saver:
            saver.save_async(args.steps, {"params": params, **state})
            saver.wait()
        loader_stats = pipe.stats()
        replayer = getattr(store, "_oracle_replayer", None)
        if "oracle" not in loader_stats and replayer is not None:
            # the host backend's replay lane belongs to the store
            loader_stats["oracle"] = replayer.stats()
        print(f"[train] {stats.steps} steps in {stats.wall_s:.1f}s "
              f"({stats.steps_per_s:.2f} steps/s, consumer idle "
              f"{stats.idle_fraction:.1%}) loader={loader_stats}")
        print(f"[train] kernel launches: {dict(kernels.LAUNCHES)}")
        # the per-epoch summary table, rendered from the canonical metric
        # namespace (repro_torch.obs.names)
        metrics = obs.names.flatten_stats(loader_stats)
        metrics.update(obs.names.train_metrics(
            stats.steps, stats.idle_s, stats.busy_s, stats.steps_per_s,
            stats.idle_fraction))
        print(obs.epoch_summary(metrics))
        if pipe.obs is not None:
            if spec.obs.trace_path:
                print(f"[obs] trace -> {spec.obs.trace_path} "
                      "(open at https://ui.perfetto.dev)")
            if spec.obs.metrics_path:
                print(f"[obs] metrics snapshots -> {spec.obs.metrics_path}")
        if spec.prefetch.depth:
            ls = loader_stats
            print(f"[train] lanes: stages {ls.get('stages', ['produce'])}, "
                  f"seconds {ls.get('stage_s')}, restarts "
                  f"{ls['prefetch_restarts']} (watchdog "
                  f"{ls.get('lane_stall_restarts', 0)}), degraded "
                  f"{ls.get('degraded', False)}, plan_ahead "
                  f"{ls.get('plan_ahead', 0)}, warmed ranges "
                  f"{ls.get('planner_warm_ranges', 0)}")
        for kind, noun in (("devcache", "rows"), ("edgecache", "blocks")):
            dc = loader_stats.get(kind)
            if dc:
                print(f"[train] device {kind}: {dc['capacity_rows']} {noun} "
                      f"({dc['policy']}, {dc['pinned_rows']} pinned), "
                      f"hits={dc['hits']} misses={dc['misses']} "
                      f"evictions={dc['evictions']} "
                      f"({dc['bytes_uploaded'] / 2**20:.1f} MB uploaded)")
        if "oracle" in loader_stats:
            print(f"[train] oracle: {loader_stats['oracle']}")
        if store is not None:
            io = store.io_counters()
            print(f"[train] disk-store I/O: {io['requests']} requests, "
                  f"{io['block_fetches']} block fetches "
                  f"({io['bytes_fetched'] / 2**20:.1f} MB from disk), "
                  f"cache hits={io['hits']} misses={io['misses']} "
                  f"evictions={io['evictions']}")
            if getattr(store, "kind", None) == "isp":
                w = store.isp_counters()
                print(f"[train] isp wire: {w['requests']} commands, "
                      f"{w['bytes_tx'] / 2**20:.2f} MB tx / "
                      f"{w['bytes_rx'] / 2**20:.2f} MB rx "
                      f"(vs {io['bytes_fetched'] / 2**20:.1f} MB read from "
                      f"flash server-side), disconnects={w['disconnects']} "
                      f"reconnects={w['reconnects']}")
            if pipe.engine is not None and hasattr(pipe.engine, "report"):
                print(f"[train] measured-vs-simulated: {pipe.engine.report()}")
        return stats, [float(x) for x in losses], loader_stats
    finally:
        # a failed or interrupted run must not leak fds, lanes or the temp
        # copy of the graph
        pipe.close()


def run_lm(args) -> dict:
    """Train an LM on ``TokenPipeline`` batches (the reference's
    ``run_lm``).
    Returns the per-step losses, grad norms and wall ms (each step ends
    in a device synchronize), tok/s over the run, and the peak device
    memory on the card."""
    device = _device(args)
    _check_resume(args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    defs = build_defs(cfg)
    params = init_params(defs, seed=0, device=device)
    model = LM(cfg, params, trainable=True)
    print(f"[train] {cfg.name}: {count_params(defs) / 1e6:.2f}M params "
          f"({model.active_param_count() / 1e6:.2f}M active), "
          f"attn_impl={cfg.attn_impl}, remat={cfg.remat}, on {device}")
    opt = adamw(warmup_cosine(args.lr, 10, args.steps))
    step_fn = lm_steps.build_train_step(model, opt,
                                        microbatches=args.microbatches)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                         global_batch=args.batch)
    state = lm_steps.init_train_state(model, opt)
    saver = None
    start = 0
    if args.ckpt_dir:
        saver = ckpt.AsyncSaver(args.ckpt_dir)
        start = _restore_latest(args, state, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = {"losses": [], "grad_norms": [], "step_ms": []}
    sync()
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        t1 = time.perf_counter()
        state, metrics = step_fn(state, pipe.torch_batch(i, device))
        sync()
        out["step_ms"].append(1e3 * (time.perf_counter() - t1))
        out["losses"].append(metrics["loss"])
        out["grad_norms"].append(metrics["grad_norm"])
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"  step {i+1:5d} loss={m['loss']:.4f} "
                  f"|g|={m['grad_norm']:.3f} lr={m['lr']:.2e}")
        if saver and (i + 1) % args.ckpt_every == 0:
            saver.save_async(i + 1, state)
    if saver:
        saver.save_async(args.steps, state)
        saver.wait()
    dt = time.perf_counter() - t0
    tokens = (args.steps - start) * args.batch * args.seq_len
    out.update(losses=[float(x) for x in out["losses"]],
               grad_norms=[float(x) for x in out["grad_norms"]],
               wall_s=dt, tok_per_s=tokens / max(dt, 1e-9),
               peak_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None))
    print(f"[train] {args.steps - start} steps in {dt:.1f}s "
          f"({out['tok_per_s']:.0f} tok/s)"
          + (f", peak device memory {out['peak_bytes'] / 2**30:.2f} GiB"
             if out["peak_bytes"] is not None else ""))
    print(f"[train] kernel launches: {dict(kernels.LAUNCHES)}")
    return out


def main(argv=None):
    args = parse_args(argv)
    if args.arch == "graphsage":
        return run_gnn(args)
    return run_lm(args)


if __name__ == "__main__":
    main()
