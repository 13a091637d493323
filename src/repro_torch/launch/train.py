"""Training entry point of the port: GraphSAGE and the dense-family LMs.

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

An LM of the dense family (qwen2-0.5b at full width, 4 x 4096 tokens a
step), attention through the flash forward and backward kernels:

  python -m repro_torch.launch.train --arch qwen2-0.5b --batch 4 \\
      --seq-len 4096 --steps 5 --log-every 1

Runs on the GPU (``--device cuda``, the default) through the hand-written
CUDA kernels, or on the CPU through their plain PyTorch versions with
``--device cpu``.  Without a GPU and without ``--device cpu`` it stops
with an error.  Flags take the reference launcher's names and defaults.
``--graph-store disk`` writes the graph to ``--store-dir`` (or a temp
directory the run owns and removes) and reads it through a ``DiskStore``;
without a device cache tier the pallas backend never reads through the
store and proceeds in memory, as the reference does.  The reference's
``--spec``, prefetch and overlap, fault injection, direct I/O, ISP mode,
the ``optimal`` policies, telemetry and checkpoints (``--ckpt-dir``,
``--resume``, for the GNN and the LM alike) are not part of the port yet,
and their flags are rejected.  The LM branch is the reference's
``run_lm``: weights from seed 0, ``TokenPipeline`` batches, AdamW on
``warmup_cosine(lr, 10, steps)``; ``--reduced`` trains the small
same-family config, ``--attn-impl`` picks the flash kernels (default) or
the chunked plain path; archs outside the dense family raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
import time

import torch

from repro_torch import kernels
from repro_torch.core import (DATASETS, LOADERS, DeviceTierSpec, GNNConfig,
                              GraphSAGE, build_train_step, load_dataset,
                              train_loop)
from repro_torch.data import TokenPipeline
from repro_torch.models.params import count_params, init_params, tree_map
from repro_torch.models.registry import ARCH_IDS, get_config
from repro_torch.models.transformer import LM, build_defs
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.storage import DEFAULT, RetrySpec, open_store
from repro_torch.train import steps as lm_steps

POLICIES = ("lru", "pinned")


def _fanouts(s: str) -> tuple[int, ...]:
    try:
        f = tuple(int(x) for x in s.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(f"bad fanouts {s!r}") from None
    if not f or min(f) < 1:
        raise argparse.ArgumentTypeError(f"fanouts must be positive: {s!r}")
    return f


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="graphsage",
                    choices=("graphsage",) + ARCH_IDS)
    ap.add_argument("--backend", default="pallas", choices=tuple(LOADERS),
                    help="data-preparation backend (the CUDA kernels)")
    ap.add_argument("--dataset", default="reddit", choices=tuple(DATASETS))
    ap.add_argument("--large-scale", action="store_true")
    ap.add_argument("--batch", type=int, default=64, help="minibatch size")
    ap.add_argument("--fanouts", type=_fanouts, default=(10, 5),
                    metavar="F1,F2,...", help="per-hop fanouts")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0,
                    help="per-batch target/sampling seed")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # the LM's flags, with the reference's names and defaults
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family LM config (CPU)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn-impl", default="flash",
                    choices=("chunked", "flash"),
                    help="LM attention: the flash kernels or the chunked "
                         "plain path (sets ModelConfig.attn_impl)")
    # the store and cache-tier flags, with the reference's names and
    # defaults (core/config.py FLAG_TABLE and _spec_defaults)
    ap.add_argument("--graph-store", default="mem", choices=("mem", "disk"),
                    help="where the graph data lives: 'mem' = DRAM arrays, "
                         "'disk' = out-of-core DiskStore (block-aligned "
                         "on-disk layout + live page cache)")
    ap.add_argument("--store-dir", default=None,
                    help="directory for the on-disk graph layout (default: "
                         "a fresh temp dir; reused if it holds a manifest)")
    ap.add_argument("--cache-mb", type=float, default=None,
                    help="host tier: disk-store page-cache budget in MB "
                         f"(default {DEFAULT.diskstore.cache_mb})")
    ap.add_argument("--cache-policy", default=DEFAULT.diskstore.policy,
                    choices=POLICIES, help="host tier placement")
    ap.add_argument("--lock-shards", type=int, default=None,
                    help="disk-store page-cache lock shards (default "
                         f"{DEFAULT.diskstore.lock_shards})")
    ap.add_argument("--io-threads", type=int, default=None,
                    help="disk-store pread pool size (default "
                         f"{DEFAULT.diskstore.io_threads}: serial reads)")
    ap.add_argument("--verify-blocks", type=int, default=0, choices=(0, 1),
                    metavar="0|1",
                    help="1 = verify each block read's CRC32C")
    ap.add_argument("--io-retries", type=int,
                    default=RetrySpec.max_attempts,
                    help="total attempts per block read before failing")
    ap.add_argument("--io-retry-backoff", type=float,
                    default=RetrySpec.backoff_s,
                    help="sleep before the first retry, doubled per retry")
    ap.add_argument("--io-deadline", type=float,
                    default=RetrySpec.deadline_s,
                    help="per-attempt wall-clock budget in seconds")
    ap.add_argument("--device-cache-rows", type=int, default=0,
                    help="device tier: feature-cache capacity in rows "
                         "(0 = full-table upload)")
    ap.add_argument("--edge-cache-blocks", type=int, default=0,
                    help="device tier: edge-block cache capacity in "
                         "BLOCK_E-wide blocks (0 = full edge-array upload)")
    ap.add_argument("--device-cache-policy", default=DEFAULT.devcache.policy,
                    choices=POLICIES, help="device tier placement")
    ap.add_argument("--device-cache-pinned-fraction", type=float,
                    default=DEFAULT.devcache.pinned_fraction,
                    help="device tier: fraction of the capacity staged "
                         "permanently under the pinned policy")
    args = ap.parse_args(argv)
    if args.batch < 1 or args.steps < 0 or args.log_every < 1:
        ap.error("--batch and --log-every must be >= 1, --steps >= 0")
    if args.seq_len < 1 or args.microbatches < 1 \
            or args.batch % args.microbatches:
        ap.error("--seq-len and --microbatches must be >= 1, and "
                 "--microbatches must divide --batch")
    for flag in ("lock_shards", "io_threads"):
        v = getattr(args, flag)
        if v is not None and v < 1:
            ap.error(f"--{flag.replace('_', '-')} must be >= 1")
    if args.cache_mb is not None and args.cache_mb <= 0:
        ap.error("--cache-mb must be > 0")
    try:
        args.retry = RetrySpec(max_attempts=args.io_retries,
                               backoff_s=args.io_retry_backoff,
                               deadline_s=args.io_deadline)
        args.device_tier = None
        if args.device_cache_rows or args.edge_cache_blocks:
            args.device_tier = DeviceTierSpec(
                rows=args.device_cache_rows,
                edge_blocks=args.edge_cache_blocks,
                policy=args.device_cache_policy,
                pinned_fraction=args.device_cache_pinned_fraction)
    except ValueError as e:
        ap.error(str(e))
    return args


def _open_store(args, g):
    """The store the flags ask for, as the reference's ``build_pipeline``
    opens it: ``(store, temp_dir_owned, note)``."""
    if args.graph_store != "disk":
        return None, None, None
    if args.device_tier is None:
        return None, None, ("pallas without a device cache tier never reads "
                            "through the store; proceeding in-memory "
                            "(full-table upload)")
    path = args.store_dir
    tmpdir = None
    if path is None:
        path = tmpdir = tempfile.mkdtemp(prefix=f"graphstore-{g.name}-")
    kw = {}
    if args.lock_shards is not None:
        kw["lock_shards"] = args.lock_shards
    if args.io_threads is not None:
        kw["io_threads"] = args.io_threads
    try:
        store = open_store("disk", g=g, path=path, cache_mb=args.cache_mb,
                           policy=args.cache_policy,
                           verify=bool(args.verify_blocks),
                           retry=args.retry, **kw)
    except BaseException:
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    return store, tmpdir, None


def _device(args) -> torch.device:
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[train] no CUDA device: the port trains on the "
                         "GPU; pass --device cpu to run the plain kernels "
                         "on the CPU")
    return torch.device(args.device)


def run_gnn(args) -> tuple[object, list[float], dict]:
    """Train; returns the loop's ``RunStats``, the per-step losses and the
    loader's final ``stats()``."""
    device = _device(args)
    g = load_dataset(args.dataset, large_scale=args.large_scale)
    store, tmpdir, note = _open_store(args, g)
    loader = None
    try:
        if note:
            print(f"[train] note: {note}")
        loader = LOADERS[args.backend](
            g, batch_size=args.batch, fanouts=args.fanouts, seed=args.seed,
            device=device, store=store,
            device_tier=args.device_tier if store is not None else None)
        where = (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu")
        print(f"[train] {g.name}: {g.num_nodes} nodes {g.num_edges} edges, "
              f"backend={args.backend} batch={args.batch} "
              f"fanouts={args.fanouts} store={args.graph_store} on {where}")
        if store is not None:
            print(f"[train] graph store: disk at {store.path} "
                  f"({store.nbytes_on_disk() / 2**20:.1f} MB on disk, "
                  f"page cache {store.cache_blocks} x {store.block_bytes} B "
                  f"= {store.cache_blocks * store.block_bytes / 2**20:.1f} "
                  f"MB, policy={store.policy}, "
                  f"lock_shards={store.lock_shards})")
        cfg = GNNConfig(feat_dim=g.feat_dim, hidden=args.hidden,
                        n_classes=int(g.labels.max()) + 1,
                        fanouts=args.fanouts)
        gnn = GraphSAGE(cfg, device=device)
        opt = adamw(args.lr)
        step_fn = build_train_step(loader, gnn, opt)
        state = {"opt": opt.init(dict(gnn.named_parameters())), "step": 0}
        losses = []

        def on_step(i, state, metrics):
            losses.append(metrics["loss"])
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"  step {i+1:5d} loss={m['loss']:.4f} "
                      f"acc={m['acc']:.3f} |g|={m['grad_norm']:.3f}")

        _, stats = train_loop(loader, step_fn, state, steps=args.steps,
                              on_step=on_step)
        loader_stats = loader.stats()
        print(f"[train] {stats.steps} steps in {stats.wall_s:.1f}s "
              f"({stats.steps_per_s:.2f} steps/s, consumer idle "
              f"{stats.idle_fraction:.1%}) loader={loader_stats}")
        print(f"[train] kernel launches: {dict(kernels.LAUNCHES)}")
        for kind, noun in (("devcache", "rows"), ("edgecache", "blocks")):
            dc = loader_stats.get(kind)
            if dc:
                print(f"[train] device {kind}: {dc['capacity_rows']} {noun} "
                      f"({dc['policy']}, {dc['pinned_rows']} pinned), "
                      f"hits={dc['hits']} misses={dc['misses']} "
                      f"evictions={dc['evictions']} "
                      f"({dc['bytes_uploaded'] / 2**20:.1f} MB uploaded)")
        if store is not None:
            io = store.io_counters()
            print(f"[train] disk-store I/O: {io['requests']} requests, "
                  f"{io['block_fetches']} block fetches "
                  f"({io['bytes_fetched'] / 2**20:.1f} MB from disk), "
                  f"cache hits={io['hits']} misses={io['misses']} "
                  f"evictions={io['evictions']}")
        return stats, [float(x) for x in losses], loader_stats
    finally:
        # a failed or interrupted run must not leak fds or the temp copy
        # of the graph
        if loader is not None:
            loader.close()
        if store is not None:
            store.close()
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)


def run_lm(args) -> dict:
    """Train an LM of the dense family (the reference's ``run_lm``).
    Returns the per-step losses, grad norms and wall ms (each step ends
    in a device synchronize), tok/s over the run, and the peak device
    memory on the card."""
    device = _device(args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    defs = build_defs(cfg)
    params = tree_map(lambda t: t.to(device), init_params(defs, seed=0))
    model = LM(cfg, params, trainable=True)
    print(f"[train] {cfg.name}: {count_params(defs) / 1e6:.2f}M params, "
          f"attn_impl={cfg.attn_impl}, remat={cfg.remat}, on {device}")
    opt = adamw(warmup_cosine(args.lr, 10, args.steps))
    step_fn = lm_steps.build_train_step(model, opt,
                                        microbatches=args.microbatches)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                         global_batch=args.batch)
    state = lm_steps.init_train_state(model, opt)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = {"losses": [], "grad_norms": [], "step_ms": []}
    sync()
    t0 = time.perf_counter()
    for i in range(args.steps):
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
    dt = time.perf_counter() - t0
    tokens = args.steps * args.batch * args.seq_len
    out.update(losses=[float(x) for x in out["losses"]],
               grad_norms=[float(x) for x in out["grad_norms"]],
               wall_s=dt, tok_per_s=tokens / max(dt, 1e-9),
               peak_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None))
    print(f"[train] {args.steps} steps in {dt:.1f}s "
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
