"""GraphSAGE training driver of the port.

  python -m repro_torch.launch.train --arch graphsage --backend pallas \\
      --dataset reddit --large-scale --batch 1024 --fanouts 25,10 \\
      --hidden 256 --steps 8

Runs on the GPU (``--device cuda``, the default) through the hand-written
CUDA kernels, or on the CPU through their plain PyTorch versions with
``--device cpu``.  Without a GPU and without ``--device cpu`` it stops
with an error.  Flags take the reference launcher's names and defaults;
the reference's stores, caches, checkpoints, prefetch and ``--spec`` are
not part of the port yet, and their flags are rejected.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import kernels
from repro_torch.core import (DATASETS, LOADERS, GNNConfig, GraphSAGE,
                              build_train_step, load_dataset, train_loop)
from repro_torch.optim import adamw


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
    ap.add_argument("--arch", default="graphsage", choices=("graphsage",))
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
    args = ap.parse_args(argv)
    if args.batch < 1 or args.steps < 0 or args.log_every < 1:
        ap.error("--batch and --log-every must be >= 1, --steps >= 0")
    return args


def run_gnn(args) -> tuple[object, list[float]]:
    """Train; returns the loop's ``RunStats`` and the per-step losses."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[train] no CUDA device: the port trains on the "
                         "GPU; pass --device cpu to run the plain kernels "
                         "on the CPU")
    device = torch.device(args.device)
    g = load_dataset(args.dataset, large_scale=args.large_scale)
    loader = LOADERS[args.backend](g, batch_size=args.batch,
                                   fanouts=args.fanouts, seed=args.seed,
                                   device=device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[train] {g.name}: {g.num_nodes} nodes {g.num_edges} edges, "
          f"backend={args.backend} batch={args.batch} "
          f"fanouts={args.fanouts} on {where}")
    cfg = GNNConfig(feat_dim=g.feat_dim, hidden=args.hidden,
                    n_classes=int(g.labels.max()) + 1, fanouts=args.fanouts)
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
    print(f"[train] {stats.steps} steps in {stats.wall_s:.1f}s "
          f"({stats.steps_per_s:.2f} steps/s, consumer idle "
          f"{stats.idle_fraction:.1%}) loader={loader.stats()}")
    print(f"[train] kernel launches: {dict(kernels.LAUNCHES)}")
    loader.close()
    return stats, [float(x) for x in losses]


def main(argv=None):
    return run_gnn(parse_args(argv))


if __name__ == "__main__":
    main()
