"""Quickstart of the PyTorch port: SmartSAGE in ~60 lines.

Trains GraphSAGE on the reddit-sized power-law graph through the unified
minibatch data plane: pick a data-preparation backend (``isp``, near-data
sampling on a mesh of 4 shards; ``host``, the numpy producer pipeline;
``pallas``, the hand-written CUDA kernels) and every one feeds the same
consumer with the same ``Minibatch`` contract (the paper's backend
comparison, live).  ``isp`` and ``pallas`` print the same losses.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [backend] \\
          [--device cpu]
"""

import argparse

from repro_torch.core import (GNNConfig, GraphSAGE, build_train_step,
                              load_dataset, make_loader, train_loop)
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import adamw

ap = argparse.ArgumentParser()
ap.add_argument("backend", nargs="?", default="isp",
                choices=("isp", "host", "pallas"))
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
args = ap.parse_args()
FANOUTS = (10, 5)
BATCH = 64
STEPS = 30

# 1. A power-law graph (Table I methodology).
graph = load_dataset("reddit", large_scale=False)
print(f"graph: {graph.num_nodes} nodes, {graph.num_edges} edges, "
      f"{graph.feat_dim}-d features")

# 2. Mesh + the chosen data-preparation backend.  For `isp` the cold graph
#    lives partitioned over the mesh's 'data' axis (4 shards, sharing the
#    card when there is one); the other backends prepare data on one
#    device.
mesh = make_mesh((4, 1), ("data", "model"), device=args.device)
loader = make_loader(args.backend, graph, batch_size=BATCH, fanouts=FANOUTS,
                     mesh=mesh, device=args.device)
print(f"backend: {args.backend} on {args.device}")

# 3. The shared GraphSAGE consumer: one update step over whatever
#    Minibatch the backend produced (sample -> gather -> convolve -> AdamW).
gnn = GraphSAGE(GNNConfig(feat_dim=graph.feat_dim, hidden=128,
                          n_classes=int(graph.labels.max()) + 1,
                          fanouts=FANOUTS), device=args.device)
opt = adamw(1e-3)
step = build_train_step(loader, gnn, opt)
state = {"opt": opt.init(dict(gnn.named_parameters())), "step": 0}


def log(i, state, m):
    if (i + 1) % 10 == 0:
        print(f"step {i+1:3d}  loss={float(m['loss']):.4f}  "
              f"acc={float(m['acc']):.3f}")


state, stats = train_loop(loader, step, state, steps=STEPS, on_step=log)
loader.close()

print(f"{stats.steps_per_s:.2f} steps/s, consumer idle "
      f"{stats.idle_fraction:.1%}")
print("done — see examples/isp_vs_mmap_torch.py for the storage-tier story")
