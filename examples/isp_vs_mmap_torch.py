"""The paper's experiment in one script, on the port's samplers and
engines: mmap-SSD vs SmartSAGE(SW) vs SmartSAGE(HW/SW) vs DRAM/PMEM
oracles, on a real sampler trace.

Replays GraphSAGE neighbor sampling (Algorithm 1) over a Kronecker
large-scale graph against each storage engine and prints the paper's
headline comparisons (Fig. 6/14/18 analogues).  Numpy only; the engines'
constants model the paper's machine (its SSD and a T4-class consumer,
``repro_torch.storage.specs``), not the card the port trains on.

Run:  PYTHONPATH=src python examples/isp_vs_mmap_torch.py [dataset]
"""

import sys

import numpy as np

from repro_torch.core.graph import load_dataset
from repro_torch.core.sampler import sample_khop
from repro_torch.storage.e2e import e2e_train
from repro_torch.storage.engines import ENGINES, make_engine

dataset = sys.argv[1] if len(sys.argv) > 1 else "reddit"
g = load_dataset(dataset, large_scale=True)
print(f"{g.name}: {g.num_nodes} nodes, {g.num_edges} edges "
      f"(avg degree {g.num_edges / g.num_nodes:.1f})\n")

rng = np.random.default_rng(0)
M = 1024
engines = {n: make_engine(n, g) for n in ENGINES}

# warm the stateful caches (page cache / scratchpad / FPGA DRAM)
for w in range(3):
    t = sample_khop(g, rng.integers(0, g.num_nodes, M), (25, 10), seed=w)
    for n in ("mmap", "directio", "fpga"):
        engines[n].batch_cost(t)

trace = sample_khop(g, rng.integers(0, g.num_nodes, M), (25, 10), seed=42)
print(f"one mini-batch (M={M}, fanouts 25x10): "
      f"{trace.touched_nodes.size} edge-list reads, "
      f"{sum(h.size for h in trace.hops[1:])} samples\n")

costs = {n: e.batch_cost(trace) for n, e in engines.items()}
base = costs["mmap"].time_s
print(f"{'engine':12s} {'sampling/batch':>14s} {'vs mmap':>8s} "
      f"{'link MB':>8s} {'I/O cmds':>9s}")
for n, c in costs.items():
    print(f"{n:12s} {c.time_s*1e3:11.1f} ms {base/c.time_s:7.1f}x "
          f"{c.link_bytes/1e6:8.2f} {c.commands:9d}")

print(f"\nSSD->host transfer reduction (mmap vs ISP): "
      f"{costs['mmap'].link_bytes / max(costs['isp'].link_bytes, 1):.1f}x "
      f"(paper: ~20x)")

print(f"\nend-to-end (12 producer workers, T4-class consumer):")
dram = e2e_train(engines["dram"], trace, workers=12)
for n in ("dram", "pmem", "mmap", "directio", "isp", "isp_oracle"):
    r = e2e_train(engines[n], trace, workers=12)
    print(f"{n:12s} {r.train_throughput:8.1f} batches/s  "
          f"GPU idle {r.gpu_idle_frac*100:5.1f}%  "
          f"(x{dram.train_throughput / r.train_throughput:.1f} slower "
          f"than DRAM oracle)")
