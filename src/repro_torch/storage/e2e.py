"""End-to-end GNN-training time model (paper Fig. 4/6/7/18).

The port's copy of the reference's ``storage/e2e.py`` (numpy only).
Combines a storage engine's data-preparation cost with the feature-gather
stage and the GPU-side GNN step under the producer-consumer model:

  producer throughput  = engine throughput(W workers)  [storage model]
  consumer throughput  = 1 / t_gpu                     [FLOPs model]
  training throughput  = min(producer, consumer)
  GPU idle fraction    = max(0, 1 - producer/consumer)  (Fig. 7)

The GPU step time uses a FLOPs estimate of the dense fixed-fanout
GraphSAGE backend on the paper's Tesla T4 (specs.HostSpec.gpu_flops),
identical across engines: only data preparation differs, which is the
paper's experimental design.  These are model figures of the paper's
machine, not measurements of the card the port trains on.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.graph import CSRGraph
from repro_torch.core.sampler import SampleTrace
from repro_torch.storage.engines import StorageEngine, throughput
from repro_torch.storage.specs import DEFAULT, SystemSpec


def feature_gather_time(g: CSRGraph, trace: SampleTrace,
                        spec: SystemSpec = DEFAULT) -> float:
    """Feature-table lookup for the subgraph (step ② in Fig. 1) — random
    row reads from the DRAM-resident feature table.  (Engines that store
    features elsewhere override ``StorageEngine.feature_time``.)"""
    n = trace.subgraph_nodes.size
    nbytes = n * g.feat_dim * 4
    return n * spec.host.dram_latency + nbytes / spec.host.dram_bw


def gnn_step_flops(trace: SampleTrace, feat_dim: int, hidden: int = 256,
                   n_classes: int = 41) -> float:
    """Dense fixed-fanout GraphSAGE fwd+bwd FLOPs (x3 the forward)."""
    sizes = [h.size for h in trace.hops]          # M, M*f1, M*f1*f2, ...
    flops = 0.0
    dims = [feat_dim] + [hidden] * (len(sizes) - 1)
    for l in range(len(sizes) - 1):
        for t in range(len(sizes) - 1 - l):
            # aggregate hop t+1 -> t, two dense matmuls each
            flops += 2 * 2 * sizes[t] * dims[l] * hidden
    flops += 2 * sizes[0] * hidden * n_classes
    return 3.0 * flops


def gpu_step_time(trace: SampleTrace, feat_dim: int,
                  spec: SystemSpec = DEFAULT, **kw) -> float:
    return (spec.host.gpu_step_overhead
            + gnn_step_flops(trace, feat_dim, **kw) / spec.host.gpu_flops)


@dataclasses.dataclass
class E2EResult:
    engine: str
    workers: int
    producer_batch_s: float       # one worker's full data-prep latency
    producer_throughput: float    # batches/s with W workers
    gpu_step_s: float
    train_throughput: float       # batches/s end-to-end
    gpu_idle_frac: float
    components: dict


def e2e_train(engine: StorageEngine, trace: SampleTrace, *,
              workers: int = 12, spec: SystemSpec = DEFAULT,
              hidden: int = 256) -> E2EResult:
    g = engine.g
    cost = engine.batch_cost(trace)
    t_feat = engine.feature_time(trace)
    prep = cost.time_s + t_feat
    # Feature gather burns host CPU inside each worker: include it in the
    # serial term but not in shared storage resources.
    prod = min(workers / prep,
               throughput(cost, workers, spec) if cost.shared_demand
               else workers / prep)
    t_gpu = gpu_step_time(trace, g.feat_dim, spec, hidden=hidden)
    cons = 1.0 / t_gpu
    thpt = min(prod, cons)
    idle = max(0.0, 1.0 - prod / cons)
    comps = dict(cost.components)
    comps["feature_gather"] = t_feat
    comps["gnn_train"] = t_gpu
    return E2EResult(engine.name, workers, prep, prod, t_gpu, thpt, idle,
                     comps)


def capacity_report(spec: SystemSpec = DEFAULT) -> list[dict]:
    """Table I feasibility: which large-scale datasets exceed host DRAM
    (the paper's premise) but fit a 2 TB NVMe SSD."""
    from repro_torch.core.graph import TABLE1_LARGE_SCALE_GB
    rows = []
    for name, gb in TABLE1_LARGE_SCALE_GB.items():
        nbytes = gb << 30
        rows.append({
            "dataset": name, "large_scale_gb": gb,
            "fits_dram_192gb": nbytes <= spec.dram_capacity,
            "fits_pmem_768gb": nbytes <= spec.pmem.capacity,
            "fits_ssd_2tb": nbytes <= (2 << 40),
        })
    return rows
