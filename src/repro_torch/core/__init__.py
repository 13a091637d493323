"""SmartSAGE core in PyTorch: graphs, the GraphSAGE model, the
declarative data-plane spec (``config``), the kernel data plane (in memory
or out of core through device caches), the host backend's numpy samplers
and producer pipeline, the mesh ISP backend (``partition``, ``isp``), the
prefetching and overlapped pipelines and the training loop (the
``pallas``, ``host`` and ``isp`` paths of the reference's ``repro.core``).

The names below are re-exported lazily (PEP 562): importing the
package imports no submodule, so a process that needs only the numpy
parts (the ISP service's storage process: ``sampler``, ``graph``)
never imports torch.
"""

import importlib

_EXPORTS = {
    "BackendSpec": "config", "CacheTierSpec": "config", "IspSpec": "config",
    "ObsSpec": "config", "Pipeline": "config", "PipelineSpec": "config",
    "PrefetchSpec": "config", "SamplerSpec": "config", "StoreSpec": "config",
    "add_pipeline_args": "config", "build_pipeline": "config",
    "fill_pipeline_flag_defaults": "config",
    "spec_from_args": "config",
    "GNNConfig": "gnn", "GraphSAGE": "gnn", "build_defs": "gnn",
    "gnn_loss_fn": "gnn",
    "CSRGraph": "graph", "DATASETS": "graph", "attach_features": "graph",
    "edges_to_csr": "graph", "kronecker_expand": "graph",
    "load_dataset": "graph", "read_edge_blocks": "graph",
    "rmat_graph": "graph",
    "ISPGraph": "isp", "build_fused_train_step": "isp",
    "build_isp_train_step": "isp",
    "HostSubgraphLoader": "loader", "ISPSubgraphLoader": "loader", "LOADERS": "loader", "Minibatch": "loader",
    "PallasSubgraphLoader": "loader", "RunStats": "loader",
    "batch_targets": "loader", "build_train_step": "loader",
    "make_loader": "loader", "register_loader": "loader",
    "train_loop": "loader",
    "OverlappedLoader": "pipeline", "PipelineStats": "pipeline",
    "PrefetchingLoader": "pipeline", "ProducerConsumerPipeline": "pipeline",
    "make_host_producer": "pipeline",
    "PartitionedGraph": "partition", "partition_graph": "partition",
    "DEFAULT_FANOUTS": "sampler", "SampleTrace": "sampler",
    "saint_random_walk": "sampler", "sample_khop": "sampler",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"repro_torch.core.{mod}"), name)
