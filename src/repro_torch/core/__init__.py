"""SmartSAGE core in PyTorch: graphs, the GraphSAGE model, the
declarative data-plane spec (``config``), the kernel data plane (in memory
or out of core through device caches), the host backend's numpy samplers
and producer pipeline, the prefetching and overlapped pipelines and the
training loop (the ``pallas`` and ``host`` paths of the reference's
``repro.core``)."""

from repro_torch.core.config import (BackendSpec, CacheTierSpec, IspSpec,
                                     ObsSpec, Pipeline, PipelineSpec,
                                     PrefetchSpec, SamplerSpec, StoreSpec,
                                     add_pipeline_args, build_pipeline,
                                     check_ported,
                                     fill_pipeline_flag_defaults,
                                     spec_from_args)
from repro_torch.core.gnn import GNNConfig, GraphSAGE, build_defs, gnn_loss_fn
from repro_torch.core.graph import (CSRGraph, DATASETS, attach_features,
                                    edges_to_csr, kronecker_expand,
                                    load_dataset, read_edge_blocks,
                                    rmat_graph)
from repro_torch.core.loader import (LOADERS, HostSubgraphLoader,
                                     Minibatch, PallasSubgraphLoader,
                                     RunStats, batch_targets,
                                     build_train_step, make_loader,
                                     register_loader, train_loop)
from repro_torch.core.pipeline import (OverlappedLoader, PipelineStats,
                                       PrefetchingLoader,
                                       ProducerConsumerPipeline,
                                       make_host_producer)
from repro_torch.core.sampler import (DEFAULT_FANOUTS, SampleTrace,
                                      sample_khop, saint_random_walk)

__all__ = ["BackendSpec", "CSRGraph", "CacheTierSpec", "DATASETS",
           "DEFAULT_FANOUTS", "GNNConfig", "GraphSAGE", "HostSubgraphLoader",
           "IspSpec", "LOADERS", "Minibatch", "ObsSpec", "OverlappedLoader",
           "PallasSubgraphLoader", "Pipeline", "PipelineSpec",
           "PipelineStats", "PrefetchSpec", "PrefetchingLoader",
           "ProducerConsumerPipeline", "RunStats", "SampleTrace",
           "SamplerSpec", "StoreSpec", "add_pipeline_args",
           "attach_features", "batch_targets", "build_defs",
           "build_pipeline", "build_train_step", "check_ported",
           "edges_to_csr", "fill_pipeline_flag_defaults", "gnn_loss_fn",
           "kronecker_expand", "load_dataset", "make_host_producer",
           "make_loader", "read_edge_blocks", "register_loader",
           "rmat_graph", "saint_random_walk", "sample_khop",
           "spec_from_args", "train_loop"]
