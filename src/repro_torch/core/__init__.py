"""SmartSAGE core in PyTorch: graphs, the GraphSAGE model, the kernel
data plane (in memory or out of core through device caches) and the
training loop (the ``pallas`` path of the reference's ``repro.core``)."""

from repro_torch.core.gnn import GNNConfig, GraphSAGE, build_defs, gnn_loss_fn
from repro_torch.core.graph import (CSRGraph, DATASETS, attach_features,
                                    edges_to_csr, kronecker_expand,
                                    load_dataset, read_edge_blocks,
                                    rmat_graph)
from repro_torch.core.loader import (LOADERS, DeviceTierSpec, Minibatch,
                                     PallasSubgraphLoader, RunStats,
                                     batch_targets, build_train_step,
                                     register_loader, train_loop)
from repro_torch.core.sampler import SampleTrace

__all__ = ["CSRGraph", "DATASETS", "DeviceTierSpec", "GNNConfig",
           "GraphSAGE", "LOADERS", "Minibatch", "PallasSubgraphLoader",
           "RunStats", "SampleTrace", "attach_features", "batch_targets",
           "build_defs", "build_train_step", "edges_to_csr", "gnn_loss_fn",
           "kronecker_expand", "load_dataset", "read_edge_blocks",
           "register_loader", "rmat_graph", "train_loop"]
