"""SmartSAGE core in PyTorch: graphs, the GraphSAGE model, the kernel
data plane and the training loop (the main path of the reference's
``repro.core``)."""

from repro_torch.core.gnn import GNNConfig, GraphSAGE, build_defs, gnn_loss_fn
from repro_torch.core.graph import (CSRGraph, DATASETS, attach_features,
                                    edges_to_csr, kronecker_expand,
                                    load_dataset, rmat_graph)
from repro_torch.core.loader import (LOADERS, Minibatch,
                                     PallasSubgraphLoader, RunStats,
                                     batch_targets, build_train_step,
                                     register_loader, train_loop)

__all__ = ["CSRGraph", "DATASETS", "GNNConfig", "GraphSAGE", "LOADERS",
           "Minibatch", "PallasSubgraphLoader", "RunStats", "attach_features",
           "batch_targets", "build_defs", "build_train_step", "edges_to_csr",
           "gnn_loss_fn", "kronecker_expand", "load_dataset",
           "register_loader", "rmat_graph", "train_loop"]
