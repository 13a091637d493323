"""Graph partitioning for near-data (ISP-analogue) sampling on the mesh.

The port's copy of the reference's ``core/partition.py`` (numpy only).
The CSR graph is split into contiguous node ranges, one per shard of the
mesh's ``data`` axis (the analogue of "the data lives in the SSD" is "the
data lives sharded across the mesh").  Every shard gets:

  * its local indptr slice, rebased to local edge offsets,
  * its local neighbor edge-list slice, padded to the max shard size so the
    stacked (n_shards, ...) arrays are rectangular,
  * its local feature-table rows (same padding on the node dim).

``core.isp.ISPGraph`` then keeps each shard's slices on that shard's
device, samples and gathers where the shard lives, and sums the dense
results over the shards (the psum).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import CSRGraph


@dataclasses.dataclass
class PartitionedGraph:
    """Rectangular per-shard CSR + features (numpy, ready to upload).

    indptr:  (S, n_max+1) int32 — local offsets; entries past n_local clamp.
    indices: (S, e_max)   int32 — local edge lists, zero-padded.
    features:(S, n_max, F) float32 — local feature rows, zero-padded.
    labels:  (S, n_max)   int32
    node_offset: (S,) int64 — first global node id of each shard.
    n_local: (S,) int32 — real (unpadded) node count per shard.
    """

    indptr: np.ndarray
    indices: np.ndarray
    features: np.ndarray | None
    labels: np.ndarray | None
    node_offset: np.ndarray
    n_local: np.ndarray

    @property
    def n_shards(self) -> int:
        return self.indptr.shape[0]

    @property
    def n_max(self) -> int:
        return self.indptr.shape[1] - 1

    def edge_imbalance(self) -> float:
        """max/mean shard edge count — the paper's Fig. 17 contention analogue."""
        counts = self.indptr[:, -1].astype(np.float64)
        return float(counts.max() / max(counts.mean(), 1.0))


def partition_graph(g: CSRGraph, n_shards: int) -> PartitionedGraph:
    n = g.num_nodes
    n_max = -(-n // n_shards)                     # ceil
    bounds = [min(i * n_max, n) for i in range(n_shards + 1)]

    indptrs, idx_list, feats, labs, offs, n_locals = [], [], [], [], [], []
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        n_local = hi - lo
        local_ptr = (g.indptr[lo:hi + 1] - g.indptr[lo]).astype(np.int64)
        # pad node dim: repeat last offset so padded nodes have degree 0
        pad = n_max - n_local
        local_ptr = np.concatenate(
            [local_ptr, np.full(pad, local_ptr[-1], np.int64)])
        indptrs.append(local_ptr)
        idx_list.append(g.indices[g.indptr[lo]:g.indptr[hi]])
        if g.features is not None:
            f = g.features[lo:hi]
            feats.append(np.pad(f, ((0, pad), (0, 0))))
        if g.labels is not None:
            labs.append(np.pad(g.labels[lo:hi], (0, pad)))
        offs.append(lo)
        n_locals.append(n_local)

    e_max = max(x.shape[0] for x in idx_list)
    # rounded up to 128 entries, as the reference lays its shards out
    e_max = -(-e_max // 128) * 128 if e_max else 128
    indices = np.zeros((n_shards, e_max), np.int32)
    for s, x in enumerate(idx_list):
        indices[s, :x.shape[0]] = x

    return PartitionedGraph(
        indptr=np.stack(indptrs).astype(np.int32),
        indices=indices,
        features=np.stack(feats) if feats else None,
        labels=np.stack(labs) if labs else None,
        node_offset=np.asarray(offs, np.int64),
        n_local=np.asarray(n_locals, np.int32),
    )
