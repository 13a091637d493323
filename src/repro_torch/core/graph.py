"""CSR graphs and the synthetic datasets, in numpy.

The port's own copy of the reference's ``core/graph.py`` (the port imports
nothing of ``repro``).  Every generator consumes the same numpy random
streams in the same order, so ``load_dataset`` returns arrays that are
byte-identical to the reference's at equal seeds.

Graphs are R-MAT power-law bases, grown for the large-scale variants by
Kronecker fractal expansion (node u becomes ``factor`` replicas; each base
edge expands toward ``factor**2 * edge_keep`` replica pairs), which keeps
the power-law degree distribution and densifies as the graph grows.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Compressed-sparse-row graph plus node features and labels.

    indptr:   (N+1,) int64 -- neighbour list offsets into ``indices``.
    indices:  (E,)   int32 -- the neighbour edge-list array.
    features: (N, F) float32 -- the feature table.
    labels:   (N,)   int32 -- node classification targets.
    """

    indptr: np.ndarray
    indices: np.ndarray
    features: np.ndarray | None = None
    labels: np.ndarray | None = None
    name: str = "graph"

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def feat_dim(self) -> int:
        return 0 if self.features is None else int(self.features.shape[1])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    # -- the GraphStore access methods (storage/store.py): CSRGraph is the
    # in-memory implementation, ``DiskStore`` serves the same calls from
    # the paged on-disk layout

    def out_degrees(self, nodes: np.ndarray) -> np.ndarray:
        nodes = np.asarray(nodes, np.int64)
        return (self.indptr[nodes + 1] - self.indptr[nodes]).astype(np.int64)

    def gather_edges(self, rows: np.ndarray, offsets: np.ndarray
                     ) -> np.ndarray:
        """Neighbour ids ``indices[indptr[rows] + offsets]`` with the
        degree-0 self-loop fallback: (R,) rows x (R, f) offsets -> (R, f)."""
        rows = np.asarray(rows, np.int64)
        off = np.asarray(offsets, np.int64)
        if self.num_edges == 0:
            return np.broadcast_to(rows[:, None].astype(np.int32),
                                   off.shape).copy()
        start = self.indptr[rows]
        deg = self.indptr[rows + 1] - start
        idx = start[:, None] + off
        picked = self.indices[np.minimum(idx, self.num_edges - 1)]
        return np.where(deg[:, None] > 0, picked,
                        rows[:, None]).astype(np.int32)

    def gather_features(self, ids: np.ndarray) -> np.ndarray:
        return self.features[np.asarray(ids)]

    def gather_edge_blocks(self, blocks: np.ndarray,
                           block_e: int) -> np.ndarray:
        """``block_e``-wide int32 chunks of the edge-list array, zero-padded
        past its end: (B,) block ids -> (B, block_e)."""
        return read_edge_blocks(lambda lo, hi: self.indices[lo:hi],
                                blocks, block_e, self.num_edges)

    def gather_labels(self, ids: np.ndarray) -> np.ndarray:
        return self.labels[np.asarray(ids)]

    def edge_list_nbytes(self, entry_bytes: int = 8) -> int:
        """Size of the neighbour edge-list array on storage (the paper's
        8 B an entry)."""
        return self.num_edges * entry_bytes

    def edge_byte_range(self, u: int, entry_bytes: int = 8) -> tuple[int, int]:
        """Byte extent of node u's neighbour list within the edge-list file."""
        return (int(self.indptr[u]) * entry_bytes,
                int(self.indptr[u + 1]) * entry_bytes)

    def validate(self) -> None:
        if not (self.indptr[0] == 0 and self.indptr[-1] == self.num_edges
                and np.all(np.diff(self.indptr) >= 0)):
            raise ValueError(f"{self.name}: malformed indptr")
        if self.num_edges and not (self.indices.min() >= 0 and
                                   self.indices.max() < self.num_nodes):
            raise ValueError(f"{self.name}: neighbour id out of range")
        for arr, what in ((self.features, "features"),
                          (self.labels, "labels")):
            if arr is not None and arr.shape[0] != self.num_nodes:
                raise ValueError(f"{self.name}: {what} has {arr.shape[0]} "
                                 f"rows for {self.num_nodes} nodes")


def read_edge_blocks(read, blocks: np.ndarray, block_e: int,
                     num_edges: int) -> np.ndarray:
    """``block_e``-wide int32 chunks of an edge array served by
    ``read(lo_entry, hi_entry)``, zero-padded past ``num_edges``: the one
    pad rule that ``CSRGraph`` and ``DiskStore`` both follow, so the
    edge-block cache holds the same bits whatever backs it."""
    blocks = np.asarray(blocks, np.int64).reshape(-1)
    out = np.zeros((blocks.size, block_e), np.int32)
    for j, b in enumerate(blocks):
        lo = int(b) * block_e
        hi = min(lo + block_e, num_edges)
        if hi > lo:
            out[j, :hi - lo] = read(lo, hi)
    return out


def _edge_keys(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Self-loop-free unique edge keys ``src * n + dst`` (sorted int64)."""
    keep = src != dst
    return np.unique(src[keep].astype(np.int64) * n + dst[keep])


def _csr_from_keys(keys: np.ndarray, n: int, *, features=None, labels=None,
                   name="graph") -> CSRGraph:
    """Build a CSRGraph from sorted unique edge keys (``src * n + dst``)."""
    src = (keys // n).astype(np.int64)
    dst = (keys % n).astype(np.int32)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    g = CSRGraph(indptr=indptr, indices=dst, features=features,
                 labels=labels, name=name)
    g.validate()
    return g


def edges_to_csr(src, dst, n: int, *, features=None, labels=None,
                 name="graph", symmetric: bool = True) -> CSRGraph:
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    keys = _edge_keys(np.asarray(src, np.int64), np.asarray(dst, np.int64), n)
    return _csr_from_keys(keys, n, features=features, labels=labels,
                          name=name)


def rmat_graph(n_nodes: int, n_edges: int, *, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               name: str = "rmat") -> CSRGraph:
    """R-MAT power-law generator (the standard Kronecker-style base graph)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(2, n_nodes))))
    probs = np.array([a, b, c, 1.0 - a - b - c])
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for level in range(scale):
        q = rng.choice(4, size=n_edges, p=probs)
        src += ((q >> 1) & 1).astype(np.int64) << level
        dst += (q & 1).astype(np.int64) << level
    return edges_to_csr(src % n_nodes, dst % n_nodes, n_nodes, name=name)


def kronecker_expand(g: CSRGraph, factor: int, *, seed: int = 0,
                     edge_keep: float = 1.0, name: str | None = None,
                     chunk_pairs: int = 4) -> CSRGraph:
    """Kronecker fractal expansion G' = G (x) K_factor.

    Nodes grow x ``factor``, edges x ``factor**2 * edge_keep``.  Replica
    pairs are drawn pair by pair in a fixed order and reduced to unique
    keys ``chunk_pairs`` at a time, so the result is the same for every
    ``chunk_pairs`` while the peak memory stays near the unique edges."""
    rng = np.random.default_rng(seed)
    n2 = g.num_nodes * factor
    base_src = np.repeat(np.arange(g.num_nodes, dtype=np.int64), g.degrees())
    base_dst = g.indices.astype(np.int64)
    n_pairs = max(1, int(factor * factor * edge_keep))
    chunk_pairs = max(1, int(chunk_pairs))
    keys: np.ndarray | None = None
    pending: list[tuple[np.ndarray, np.ndarray]] = []
    for p in range(n_pairs):
        r1 = rng.integers(0, factor, size=base_src.shape[0])
        r2 = rng.integers(0, factor, size=base_src.shape[0])
        pending.append((base_src * factor + r1, base_dst * factor + r2))
        if len(pending) >= chunk_pairs or p == n_pairs - 1:
            chunk = _edge_keys(np.concatenate([s for s, _ in pending]),
                               np.concatenate([d for _, d in pending]), n2)
            keys = chunk if keys is None else np.union1d(keys, chunk)
            pending = []
    return _csr_from_keys(keys, n2, name=name or (g.name + f"-kron{factor}"))


def attach_features(g: CSRGraph, feat_dim: int, n_classes: int = 41,
                    *, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    g.features = rng.standard_normal((g.num_nodes, feat_dim),
                                     dtype=np.float32)
    g.labels = rng.integers(0, n_classes, g.num_nodes, dtype=np.int32)
    return g


# Per dataset: (base nodes, base edges, feature dim, Kronecker factor,
# edge_keep).  The in-memory variant is the R-MAT base; the large-scale
# variant is its fractal expansion (more nodes AND a higher average degree,
# the relationship of the paper's Table I), at a size one host can build.
DATASETS = {
    #                nodes, edges, feat, kron, keep
    "reddit":      (1 << 10, 1 << 14, 602, 8, 0.40),
    "movielens":   (1 << 11, 1 << 15, 256, 4, 0.60),
    "amazon":      (1 << 12, 1 << 15, 32, 8, 0.30),
    "ogbn-100m":   (1 << 12, 1 << 15, 32, 4, 0.50),
    "protein-pi":  (1 << 10, 1 << 14, 512, 4, 0.55),
}

# The paper's Table I sizes (GB of graph data) of the large-scale datasets:
# the storage simulator's capacity check at true scale.
TABLE1_LARGE_SCALE_GB = {
    "reddit": 402, "movielens": 442, "amazon": 75, "ogbn-100m": 41,
    "protein-pi": 66,
}


def load_dataset(name: str, *, large_scale: bool = False,
                 seed: int = 0) -> CSRGraph:
    nodes, edges, feat, kron, keep = DATASETS[name]
    g = rmat_graph(nodes, edges, seed=seed, name=f"{name}-inmem")
    if large_scale:
        g = kronecker_expand(g, kron, seed=seed + 1, edge_keep=keep,
                             name=f"{name}-large")
    return attach_features(g, feat, seed=seed + 2)
