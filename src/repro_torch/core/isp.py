"""Near-data subgraph generation on the mesh: the ISP architecture's
mesh backend, in PyTorch.

The port of the reference's ``core/isp.py``.  The paper's insight:
neighbour sampling is a high-selectivity reduction over a huge cold
structure, so run it where the data lives and ship only the dense result.
The partitioned graph (``core.partition``) lives sharded over the mesh's
``data`` axis (``launch.mesh``): each shard samples and gathers the
targets it owns from its local slices, contributes zeros for the others,
and the shard results are summed into one output in shard order (the
reference's ``psum`` inside ``shard_map``).  Each node has one owner, so
the sum assembles the full subgraph; integer results are exact, and a
float is its owner's value except that a ``-0.0`` becomes ``+0.0`` past
one shard, as in the reference's sum.

The mesh is single-controller, as the reference's is: one process drives
every shard, shard by shard, each on its own device (shards that share a
card run one after another).  The sampling bits are drawn once a hop on
the output device with the reference's threefry stream
(``rng.randint(fold_in(key, hop), ...)``), so the ids equal those of the
``pallas`` backend's kernels at equal keys.  No hand-written kernel runs
here, as no Pallas kernel runs in the reference's mesh path: the shard
bodies are plain torch ops (takes, masks, clamps).

``fetch_edge_chunks`` is the anti-pattern the paper measures against:
each target's whole padded neighbour list crosses the mesh instead of
``fanout`` sampled ids.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import rng
from repro_torch.core.loader import Minibatch, build_train_step
from repro_torch.core.partition import PartitionedGraph
from repro_torch.core.sampler import DEFAULT_FANOUTS


class ISPGraph:
    """A partitioned graph resident on the mesh: shard ``s``'s ``indptr``,
    ``indices``, ``features``, ``labels`` and node offset are tensors on
    ``mesh.devices[s]``; results land on ``device``, the first shard's."""

    def __init__(self, pg: PartitionedGraph, mesh, *, axis: str = "data"):
        if pg.n_shards != mesh.shape[axis]:
            raise ValueError(f"{pg.n_shards} partitions for a mesh of "
                             f"{mesh.shape}")
        self.mesh = mesh
        self.axis = axis
        self.n_max = pg.n_max
        self.e_max = pg.indices.shape[1]
        self.devices = tuple(mesh.devices)
        self.device = self.devices[0]

        def put(a, s):
            return None if a is None else torch.as_tensor(
                a[s], device=self.devices[s])

        shards = range(pg.n_shards)
        self.indptr = [put(pg.indptr, s) for s in shards]
        self.indices = [put(pg.indices, s) for s in shards]
        self.node_offset = [put(pg.node_offset.astype("int32"), s)
                            for s in shards]
        self.features = [put(pg.features, s) for s in shards]
        self.labels = [put(pg.labels, s) for s in shards]

    # -- shard-local bodies ---------------------------------------------------

    def _own(self, s: int, ids):
        """Which of ``ids`` shard ``s`` owns, and their clamped local rows."""
        local = ids - self.node_offset[s]
        owned = (local >= 0) & (local < self.n_max)
        return owned, local.clamp(0, self.n_max - 1).long()

    def _local_sample(self, s: int, frontier, rand):
        """One hop on shard ``s``; non-owned targets give 0."""
        owned, li = self._own(s, frontier)
        indptr = self.indptr[s]
        start = indptr[li]
        deg = indptr[li + 1] - start
        r = torch.remainder(rand, deg.clamp_min(1)[..., None])
        idx = (start[..., None] + r).clamp(0, self.e_max - 1).long()
        pick = torch.where(deg[..., None] > 0, self.indices[s][idx],
                           frontier[..., None])          # self-loop fallback
        return pick.masked_fill_(~owned[..., None], 0)

    def _local_gather(self, s: int, ids):
        owned, li = self._own(s, ids)
        return self.features[s][li].masked_fill_(~owned[..., None], 0.0)

    def _local_labels(self, s: int, ids):
        owned, li = self._own(s, ids)
        return self.labels[s][li].masked_fill_(~owned, 0)

    def _psum(self, body, *args):
        """Run ``body(s, *args)`` on each shard's device and sum the
        results into one buffer on ``device``, in shard order.  One
        shard's result is the output itself (a sum over one shard is the
        identity); at most two full results are live at once."""
        out = None
        for s, dev in enumerate(self.devices):
            part = body(s, *(a.to(dev) for a in args)).to(self.device)
            if out is None:
                out = part
            else:
                out.add_(part)
        return out

    # -- mesh-level ops -------------------------------------------------------

    def sample_one_hop(self, frontier, fanout: int, key):
        """frontier: (...,) int32 -> (..., fanout) int32."""
        rand = rng.randint(key, tuple(frontier.shape) + (fanout,), 0,
                           2**31 - 1, device=self.device)
        return self._psum(self._local_sample, frontier, rand)

    def sample_khop(self, targets, fanouts: Sequence[int] = DEFAULT_FANOUTS,
                    *, key):
        """Hop ``i`` draws its bits under ``fold_in(key, i)``; returns
        [(M,), (M, f1), (M, f1, f2), ...] int32 on ``device``."""
        hops = [torch.as_tensor(targets, dtype=torch.int32,
                                device=self.device)]
        frontier = hops[0]
        for i, f in enumerate(fanouts):
            frontier = self.sample_one_hop(frontier, f, rng.fold_in(key, i))
            hops.append(frontier)
        return hops

    def gather_features(self, ids):
        """ids: (...,) int32 -> (..., F) float32, gathered where the rows
        live."""
        return self._psum(self._local_gather, ids)

    def gather_labels(self, ids):
        return self._psum(self._local_labels, ids)

    def sample_and_gather(self, targets, fanouts=DEFAULT_FANOUTS, *, key):
        """Subgraph ids, then each hop's features and the targets' labels:
        ``(hop_feats, labels)``, the minibatch GraphSAGE consumes."""
        hops = self.sample_khop(targets, fanouts, key=key)
        return ([self.gather_features(h) for h in hops],
                self.gather_labels(hops[0]))

    # -- the baseline's data movement (the paper's SSD(mmap) fetch) ----------

    def fetch_edge_chunks(self, targets, max_degree: int):
        """Each target's whole neighbour list, zero-padded to
        ``max_degree``: the coarse block fetch of Fig. 10(a), whose bytes
        against ``sample_one_hop``'s are the paper's transfer
        amplification."""
        k = torch.arange(max_degree, device=self.device)

        def local(s, targets, k):
            owned, li = self._own(s, targets)
            indptr = self.indptr[s]
            start = indptr[li]
            deg = indptr[li + 1] - start
            idx = (start[:, None] + k[None, :]).clamp(0, self.e_max - 1)
            rows = self.indices[s][idx]
            valid = (k[None, :] < deg[:, None]) & owned[:, None]
            return rows.masked_fill_(~valid, 0)

        return self._psum(local, torch.as_tensor(
            targets, dtype=torch.int32, device=self.device), k)


def build_fused_train_step(prepare_fn, gnn, optimizer):
    """Data preparation and the GraphSAGE update in one call:
    ``step(state, targets, key) -> (state, metrics)``, with
    ``prepare_fn(targets, key) -> (hop_feats, labels)`` and ``key`` an
    ``rng`` key pair.  The update is ``core.loader.build_train_step``'s
    (parameters in ``gnn``, updated in place; ``state`` the optimizer
    state and the step count).  The reference fuses both into one jit
    region; here they are plain calls."""
    train_step = build_train_step(None, gnn, optimizer)

    def step(state, targets, key):
        hop_feats, labels = prepare_fn(targets, key)
        return train_step(state, Minibatch(targets=targets, hop_ids=[],
                                           hop_feats=hop_feats,
                                           labels=labels))

    return step


def build_isp_train_step(engine: ISPGraph, gnn, optimizer,
                         fanouts=DEFAULT_FANOUTS):
    """The near-data step: ``sample_and_gather`` and the update."""
    return build_fused_train_step(
        lambda targets, key: engine.sample_and_gather(targets, fanouts,
                                                      key=key),
        gnn, optimizer)
