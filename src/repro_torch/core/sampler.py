"""Host neighbour sampling, the per-batch storage-access record, and the
replay hooks of the Belady oracle.

The port's copy of the reference's ``core/sampler.py`` without its JAX
samplers (the port samples on the device with the ``neighbor_sample``
kernels, ``kernels.ops``):

* the numpy host samplers ``sample_khop`` (GraphSAGE's Algorithm 1) and
  ``saint_random_walk`` (GraphSAINT), drawing from
  ``np.random.default_rng(seed)`` through the GraphStore access protocol
  (``out_degrees``/``gather_edges``: a ``CSRGraph`` or a ``DiskStore``'s
  paged reads), so their ids equal the reference's bit for bit; each
  returns a ``SampleTrace`` whose ``io`` holds the batch's measured
  store counters;
* the replay hooks (``replay_khop``, ``replay_one_hop_ids``,
  ``replay_khop_jax_ids``) that replay a future batch's id stream without
  touching the live store's cache, for ``storage.oracle``.  The kernel
  sampler's stream is replayed with the port's threefry
  (``repro_torch.rng``), bit-equal to ``jax.random``'s, on the CPU.

The module imports numpy only (the threefry, which runs on torch
tensors, is imported where the replay needs it), so the storage process
of the ISP service (``repro_torch.isp.server``) samples without torch.

Sampling is uniform with replacement among each node's neighbours; a
node without neighbours samples itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_FANOUTS = (25, 10)   # paper default: 25 then 10 per layer


@dataclasses.dataclass
class SampleTrace:
    """Storage-access record of one minibatch's subgraph generation.

    ``touched_nodes``: every node whose neighbour list was read, in
    request order.  ``hops``: per-hop dense node-id arrays.
    ``subgraph_nodes``: unique node ids whose features were gathered.
    ``io``: the measured block-I/O and cache counters of the batch.
    """

    touched_nodes: np.ndarray
    hops: list[np.ndarray]
    subgraph_nodes: np.ndarray
    io: dict | None = None

    def sampled_ids_nbytes(self, entry_bytes: int = 8) -> int:
        return sum(h.size for h in self.hops) * entry_bytes


def _io_fn(store):
    """The store's I/O-counter view, preferring the thread-scoped one."""
    return getattr(store, "thread_io_counters",
                   getattr(store, "io_counters", None))


def _io_snapshot(store) -> dict | None:
    counters = _io_fn(store)
    return counters() if counters is not None else None


def _io_delta(store, before: dict | None) -> dict | None:
    if before is None:
        return None
    after = _io_fn(store)()
    return {k: after[k] - before.get(k, 0) for k in after}


def _sample_one_hop(store, frontier: np.ndarray, fanout: int,
                    rng: np.random.Generator) -> np.ndarray:
    """frontier: (...,) -> (..., fanout) sampled neighbour ids, with
    replacement, through any GraphStore; the draw is the same in memory
    and on disk, so both sample the same ids at equal seeds."""
    flat = frontier.reshape(-1)
    deg = store.out_degrees(flat)
    r = rng.integers(0, np.maximum(deg, 1)[:, None],
                     size=(flat.size, fanout))
    picked = store.gather_edges(flat, r)        # deg 0 samples itself
    return picked.reshape(frontier.shape + (fanout,)).astype(np.int32)


def sample_khop(store, targets: np.ndarray, fanouts=DEFAULT_FANOUTS, *,
                seed: int = 0) -> SampleTrace:
    """GraphSAGE's Algorithm 1, k hops over any GraphStore: hops[0] =
    targets (M,), hops[1] (M, f1), hops[2] (M, f1, f2), ...  Every
    expanded frontier node's neighbour list is one store request; over a
    ``DiskStore`` the trace's ``io`` holds the block I/O they issued."""
    rng = np.random.default_rng(seed)
    targets = np.asarray(targets, np.int32)
    io0 = _io_snapshot(store)
    hops = [targets]
    touched = [targets.reshape(-1)]
    frontier = targets
    for i, f in enumerate(fanouts):
        nxt = _sample_one_hop(store, frontier, f, rng)
        hops.append(nxt)
        frontier = nxt
        # every hop but the last is expanded again (by position: repeated
        # fanouts like (10, 10) must not drop records)
        if i != len(fanouts) - 1:
            touched.append(nxt.reshape(-1))
    touched_nodes = np.concatenate(touched)
    subgraph = np.unique(np.concatenate([h.reshape(-1) for h in hops]))
    return SampleTrace(touched_nodes=touched_nodes, hops=hops,
                       subgraph_nodes=subgraph, io=_io_delta(store, io0))


def saint_random_walk(store, roots: np.ndarray, walk_length: int = 4, *,
                      seed: int = 0) -> SampleTrace:
    """GraphSAINT's random-walk sampler: a walk of ``walk_length`` steps
    from each root; the visited nodes are the training subgraph, and the
    one hop tensor is the (M, L+1) walk."""
    rng = np.random.default_rng(seed)
    roots = np.asarray(roots, np.int32)
    io0 = _io_snapshot(store)
    cur = roots.copy()
    visited = [roots]
    touched = []
    for _ in range(walk_length):
        touched.append(cur.reshape(-1))
        cur = _sample_one_hop(store, cur, 1, rng)[..., 0]
        visited.append(cur)
    walk = np.stack(visited, axis=1)                       # (M, L+1)
    subgraph = np.unique(walk.reshape(-1))
    return SampleTrace(touched_nodes=np.concatenate(touched),
                       hops=[roots, walk], subgraph_nodes=subgraph,
                       io=_io_delta(store, io0))


# ---------------------------------------------------------------------------
# replay hooks (storage/oracle.py): a future batch's id stream, replayed
# through raw positional reads that leave the live cache alone
# ---------------------------------------------------------------------------

def replay_khop(reader, targets: np.ndarray, fanouts=DEFAULT_FANOUTS, *,
                seed: int = 0) -> SampleTrace:
    """Replay the host sampler's id stream for one batch over ``reader``
    (the GraphStore access protocol over raw reads, e.g.
    ``storage.oracle.RawDiskReader``): the live ``sample_khop``'s ids at
    equal seeds, with no billed store traffic (``io`` is None)."""
    return sample_khop(reader, targets, fanouts, seed=seed)


def replay_one_hop_ids(indptr: np.ndarray, read_indices, frontier: np.ndarray,
                       rand: np.ndarray) -> np.ndarray:
    """numpy mirror of one hop of the ``neighbor_sample`` kernels:
    ``rand`` is the hop's raw ``randint(..., 0, 2**31 - 1)`` draw shaped
    ``(flat, fanout)``, neighbour values come from ``read_indices(pos)``
    (raw positional reads of the edge array), deg-0 rows sample
    themselves."""
    flat = frontier.reshape(-1)
    start = indptr[flat].astype(np.int64)
    deg = indptr[flat + 1].astype(np.int64) - start
    fanout = rand.shape[1]
    r = rand.astype(np.int64) % np.maximum(deg, 1)[:, None]
    picked = np.broadcast_to(flat[:, None], (flat.size, fanout)
                             ).astype(np.int32).copy()
    live = deg > 0
    if live.any():
        pos = start[live, None] + r[live]
        vals = np.asarray(read_indices(pos.reshape(-1)), np.int32)
        picked[live] = vals.reshape(pos.shape)
    return picked.reshape(frontier.shape + (fanout,))


def replay_khop_jax_ids(indptr: np.ndarray, read_indices, targets, fanouts,
                        *, key, rand_shape_fn=None) -> list[np.ndarray]:
    """Replay the kernel sampler's per-hop id arrays on the host.  ``key``
    is the batch key (``rng.fold_in(rng.key(seed), batch)``); hop i draws
    ``rng.randint(rng.fold_in(key, i), shape, 0, 2**31 - 1)`` on the CPU,
    as ``kernels.ops.sample_khop_kernel`` does on the device, so the ids
    equal the live path's.  ``rand_shape_fn(frontier, fanout)`` overrides
    the draw's shape (the bits do not depend on it)."""
    from repro_torch import rng as _rng
    hops = [np.asarray(targets, np.int32)]
    frontier = hops[0]
    for i, f in enumerate(fanouts):
        shape = ((frontier.reshape(-1).shape[0], f) if rand_shape_fn is None
                 else rand_shape_fn(frontier, f))
        rand = _rng.randint(_rng.fold_in(key, i), shape, 0, 2**31 - 1,
                            device="cpu").numpy()
        frontier = replay_one_hop_ids(indptr, read_indices, frontier,
                                      rand.reshape(-1, f))
        hops.append(frontier)
    return hops
