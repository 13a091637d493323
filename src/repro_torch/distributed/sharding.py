"""Logical-axis sharding: where "what a dimension means" is mapped to
"which mesh axis shards it".

The port of the reference's ``repro/distributed/sharding.py`` onto
``torch.distributed``.  Every parameter is annotated with logical axis
names (``ParamDef.logical_axes``, e.g. ``("vocab", "embed")``); a
``ShardingRules`` table maps each name to a mesh axis name, a tuple of
them, or None (replicated).  ``logical_to_spec`` resolves a leaf's names
on a mesh as the reference does: an axis absent from the mesh drops, a
mapping whose mesh size does not divide the dim falls back to
replication, a mesh axis is used once (first use wins), and trailing
Nones are trimmed.  It returns the tuple the reference's
``PartitionSpec`` holds.  ``placements`` turns such a spec into DTensor
placements (``Shard(dim)`` or ``Replicate()``, one per mesh dim), which
is how the port holds a leaf on a ``DeviceMesh``; ``tree_placements`` is
the reference's ``tree_shardings``.  ``constrain`` redistributes a
DTensor to a spec and leaves a plain tensor as it is.

The reference's ``distributed/compat.py`` has no counterpart: it bridges
JAX versions (``shard_map``, ``make_mesh``), and the port has no such
split.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

# The reference's rules, unchanged (its comments name each axis):
#   batch      global batch; data parallel over ("pod", "data")
#   embed      weight d_model dims, fsdp-sharded over "data" (ZeRO)
#   heads, kv_heads, mlp, vocab, experts, ssm_head: the "model" axis
#   kv_seq     the KV cache's sequence dim (sharded over "model" in decode)
DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", ("pod", "data")),
    ("fsdp", "data"),
    ("embed", "data"),
    ("act_embed", None),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("qkv", None),
    ("mlp", "model"),
    ("vocab", "model"),
    ("experts", "model"),
    ("expert_mlp", None),
    ("moe_group", ("pod", "data")),
    ("seq", None),
    ("kv_seq", "model"),
    ("kv_batch", ("pod", "data")),
    ("layers", None),
    ("conv", None),
    ("state", None),
    ("ssm_head", "model"),
    ("graph", "data"),
    ("nodes", None),
    ("feat", None),
    ("gnn_in", None),
    ("gnn_hidden", "model"),
    ("enc_seq", None),
)
DEFAULT_BATCH_AXES = dict(DEFAULT_RULES)["batch"]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axis name(s) or None."""

    rules: Mapping[str, Any]

    @classmethod
    def default(cls, overrides: Mapping[str, Any] | None = None
                ) -> "ShardingRules":
        table = dict(DEFAULT_RULES)
        if overrides:
            table.update(overrides)
        return cls(rules=table)

    def mesh_axes(self, logical: str | None) -> Any:
        if logical is None:
            return None
        if logical not in self.rules:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.rules[logical]


def mesh_sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` (its ``mesh_dim_names``), of
    the GNN's ``launch.mesh.Mesh`` or of a plain dict."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(sizes: dict, mesh_axes: Any) -> int:
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        return sizes.get(mesh_axes, 1)
    n = 1
    for a in mesh_axes:
        n *= sizes.get(a, 1)
    return n


def _present(sizes: dict, mesh_axes: Any) -> Any:
    """Drop mesh axes that this mesh lacks (e.g. "pod" on one pod)."""
    if mesh_axes is None:
        return None
    if isinstance(mesh_axes, str):
        return mesh_axes if mesh_axes in sizes else None
    kept = tuple(a for a in mesh_axes if a in sizes)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def logical_to_spec(logical_axes: Sequence[str | None], rules: ShardingRules,
                    mesh, dim_sizes: Sequence[int] | None = None) -> tuple:
    """Resolve logical axes to a spec tuple (one entry a dim: a mesh axis
    name, a tuple of them, or None; trailing Nones trimmed), respecting
    divisibility when ``dim_sizes`` is given and using each mesh axis
    once (first use wins)."""
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    out = []
    for i, name in enumerate(logical_axes):
        mesh_axes = _present(sizes, rules.mesh_axes(name)) if name else None
        if mesh_axes is not None:
            axes = (mesh_axes,) if isinstance(mesh_axes, str) \
                else tuple(mesh_axes)
            if any(a in used for a in axes):
                mesh_axes = None
            elif dim_sizes is not None \
                    and dim_sizes[i] % _axis_size(sizes, mesh_axes) != 0:
                mesh_axes = None
            if mesh_axes is not None:
                used.update(axes)
        out.append(mesh_axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``, one
    per mesh dim in its order: ``Shard(i)`` where dim ``i`` of the tensor
    names that mesh axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [i for i, s in enumerate(spec)
                if s == axis or (isinstance(s, tuple) and axis in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def tree_placements(defs, rules: ShardingRules, mesh):
    """The placements on ``mesh`` of every leaf of a ``ParamDef`` tree
    under ``rules`` (the reference's ``tree_shardings``), same
    structure."""
    if isinstance(defs, dict):
        return {k: tree_placements(v, rules, mesh) for k, v in defs.items()}
    return placements(logical_to_spec(defs.logical_axes, rules, mesh,
                                      defs.shape), mesh)


def _mesh_groups(mesh) -> dict:
    """The process groups made for ``mesh``, kept on the mesh itself: a
    cache keyed by the mesh would hand a new mesh the groups of an equal
    one (``DeviceMesh`` compares by layout) and drop them when that one is
    collected, perhaps inside a fake mode that cannot remake them."""
    groups = getattr(mesh, "_repro_groups", None)
    if groups is None:
        groups = mesh._repro_groups = {}
    return groups


def batch_axes(mesh) -> tuple[str, ...]:
    """The axes of ``mesh`` that the rules' ``batch`` maps to: ("pod",
    "data"), those the mesh has."""
    return tuple(a for a in DEFAULT_BATCH_AXES if a in mesh.mesh_dim_names)


def batch_group(mesh):
    """The data-parallel process group of the ``DeviceMesh`` ``mesh``: the
    ranks that hold the same ``model`` shard and split the batch, over
    ``batch_axes``.  One axis: its group; "pod" and "data": their product,
    flattened (``DeviceMesh._flatten``) at the first call for that mesh and
    kept (the production mesh makes it at once, before any step is traced
    on fake tensors)."""
    axes = batch_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = _mesh_groups(mesh)
    if "batch" not in groups:
        groups["batch"] = mesh[axes]._flatten("batch").get_group()
    return groups["batch"]


def microbatch_group(mesh, share: int):
    """The process group of the ``share`` data-parallel ranks that hold
    one microbatch with this rank (``data.tokens.microbatch_layout``):
    ranks ``s * share`` to ``(s + 1) * share - 1`` in the order of
    ``batch_group``, ``s`` this rank's.  The whole ``batch_group`` where
    ``share`` is its size, None (no collective) where ``share`` is 1.
    Every rank makes every sub-group, one set for each ``model``
    position, at the first call for a mesh and ``share``, and keeps them
    (``torch.distributed.new_group`` needs every rank to call it in the
    same order): make them before any step is traced on fake tensors."""
    import torch.distributed as dist

    ranks = dist.get_world_size(batch_group(mesh))
    if share == ranks:
        return batch_group(mesh)
    if share == 1:
        return None
    groups = _mesh_groups(mesh)
    if share not in groups:
        names = list(mesh.mesh_dim_names)
        axes = batch_axes(mesh)
        # each row: one position of the other axes, its batch ranks in
        # the flattened (pod-major) order
        order = [names.index(a) for a in names if a not in axes] + [
            names.index(a) for a in axes]
        grid = mesh.mesh.permute(order).reshape(-1, ranks).tolist()
        me = dist.get_rank()
        for row in grid:
            for s in range(0, ranks, share):
                members = row[s:s + share]
                g = dist.new_group(members)
                if me in members:
                    groups[share] = g
    return groups[share]


def constrain(x, logical_axes: Sequence[str | None], rules: ShardingRules,
              mesh):
    """``x`` redistributed to the placements its logical axes give on
    ``mesh`` when it is a DTensor; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or mesh is None:
        return x
    spec = logical_to_spec(logical_axes, rules, mesh, tuple(x.shape))
    return x.redistribute(mesh, placements(spec, mesh))


# ---------------------------------------------------------------------------
# Tensor parallelism: the ``model`` axis as the LM's layers see it
# ---------------------------------------------------------------------------

def model_dim(d, rules: ShardingRules, mesh) -> int | None:
    """The dim of the ``ParamDef`` ``d`` that ``mesh``'s ``model`` axis
    shards under ``rules`` (its ``logical_to_spec``), or None where the
    leaf is whole on every ``model`` rank."""
    spec = logical_to_spec(d.logical_axes, rules, mesh, d.shape)
    for i, s in enumerate(spec):
        if s == "model" or (isinstance(s, tuple) and "model" in s):
            return i
    return None


def model_slice(x, dim: int | None, rank: int, size: int):
    """Block ``rank`` of ``size`` of ``x`` (a tensor or a numpy array)
    along ``dim`` (``x`` itself for None): a leaf's ``model`` shard."""
    if dim is None or size == 1:
        return x
    n = x.shape[dim] // size
    index = [slice(None)] * x.ndim
    index[dim] = slice(rank * n, (rank + 1) * n)
    return x[tuple(index)]


class TensorParallel:
    """The ``model`` axis of a process mesh as the LM's layers use it:
    its group, this rank's place on it, and the dim each leaf's shard
    splits (``model_dim``, by the leaf's name in its tree: ``embed``,
    ``wq``, ``w_down``, ...; the encoder's blocks share the decoder's
    names and layout).  A product whose output dim a leaf shards yields
    this rank's block (column-parallel); one whose contraction dim it
    shards yields a partial sum, summed over the axis by ``exit``
    (row-parallel); a leaf whole on every rank yields the whole result.
    ``enter`` marks where a tensor that every rank holds whole is used by
    a rank's own shard: its gradient there is a part, summed over the
    axis (also for a whole leaf used there, such as ``q_norm`` on the
    local heads).  With one rank (``NO_TP``) every method is the
    identity."""

    def __init__(self, group=None, dims: Mapping[str, int | None] | None
                 = None):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.dims = dict(dims or {})

    @classmethod
    def of(cls, defs, mesh, rules: ShardingRules | None = None
           ) -> "TensorParallel":
        """The layout of the ``ParamDef`` tree ``defs`` on ``mesh`` (a
        ``DeviceMesh``; None or a ``model`` axis of 1: ``NO_TP``)."""
        if mesh is None or mesh_sizes(mesh).get("model", 1) == 1:
            return NO_TP
        rules = rules or ShardingRules.default()
        dims = {}

        def walk(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v)
                else:
                    dims[k] = model_dim(v, rules, mesh)

        walk(defs)
        return cls(mesh.get_group("model"), dims)

    def sharded(self, name: str) -> bool:
        """Whether the leaf ``name`` is split over the ranks."""
        return self.size > 1 and self.dims.get(name) is not None

    def local(self, name: str, x):
        """This rank's shard of the whole leaf ``x`` named ``name``."""
        return model_slice(x, self.dims.get(name), self.rank, self.size)

    def span(self, n: int) -> tuple[int, int]:
        """This rank's block [lo, hi) of a dim of ``n`` split over the
        ranks."""
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k

    def group_pick(self, n_heads: int, n_groups: int):
        """The groups that this rank's block of ``n_heads`` heads reads,
        head ``h`` reading group ``h // (n_heads / n_groups)`` (GQA's kv
        heads, the SSM's B and C groups): a slice where they are whole
        groups each read by an equal run of the heads, else a list of one
        group a head."""
        h0, h1 = self.span(n_heads)
        idx = [h // (n_heads // n_groups) for h in range(h0, h1)]
        lo, n = idx[0], idx[-1] + 1 - idx[0]
        run = (h1 - h0) // n
        if run * n == h1 - h0 and all(i == lo + j // run
                                      for j, i in enumerate(idx)):
            return slice(lo, lo + n)
        return idx

    def enter(self, x):
        from repro_torch.distributed.collectives import enter_region
        return enter_region(x, self.group) if self.size > 1 else x

    def exit(self, x):
        from repro_torch.distributed.collectives import exit_region
        return exit_region(x, self.group) if self.size > 1 else x

    def gather(self, x, dim: int):
        from repro_torch.distributed.collectives import gather_dim
        return gather_dim(x, dim, self.group) if self.size > 1 else x

    def gather_many(self, xs: list, dim: int) -> list:
        """``gather`` of each of ``xs`` on ``dim`` in one collective (no
        gradient)."""
        from repro_torch.distributed.collectives import gather_dims
        if self.size == 1 or not xs:
            return xs
        return gather_dims(xs, dim, self.group)

    def max(self, x):
        """The elementwise max of ``x`` over the ranks (no gradient)."""
        import torch.distributed as dist

        from repro_torch.distributed.collectives import _all_reduce

        if self.size == 1:
            return x
        x = x.detach().clone()
        _all_reduce(x, self.group, dist.ReduceOp.MAX)
        return x


NO_TP = TensorParallel()


def take_groups(t, pick, dim: int):
    """``t`` at the groups ``pick`` (``TensorParallel.group_pick``; None:
    every group) on ``dim``."""
    import torch

    if pick is None:
        return t
    if isinstance(pick, slice):
        return t.narrow(dim, pick.start, pick.stop - pick.start)
    return t.index_select(dim, torch.tensor(pick, device=t.device))
