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


def constrain(x, logical_axes: Sequence[str | None], rules: ShardingRules,
              mesh):
    """``x`` redistributed to the placements its logical axes give on
    ``mesh`` when it is a DTensor; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or mesh is None:
        return x
    spec = logical_to_spec(logical_axes, rules, mesh, tuple(x.shape))
    return x.redistribute(mesh, placements(spec, mesh))
