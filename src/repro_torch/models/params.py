"""Parameter definitions for the LM: shape, logical axes, init and fan-in
axes.

The port of the reference's ``repro/models/params.py``.  Each leaf's
``logical_axes`` name what its dims mean (``("layers", "embed", "heads",
"qkv")``); ``distributed.sharding.logical_to_spec`` maps them onto a
process mesh, as the reference's rules do.  A model is declared once as a nested dict
of ``ParamDef``; ``init_params`` materializes tensors from it and
``count_params`` counts them.  ``init_params`` draws the reference's
numbers: leaf ``i`` of the tree in the reference's flatten order (sorted
keys) takes key ``split(key(seed), n_leaves)[i]`` and
``rng.normal``, ``jax.random.normal``'s float32 stream, times the
reference's scale.  The draw runs on the device it is given, one leaf and
one chunk at a time, straight into the dtype asked for (a bf16 leaf holds
the rounding of the float32 weight, as the reference's cast at use
does), so a model never passes through the host or through float32 when
it is served in bf16.  The weights equal the reference's within
``erfinv``'s last-bit rounding (``rng.normal``).

For the dry-run (``launch.dryrun``) a tree is also made without drawing
and without memory: ``fake_params`` gives each leaf as a fake tensor of
the shape a tensor-parallel rank holds, ``abstract_params`` (the
reference's) as a DTensor on a mesh whose local tensor is a fake tensor
of the rank's shard under the sharding rules.  Both make their fake
tensors in the ``FakeTensorMode`` in force, else in this module's own.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import rng


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"      # normal | zeros | ones | embed | head_scaled
    fan_in_axes: tuple[int, ...] = (0,)  # the dims that scale the init
    # stays in ``dtype`` when the tree is drawn in a compute dtype (the
    # MoE router, which the reference casts to float32 at use)
    keep_dtype: bool = False
    # one logical axis name (or None) per dim, the reference's
    logical_axes: tuple = ()

    def __post_init__(self):
        assert len(self.shape) == len(self.logical_axes), (
            f"shape {self.shape} vs axes {self.logical_axes}")


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in the reference's flatten order (sorted
    keys, depth first)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict, same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_scale(d: ParamDef) -> float:
    """The reference's scale of a drawn leaf: 1/sqrt(fan_in) over
    ``fan_in_axes`` (so a stacked (L, d, E) router with the default axes
    scales by 1/sqrt(L), as the reference's does)."""
    fan_in = max(1, int(np.prod([d.shape[a] for a in d.fan_in_axes])))
    return {"normal": 1.0 / math.sqrt(fan_in), "embed": 1.0,
            "head_scaled": 0.5 / math.sqrt(fan_in)}[d.init]


def init_params(defs, seed: int = 0, device="cpu",
                dtype: torch.dtype | None = None,
                layers: int | None = None,
                enc_layers: int | None = None, tp=None) -> dict:
    """Materialize the parameters of a ``ParamDef`` tree on ``device``, in
    ``dtype`` (default, and for a ``keep_dtype`` leaf: the leaf's own,
    float32): the reference's
    ``init_params(defs, jax.random.key(seed))``.  Every leaf, ``zeros``
    and ``ones`` ones too, takes its key of ``split(key(seed),
    n_leaves)`` in the reference's flatten order.  With ``layers``, each
    leaf under ``blocks`` (stacked over the model's layers on axis 0) is
    drawn over its first ``layers`` rows only, at its full scale: the
    first layers of the model that ``defs`` declares (the draw's counter
    is the flat index, so a leading slice draws as that slice of the
    whole leaf).  ``enc_layers`` cuts the leaves under ``enc_blocks``,
    the encdec family's encoder stack, alike.  With ``tp`` (a
    ``distributed.sharding.TensorParallel``) each leaf that its ``model``
    axis splits is drawn as this rank's block only (``rng.normal``'s
    ``block``: each entry the whole leaf's number), so no rank holds a
    whole sharded leaf."""
    leaves = tree_leaves(defs)
    keys = iter(rng.split(rng.key(seed), len(leaves)))

    cuts = {"blocks": layers, "enc_blocks": enc_layers}

    def draw(d: ParamDef, cut: int | None, name: str) -> torch.Tensor:
        k = next(keys)
        dt = d.dtype if dtype is None or d.keep_dtype else dtype
        shape = d.shape if cut is None else (cut,) + d.shape[1:]
        dim = tp.dims.get(name) if tp is not None and tp.size > 1 else None
        local = list(shape)
        if dim is not None:
            local[dim] //= tp.size
        if d.init in ("zeros", "ones"):
            fill = torch.zeros if d.init == "zeros" else torch.ones
            return fill(local, dtype=dt, device=device)
        out = torch.empty(local, dtype=dt, device=device)
        block = None if dim is None else (dim, tp.rank * local[dim])
        return rng.normal(k, shape, out=out, scale=init_scale(d),
                          block=block)

    def walk(tree, cut: int | None, name: str = ""):
        if isinstance(tree, dict):  # sorted keys: the reference's order
            return {k: walk(tree[k], cuts.get(k) if cut is None else cut, k)
                    for k in sorted(tree)}
        return draw(tree, cut, name)

    return walk(defs, None)


def count_params(defs) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(defs))


def cast_tree(params, dtype):
    """Cast float params to the compute dtype (the port casts once, before
    serving; the reference casts at each use, which gives the same
    values)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


# ---------------------------------------------------------------------------
# Abstract trees: shapes without weights (the dry-run)
# ---------------------------------------------------------------------------

_FAKE = None          # this module's FakeTensorMode, made at first use


def fake_empty(shape, dtype, device) -> torch.Tensor:
    """An uninitialized fake tensor: in the ``FakeTensorMode`` in force,
    else in this module's own (no memory either way)."""
    global _FAKE
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    if detect_fake_mode() is not None:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    if _FAKE is None:
        _FAKE = FakeTensorMode(allow_non_fake_inputs=True)
    with _FAKE:
        return torch.empty(tuple(shape), dtype=dtype, device=device)


def local_shape(shape, placements, mesh) -> tuple[int, ...]:
    """The shape of a rank's shard of a ``shape`` leaf under DTensor
    ``placements`` on ``mesh`` (each ``Shard(d)`` divides dim ``d`` by its
    mesh dim's size; the rules shard only dims they divide)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def sharded_fake(shape, dtype, logical_axes, rules, mesh, device):
    """A DTensor on ``mesh`` of global ``shape`` and ``dtype``, placed as
    ``rules`` place ``logical_axes`` (``logical_to_spec``, divisibility
    respected), whose local tensor is a fake tensor of this rank's shard:
    the reference's ``ShapeDtypeStruct`` with a ``NamedSharding``.
    Without a mesh (one process): a fake tensor of the whole shape."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import logical_to_spec, placements

    if mesh is None:
        return fake_empty(shape, dtype, device)
    pl = placements(logical_to_spec(logical_axes, rules, mesh, shape), mesh)
    local = fake_empty(local_shape(shape, pl, mesh), dtype, device)
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def fake_params(defs, device="cuda", dtype: torch.dtype | None = None,
                tp=None) -> dict:
    """``init_params``' tree without the draw: each leaf a fake tensor of
    the shape ``init_params(defs, device=device, dtype=dtype, tp=tp)``
    gives it (a ``tp`` rank's block of the leaves its ``model`` axis
    splits), in ``dtype`` (default, and for a ``keep_dtype`` leaf: the
    leaf's own)."""

    def walk(tree, name: str = ""):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        dim = tp.dims.get(name) if tp is not None and tp.size > 1 else None
        shape = list(tree.shape)
        if dim is not None:
            shape[dim] //= tp.size
        dt = tree.dtype if dtype is None or tree.keep_dtype else dtype
        return fake_empty(shape, dt, device)

    return walk(defs)


def abstract_params(defs, rules, mesh, device="cuda") -> dict:
    """The reference's ``abstract_params``: every leaf of a ``ParamDef``
    tree as a ``sharded_fake`` DTensor on ``mesh`` under ``rules``, in the
    leaf's dtype."""
    return tree_map(lambda d: sharded_fake(d.shape, d.dtype, d.logical_axes,
                                           rules, mesh, device), defs)
