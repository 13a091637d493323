"""Parameter definitions for the LM: shape, init and fan-in axes.

The port of the reference's ``repro/models/params.py`` without logical
axes (one card, no sharding).  A model is declared once as a nested dict
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
                enc_layers: int | None = None) -> dict:
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
    the encdec family's encoder stack, alike."""
    leaves = tree_leaves(defs)
    keys = iter(rng.split(rng.key(seed), len(leaves)))

    cuts = {"blocks": layers, "enc_blocks": enc_layers}

    def draw(d: ParamDef, cut: int | None) -> torch.Tensor:
        k = next(keys)
        dt = d.dtype if dtype is None or d.keep_dtype else dtype
        shape = d.shape if cut is None else (cut,) + d.shape[1:]
        if d.init in ("zeros", "ones"):
            fill = torch.zeros if d.init == "zeros" else torch.ones
            return fill(shape, dtype=dt, device=device)
        out = torch.empty(shape, dtype=dt, device=device)
        return rng.normal(k, shape, out=out, scale=init_scale(d))

    def walk(tree, cut: int | None):  # sorted keys: the reference's order
        if isinstance(tree, dict):
            return {k: walk(tree[k], cuts.get(k) if cut is None else cut)
                    for k in sorted(tree)}
        return draw(tree, cut)

    return walk(defs, None)


def count_params(defs) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(defs))


def cast_tree(params, dtype):
    """Cast float params to the compute dtype (the port casts once, before
    serving; the reference casts at each use, which gives the same
    values)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)
