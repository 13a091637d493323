"""Parameter definitions for the LM: shape, init and fan-in axes.

The port of the reference's ``repro/models/params.py`` without logical
axes (one card, no sharding).  A model is declared once as a nested dict
of ``ParamDef``; ``init_params`` materializes float32 tensors from it and
``count_params`` counts them.  ``init_params`` draws from a CPU
``torch.Generator`` seeded once, leaf by leaf in the reference's tree
order (sorted keys), with the reference's scales, so the weights do not
depend on the device they are moved to.  They are not ``jax.random``'s
numbers: parity tests carry the reference's weights over with
``repro_torch.convert.lm_params_from_jax``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"      # normal | zeros | ones | embed | head_scaled
    fan_in_axes: tuple[int, ...] = (0,)  # the dims that scale the init


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


def init_params(defs, seed: int = 0, device="cpu") -> dict:
    """Materialize float32 parameters from a ``ParamDef`` tree."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def draw(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            x = torch.zeros(d.shape, dtype=d.dtype)
        elif d.init == "ones":
            x = torch.ones(d.shape, dtype=d.dtype)
        else:
            fan_in = max(1, int(np.prod([d.shape[a] for a in d.fan_in_axes])))
            scale = {
                "normal": 1.0 / math.sqrt(fan_in),
                "embed": 1.0,
                "head_scaled": 0.5 / math.sqrt(fan_in),
            }[d.init]
            x = scale * torch.randn(d.shape, generator=gen, dtype=d.dtype)
        return x.to(device)

    def walk(tree):     # sorted keys: the reference's draw order
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return draw(tree)

    return walk(defs)


def count_params(defs) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(defs))


def cast_tree(params, dtype):
    """Cast float params to the compute dtype (the port casts once, before
    serving; the reference casts at each use, which gives the same
    values)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)
