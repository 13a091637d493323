"""AdamW, SGD with momentum and Lion with global-norm clipping, written out
as the reference's ``optim/adamw.py`` computes them with its defaults
(``torch.optim.AdamW`` has other defaults and no clip).

Parameters, gradients and optimizer state are trees: dicts of float32
tensors keyed by parameter name (GraphSAGE's flat dict), nested as the
LM's parameter tree.  Leaves are visited in the reference's flatten order
(sorted keys at every level), which fixes the order of the global-norm
sum.  ``update`` writes the new parameters and moments in place, which
saves a copy of each; it returns the step's metrics as tensors, so
nothing waits for the device.  The learning rate is a float or a schedule
of the step (``optim.schedules``).

On a process mesh the leaves are DTensors (``train.steps`` shards the
LM's state): the global norm reduces each leaf's squared sum over the
ranks that shard it (an ``all_reduce`` over each mesh dim a leaf is
split on: a replicated leaf counts once), and the update
runs on each rank's local shard, since gradient, moments and parameter
share their placements.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.params import tree_leaves, tree_map

B1, B2, EPS = 0.9, 0.95, 1e-8
MAX_GRAD_NORM = 1.0       # no weight decay, as the reference's default


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], dict]
    update: Callable[[dict, dict, dict, int], dict]
    # update(grads, opt_state, params, step) -> metrics, in place


def _local(t):
    """A DTensor's local shard (the same storage), a tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _sq_sum(g) -> torch.Tensor:
    """The float32 sum of ``g``'s squares over the whole leaf: a
    DTensor's local sums added over each mesh dim that shards it."""
    if not isinstance(g, DTensor):
        return torch.sum(torch.square(g.float()))
    s = torch.sum(torch.square(g.to_local().float()))
    for dim, pl in enumerate(g.placements):
        if pl.is_shard():
            dist.all_reduce(s, group=g.device_mesh.get_group(dim))
    return s


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.
    The squares are summed in float32 in the reference's leaf order.
    Returns (clipped, norm)."""
    gn = torch.sqrt(sum(_sq_sum(g) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _local_leaves(tree) -> list:
    return [_local(t) for t in tree_leaves(tree)]


def _schedule(lr_fn) -> Callable[[int], float]:
    if callable(lr_fn):
        return lr_fn
    lr_const = float(lr_fn)
    return lambda step: lr_const


def _zeros(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _clipped(grads: dict, params: dict, max_grad_norm: float):
    """(clipped grads, norm) as the reference's optimizers take them."""
    if max_grad_norm > 0:
        return clip_by_global_norm(grads, max_grad_norm)
    device = tree_leaves(params)[0].device
    return grads, torch.zeros((), dtype=torch.float32, device=device)


def _metrics(gnorm, lr: float) -> dict:
    return {"grad_norm": gnorm,
            "lr": torch.full((), lr, dtype=torch.float32,
                             device=gnorm.device)}


def adamw(lr_fn, b1: float = B1, b2: float = B2, eps: float = EPS,
          weight_decay: float = 0.0,
          max_grad_norm: float = MAX_GRAD_NORM) -> Optimizer:
    """AdamW with bias correction at ``t = step + 1`` in float32, as the
    reference takes it, after the gradients are clipped to a global norm
    of ``max_grad_norm`` (off at 0)."""
    lr_at = _schedule(lr_fn)

    def init(params: dict) -> dict:
        return {"m": _zeros(params), "v": _zeros(params)}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, step: int) -> dict:
        grads, gnorm = _clipped(grads, params, max_grad_norm)
        lr = lr_at(step)
        device = gnorm.device
        bc1, bc2 = 1 - torch.tensor([b1, b2], dtype=torch.float32,
                                    device=device) ** float(step + 1)
        for g, m, v, p in zip(*map(_local_leaves, (grads, state["m"],
                                                   state["v"], params))):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
        return _metrics(gnorm, lr)

    return Optimizer(init=init, update=update)


def sgd(lr_fn, momentum: float = 0.9,
        max_grad_norm: float = MAX_GRAD_NORM) -> Optimizer:
    """SGD with momentum (``mom = momentum * mom + g``), clipped as
    ``adamw``."""
    lr_at = _schedule(lr_fn)

    def init(params: dict) -> dict:
        return {"mom": _zeros(params)}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, step: int) -> dict:
        grads, gnorm = _clipped(grads, params, max_grad_norm)
        lr = lr_at(step)
        for g, mo, p in zip(*map(_local_leaves, (grads, state["mom"],
                                                 params))):
            mo.mul_(momentum).add_(g.float())
            p.copy_((p.float() - lr * mo).to(p.dtype))
        return _metrics(gnorm, lr)

    return Optimizer(init=init, update=update)


def lion(lr_fn, b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.0,
         max_grad_norm: float = MAX_GRAD_NORM) -> Optimizer:
    """Lion: the sign of the interpolated momentum as the update, one
    moment (half of Adam's optimizer memory), clipped as ``adamw``."""
    lr_at = _schedule(lr_fn)

    def init(params: dict) -> dict:
        return {"m": _zeros(params)}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, step: int) -> dict:
        grads, gnorm = _clipped(grads, params, max_grad_norm)
        lr = lr_at(step)
        for g, m, p in zip(*map(_local_leaves, (grads, state["m"],
                                                params))):
            g = g.float()
            u = torch.sign(b1 * m + (1 - b1) * g)
            if weight_decay:
                u = u + weight_decay * p.float()
            m.mul_(b2).add_((1 - b2) * g)
            p.copy_((p.float() - lr * u).to(p.dtype))
        return _metrics(gnorm, lr)

    return Optimizer(init=init, update=update)
