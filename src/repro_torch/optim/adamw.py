"""AdamW with global-norm clipping, written out as the reference's
``optim/adamw.py`` computes it with its defaults (``torch.optim.AdamW``
has other defaults and no clip).

Parameters and optimizer state are dicts of float32 tensors keyed by
parameter name.  ``update`` writes the new parameters and moments in
place, which saves a copy of each; it returns the step's metrics as
tensors, so nothing waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

B1, B2, EPS = 0.9, 0.95, 1e-8
MAX_GRAD_NORM = 1.0       # no weight decay, as the reference's default


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], dict]
    update: Callable[[dict, dict, dict, int], dict]
    # update(grads, opt_state, params, step) -> metrics, in place


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.
    The squares are summed in float32 in sorted-name order, as the
    reference sums its dict leaves.  Returns (clipped, norm)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(grads[k].float()))
                        for k in sorted(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


def adamw(lr: float) -> Optimizer:
    """AdamW (b1 0.9, b2 0.95, eps 1e-8) with bias correction at
    ``t = step + 1`` in float32, as the reference takes it, after the
    gradients are clipped to a global norm of 1."""

    def init(params: dict) -> dict:
        return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict, step: int) -> dict:
        grads, gnorm = clip_by_global_norm(grads, MAX_GRAD_NORM)
        device = next(iter(params.values())).device
        bc1, bc2 = 1 - torch.tensor([B1, B2], dtype=torch.float32,
                                    device=device) ** float(step + 1)
        for k, p in params.items():
            g = grads[k].float()
            m, v = state["m"][k], state["v"][k]
            m.mul_(B1).add_((1 - B1) * g)
            v.mul_(B2).add_((1 - B2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            p.copy_((p.float() - lr * delta).to(p.dtype))
        return {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init=init, update=update)
