"""Mixture-of-Experts with top-k routing and capacity-based dispatch.

The port of the reference's ``repro/models/moe.py`` on one card.  The
router picks ``top_k`` experts a token (softmax over the top-k logits,
or sigmoid scores renormalized over the top k), each (token, k)
assignment takes the next free slot of its expert's capacity ``C`` in its
dispatch group (a cumsum over the group's one-hot routing matrix), the
kept token rows are gathered into an (G, E, C, d) buffer, the experts'
three batched products run on it, and each token gathers its
assignments' outputs back and sums them under its gates in float32.
The Switch load-balancing loss comes with the output.

Every integer the routing makes (expert ids, positions, the slot table)
is the reference's: the router's logits are float32 products of float32
operands (TF32 off, so a card's product rounds as a float32 one does),
``lax.top_k``'s tie order (the lower index first) is a stable descending
sort, and the slot table is a scatter into a (G, E*C + 1) table whose
last column takes every dropped assignment, then is cut off (the
reference's ``mode="drop"``), with no host synchronization (no boolean
masks, no ``nonzero``).  The expert products are library products
(``einsum``), as the reference leaves them to XLA: its MoE has no Pallas
kernel.  ``constrain_fn`` and ``moe_zero3_gather`` are sharding knobs of
the reference's mesh and have no counterpart on one card.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef


def moe_defs(d_model: int, d_ff: int, num_experts: int, layers: int):
    """The stacked router and expert weights.  The router keeps the
    reference's default fan-in axis 0 (its scale is 1/sqrt(layers)) and
    stays float32 when the tree is drawn in a compute dtype: the
    reference casts it to float32 at use."""
    return {
        "router": ParamDef((layers, d_model, num_experts), keep_dtype=True),
        "w_gate": ParamDef((layers, num_experts, d_model, d_ff),
                           fan_in_axes=(2,)),
        "w_up": ParamDef((layers, num_experts, d_model, d_ff),
                         fan_in_axes=(2,)),
        "w_down": ParamDef((layers, num_experts, d_ff, d_model),
                           fan_in_axes=(2,)),
    }


@contextlib.contextmanager
def _float32_products():
    """TF32 off for the products inside (the router's logits decide the
    expert ids)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def capacity(capacity_factor: float, top_k: int, Tg: int, E: int) -> int:
    """Slots an expert has in a group of ``Tg`` tokens, as the reference
    computes it (in Python floats)."""
    return max(1, min(int(capacity_factor * top_k * Tg / E), Tg))


class Route(NamedTuple):
    """A routing of ``T = G * Tg`` tokens to their top-k experts."""
    expert_idx: torch.Tensor    # (G, Tg, k) int64, best first
    gates: torch.Tensor         # (G, Tg, k) float32
    pos: torch.Tensor           # (G, Tg * k) int64: slot in its expert
    keep: torch.Tensor          # (G, Tg * k) bool: pos < C
    slot_tok: torch.Tensor      # (G, E, C) int64: token id, Tg if empty
    aux: torch.Tensor           # float32 scalar: the Switch aux loss


def route(router, x, *, top_k: int, capacity_factor: float = 1.25,
          routing: str = "softmax", groups: int = 1) -> Route:
    """The routing ``apply_moe`` takes for ``x`` (B, S, d) under the
    router (d, E): ``groups`` dispatch groups (1 when it does not divide
    the B * S tokens), each with its own cumsum and capacity."""
    B, S, d = x.shape
    T = B * S
    E = router.shape[-1]
    G = groups if T % groups == 0 else 1
    Tg = T // G
    C = capacity(capacity_factor, top_k, Tg, E)
    dev = x.device

    with _float32_products():
        logits = torch.einsum("gtd,de->gte", x.reshape(G, Tg, d).float(),
                              router.float())
    scores = logits if routing == "softmax" else torch.sigmoid(logits)
    # lax.top_k: the k largest, ties to the lower index
    vals, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :top_k], order[..., :top_k]
    if routing == "softmax":
        gates = torch.softmax(gate_vals, dim=-1)
    else:  # sigmoid (deepseek/moonlight-style), renormalized over top-k
        gates = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, k) assignment within its expert, per group
    flat_e = expert_idx.reshape(G, Tg * top_k)                  # (G, Tk)
    oh = (flat_e[..., None] == torch.arange(E, device=dev)).to(torch.int32)
    pos = torch.gather(oh.cumsum(dim=1, dtype=torch.int32) - 1, 2,
                       flat_e[..., None])[..., 0].long()        # (G, Tk)
    keep = pos < C

    # Switch load-balancing loss: the one-hot's counts over T * k
    probs = torch.softmax(logits, dim=-1)                       # (G, Tg, E)
    frac_tokens = oh.sum(dim=(0, 1)).float() / (T * top_k)
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)

    # the (G, E, C) slot table of token ids; a dropped assignment writes
    # the sentinel Tg to column E * C, which is cut off
    token_ids = torch.arange(Tg, device=dev).repeat_interleave(top_k)
    slot = torch.full((G, E * C + 1), Tg, dtype=torch.int64, device=dev)
    slot.scatter_(1, torch.where(keep, flat_e * C + pos, E * C),
                  torch.where(keep, token_ids, Tg))
    slot_tok = slot[:, :E * C].reshape(G, E, C)
    return Route(expert_idx, gates, pos, keep, slot_tok, aux)


def apply_moe(p, x, *, top_k: int, capacity_factor: float = 1.25,
              act=F.silu, routing: str = "softmax", groups: int = 1):
    """p: one layer's slice of ``moe_defs``' parameters; x: (B, S, d).
    Returns (out (B, S, d) in x's dtype, {"moe_aux_loss": float32
    scalar}), under ``route``'s routing."""
    B, S, d = x.shape
    r = route(p["router"], x, top_k=top_k, capacity_factor=capacity_factor,
              routing=routing, groups=groups)
    G, E, C = r.slot_tok.shape
    Tg = B * S // G
    xt = x.reshape(G, Tg, d)
    slot_valid = r.slot_tok < Tg

    rows = r.slot_tok.clamp_max(Tg - 1).reshape(G, E * C, 1).expand(-1, -1, d)
    xg = torch.gather(xt, 1, rows).reshape(G, E, C, d)
    xg = torch.where(slot_valid[..., None], xg, 0)
    h = act(torch.einsum("gecd,edf->gecf", xg, p["w_gate"].to(x.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", xg, p["w_up"].to(x.dtype))
    y = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(x.dtype))

    # combine: each assignment gathers its expert output, token side
    flat_e = r.expert_idx.reshape(G, Tg * top_k)
    slot_of_assign = (flat_e * C + torch.where(r.keep, r.pos, C - 1)
                      ).clamp_max(E * C - 1)
    picked = torch.gather(y.reshape(G, E * C, d), 1,
                          slot_of_assign[..., None].expand(-1, -1, d))
    picked = torch.where(r.keep[..., None], picked, 0)
    out = (picked.float() * r.gates.reshape(G, Tg * top_k)[..., None]
           ).reshape(G, Tg, top_k, d).sum(dim=2)
    return out.reshape(B, S, d).to(x.dtype), {"moe_aux_loss": r.aux}
