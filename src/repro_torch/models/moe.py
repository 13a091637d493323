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
the reference's mesh and have no counterpart here.

Under data parallelism (``global_dispatch(group)``, which the train step
of a process mesh enters with the ranks that hold one of the reference's
microbatches: ``sharding.microbatch_group``, None where a rank holds a
whole one) the tokens of one dispatch group may lie on several ranks.
The reference cuts a microbatch's T tokens, in row-major order, into
``groups`` G groups of ``Tg = T / G``, each with its own cumsum and
capacity ``C``; rank t of the q that hold the microbatch holds its
tokens ``t * T / q`` onward, which may end inside a group or begin in
one.  So each rank cuts its tokens into parts, one for each group they
touch, counts each part's assignments per expert and sums over the
ranks a (q, G, E) table of those counts (one ``all_reduce``: a rank's
row is zero but for its groups); a part's slot 0 lies at the counts of
the ranks before it in that group, and an assignment is kept iff that
offset plus its place in its part is below ``C``.  Each part's kept
tokens fill its own (E, C) table at their places in the part, and the
expert products are row by row, so each kept token gets the output one
rank would give it.  Where every rank holds whole groups (G a multiple
of q) no part needs an offset and the table is not summed.  The aux
loss is ``E * sum(f_e * P_e)`` over the microbatch whatever G is: ``f``
the global count share (an ``all_reduce`` of the (E,) counts where the
table was not summed), ``P`` the global mean's value (an
``all_reduce`` of the probability sums) with the local mean's gradient,
which the gradient's average over the ranks turns into the global
mean's.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.params import ParamDef


def moe_defs(d_model: int, d_ff: int, num_experts: int, layers: int):
    """The stacked router and expert weights.  The router keeps the
    reference's default fan-in axis 0 (its scale is 1/sqrt(layers)) and
    stays float32 when the tree is drawn in a compute dtype: the
    reference casts it to float32 at use."""
    return {
        "router": ParamDef((layers, d_model, num_experts), keep_dtype=True,
                           logical_axes=("layers", "embed", None)),
        "w_gate": ParamDef((layers, num_experts, d_model, d_ff),
                           fan_in_axes=(2,),
                           logical_axes=("layers", "experts", "embed", "mlp")),
        "w_up": ParamDef((layers, num_experts, d_model, d_ff),
                         fan_in_axes=(2,),
                         logical_axes=("layers", "experts", "embed", "mlp")),
        "w_down": ParamDef((layers, num_experts, d_ff, d_model),
                           fan_in_axes=(2,),
                           logical_axes=("layers", "experts", "mlp", "embed")),
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


# the dispatch group, held for the whole process: the backward recomputes
# a rematerialized block's routing on autograd's own thread for CUDA
# tensors, which a context variable set by the train step would not reach
_DISPATCH = [None]


@contextlib.contextmanager
def global_dispatch(group):
    """Route as one dispatch over the tokens of every rank of ``group``
    (the data-parallel ranks that hold one microbatch) inside; None or a
    group of one rank routes locally.  A rank's place in the microbatch's
    token order is its rank in ``group`` (``data.tokens.rank_rows``: rank
    t holds its t-th range).  Every thread of the process routes so
    inside (the backward's recompute included)."""
    saved = _DISPATCH[0]
    _DISPATCH[0] = group
    try:
        yield
    finally:
        _DISPATCH[0] = saved


def _ranks(group) -> tuple[int, int]:
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def capacity(capacity_factor: float, top_k: int, Tg: int, E: int) -> int:
    """Slots an expert has in a group of ``Tg`` tokens, as the reference
    computes it (in Python floats)."""
    return max(1, min(int(capacity_factor * top_k * Tg / E), Tg))


class Route(NamedTuple):
    """A routing of this rank's ``n * Tc`` tokens to their top-k experts,
    in ``n`` chunks of ``Tc`` tokens that each lie in one dispatch group
    (on one rank: the reference's (G, Tg) groups), and their slots in
    ``P`` tables, one for each part of the tokens: the run of chunks in
    one group (each chunk its own part unless a group straddles ranks)."""
    expert_idx: torch.Tensor    # (n, Tc, k) int64, best first
    gates: torch.Tensor         # (n, Tc, k) float32
    pos: torch.Tensor           # (n, Tc * k) int64: slot in its part's table
    keep: torch.Tensor          # (n, Tc * k) bool: global position < C
    slot_tok: torch.Tensor      # (P, E, C) int64: token id in its part,
    #                             Tg if empty
    aux: torch.Tensor           # float32 scalar: the Switch aux loss
    offset: torch.Tensor | None  # (P, E) int64: the global position of
    #                             each part's slot 0 (the counts of the
    #                             ranks before this one in its group);
    #                             None where every part starts a group
    part: torch.Tensor          # (n,) int64: each chunk's part
    first: torch.Tensor         # (P,) int64: each part's first token
    #                             among this rank's


def route(router, x, *, top_k: int, capacity_factor: float = 1.25,
          routing: str = "softmax", groups: int = 1) -> Route:
    """The routing ``apply_moe`` takes for ``x`` (B, S, d) under the
    router (d, E): ``groups`` dispatch groups (1 when it does not divide
    the B * S tokens of every rank together), each with its own cumsum
    and capacity, cut where they span ranks (the module docstring).  On
    one rank the chunks and parts are the reference's groups, and its
    fields are the reference's."""
    B, S, d = x.shape
    group = _DISPATCH[0]
    rank, ranks = _ranks(group)
    Tl = B * S                              # this rank's tokens
    T = Tl * ranks                          # the microbatch's
    E = router.shape[-1]
    G = groups if T % groups == 0 else 1
    Tg = T // G
    C = capacity(capacity_factor, top_k, Tg, E)
    Tc = math.gcd(Tl, Tg)                   # a chunk lies in one group
    n = Tl // Tc
    start = rank * Tl                       # this rank's first token
    g0 = start // Tg                        # the group of its first part
    P = (start + Tl - 1) // Tg - g0 + 1
    dev = x.device

    with _float32_products():
        # one (T, d) x (d, E) product: no batch dims, as the reference's
        # einsum (a "dots" remat saves it)
        logits = (x.reshape(Tl, d).float() @ router.float()
                  ).reshape(n, Tc, E)
    scores = logits if routing == "softmax" else torch.sigmoid(logits)
    # lax.top_k: the k largest, ties to the lower index
    vals, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :top_k], order[..., :top_k]
    if routing == "softmax":
        gates = torch.softmax(gate_vals, dim=-1)
    else:  # sigmoid (deepseek/moonlight-style), renormalized over top-k
        gates = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, k) assignment within its expert, per chunk
    flat_e = expert_idx.reshape(n, Tc * top_k)                  # (n, Tk)
    oh = (flat_e[..., None] == torch.arange(E, device=dev)).to(torch.int32)
    pos = torch.gather(oh.cumsum(dim=1, dtype=torch.int32) - 1, 2,
                       flat_e[..., None])[..., 0].long()        # (n, Tk)
    counts = oh.sum(dim=1)                                      # (n, E)
    # then per part: after the counts of its part's earlier chunks
    part = (start + torch.arange(n, device=dev) * Tc) // Tg - g0
    first = ((g0 + torch.arange(P, device=dev)) * Tg - start).clamp_min(0)
    before = counts.cumsum(dim=0) - counts
    before = before - before[first[part] // Tc]
    pos = pos + torch.gather(before, 1, flat_e)
    counts = torch.zeros(P, E, dtype=counts.dtype,
                         device=dev).index_add_(0, part, counts)
    offset = None
    probs = torch.softmax(logits, dim=-1)                       # (n, Tc, E)
    frac_probs = probs.mean(dim=(0, 1))
    if ranks > 1:
        if Tl % Tg:
            # a group spans ranks: every rank's counts in every group
            table = torch.zeros(ranks, G, E, dtype=counts.dtype, device=dev)
            table[rank, g0:g0 + P] = counts
            dist.all_reduce(table, group=group)
            offset = table[:rank, g0:g0 + P].sum(dim=0)        # (P, E)
            counts = table.sum(dim=(0, 1))
        else:
            counts = counts.sum(dim=0)
            dist.all_reduce(counts, group=group)
        psum = probs.detach().sum(dim=(0, 1))
        dist.all_reduce(psum, group=group)
        # the global mean's value, the local mean's gradient
        frac_probs = frac_probs + (psum / T - frac_probs).detach()
    else:
        counts = counts.sum(dim=0)
    if offset is None:
        keep = pos < C
    else:                                   # the global position
        keep = pos + torch.gather(offset[part], 1, flat_e) < C

    # Switch load-balancing loss: the one-hot's counts over T * k
    frac_tokens = counts.float() / (T * top_k)
    aux = E * torch.sum(frac_tokens * frac_probs)

    # the (P, E, C) slot table of token ids in their part; a dropped
    # assignment writes the sentinel Tg to column E * C, which is cut off
    slot = torch.full((P, E * C + 1), Tg, dtype=torch.int64, device=dev)
    at = torch.where(keep, flat_e * C + pos, E * C)
    token_ids = (torch.arange(Tl, device=dev).reshape(n, Tc)
                 - first[part][:, None]).repeat_interleave(top_k, dim=1)
    slot.view(-1).scatter_(0, (at + part[:, None] * (E * C + 1)).reshape(-1),
                           torch.where(keep, token_ids, Tg).reshape(-1))
    slot_tok = slot[:, :E * C].reshape(P, E, C)
    return Route(expert_idx, gates, pos, keep, slot_tok, aux, offset, part,
                 first)


def apply_moe(p, x, *, top_k: int, capacity_factor: float = 1.25,
              act=F.silu, routing: str = "softmax", groups: int = 1,
              tp=None):
    """p: one layer's slice of ``moe_defs``' parameters; x: (B, S, d).
    Returns (out (B, S, d) in x's dtype, {"moe_aux_loss": float32
    scalar}), under ``route``'s routing.  Where ``tp`` splits the experts
    over the ``model`` ranks, ``p``'s expert weights are this rank's
    block of E: every rank routes every token alike (the router is
    whole), runs its own experts on their slots, and each token's
    combine gathers only the assignments to those experts and is summed
    over the ranks (the reference's masked local gather and psum over
    ``model``).  Where the ranks do not divide E the rules split each
    expert's hidden dim instead: every rank runs every expert on its
    block of that dim and the expert outputs are summed over the ranks
    before the combine."""
    B, S, d = x.shape
    r = route(p["router"], x, top_k=top_k, capacity_factor=capacity_factor,
              routing=routing, groups=groups)
    P, E, C = r.slot_tok.shape
    n, Tc, _ = r.expert_idx.shape
    part, first = r.part, r.first
    # a part's filled slots hold ids below its token count, from its first
    size = torch.diff(first, append=first.new_full((1,), n * Tc))
    rows = (first[:, None, None] + r.slot_tok).clamp_max(n * Tc - 1)
    xg = torch.gather(x.reshape(1, n * Tc, d), 1,
                      rows.reshape(1, -1, 1).expand(-1, -1, d))
    xg = torch.where((r.slot_tok < size[:, None, None])[..., None],
                     xg.reshape(P, E, C, d), 0)
    split = tp is not None and tp.sharded("w_gate")
    # the rules split the experts where the ranks divide them, else each
    # expert's hidden dim (``mlp``): every rank then holds every expert
    ffn_split = split and p["w_gate"].shape[0] == E
    e0, El, gates, keep = 0, E, r.gates, r.keep
    flat_e = r.expert_idx.reshape(n, Tc * top_k)
    if split and not ffn_split:
        e0, e1 = tp.span(E)
        El = e1 - e0
        # the whole dispatch and gates, each rank's experts using a part
        xg = tp.enter(xg)[:, e0:e1]
        gates = tp.enter(gates)
        keep = keep & (flat_e >= e0) & (flat_e < e1)
    elif ffn_split:
        # column-parallel gate and up products, a row-parallel down
        # product: each rank's partial expert outputs, summed over the
        # ranks below
        xg = tp.enter(xg)
    h = act(torch.einsum("gecd,edf->gecf", xg, p["w_gate"].to(x.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", xg, p["w_up"].to(x.dtype))
    y = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(x.dtype))
    if ffn_split:
        y = tp.exit(y)

    # combine: each assignment gathers its expert output from its part's
    # table, token side
    slot_of_assign = ((flat_e - e0) * C + torch.where(keep, r.pos, C - 1)
                      ).clamp(0, El * C - 1) + part[:, None] * (El * C)
    picked = torch.gather(y.reshape(1, P * El * C, d), 1,
                          slot_of_assign.reshape(1, -1, 1).expand(-1, -1, d))
    picked = torch.where(keep[..., None], picked.reshape(n, Tc * top_k, d),
                         0)
    out = (picked.float() * gates.reshape(n, Tc * top_k)[..., None]
           ).reshape(n, Tc, top_k, d).sum(dim=2)
    if split and not ffn_split:
        out = tp.exit(out)
    return out.reshape(B, S, d).to(x.dtype), {"moe_aux_loss": r.aux}
