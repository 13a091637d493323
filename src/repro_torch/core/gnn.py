"""GraphSAGE over dense per-hop feature tensors, in PyTorch.

The port of the reference's ``core/gnn.py``.  A depth-k sample gives
per-hop features ``h[0]: (M, F), h[1]: (M, f1, F), h[2]: (M, f1, f2, F)``;
layer l aggregates hop t+1 into hop t (mean or max-pool aggregator,
Hamilton et al.) and applies its dense weights.  Everything is matrix
products and reductions over the fanout, with no scatter; the products go
to ``torch.matmul``, as the reference leaves them to XLA.

Parameters keep the reference's names and layouts (``l{l}_self`` is
``(d_in, d_out)``), so a JAX parameter dict converts one to one
(``repro_torch.convert``).  They stay float32 and are cast to the model's
compute type where they are used; the L2 norm is taken in float32 and the
logits are returned in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from repro_torch import rng

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    feat_dim: int
    hidden: int = 256
    n_classes: int = 41
    fanouts: tuple[int, ...] = (25, 10)
    aggregator: str = "mean"          # mean | pool
    name: str = "graphsage"

    @property
    def depth(self) -> int:
        return len(self.fanouts)


def build_defs(cfg: GNNConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """Parameter name -> (shape, init): one (self, neigh, bias[, pool])
    set per layer and the final classifier, as the reference declares."""
    defs: dict = {}
    d_in = cfg.feat_dim
    for l in range(cfg.depth):
        d_out = cfg.hidden
        defs[f"l{l}_self"] = ((d_in, d_out), "normal")
        defs[f"l{l}_neigh"] = ((d_in, d_out), "normal")
        defs[f"l{l}_bias"] = ((d_out,), "zeros")
        if cfg.aggregator == "pool":
            defs[f"l{l}_pool_w"] = ((d_in, d_in), "normal")
            defs[f"l{l}_pool_b"] = ((d_in,), "zeros")
        d_in = d_out
    defs["cls"] = ((d_in, cfg.n_classes), "normal")
    defs["cls_bias"] = ((cfg.n_classes,), "zeros")
    return defs


class GraphSAGE(nn.Module):
    """GraphSAGE whose parameters are named as in the reference.

    Weights are the reference's ``GraphSAGE.init(jax.random.key(0))``:
    leaf ``i`` of the parameter names in sorted order (``cls``,
    ``cls_bias``, ``l0_bias``, ``l0_neigh``, ...) takes key
    ``split(key(0), n)[i]`` and ``rng.normal`` scaled by
    1/sqrt(shape[0]), drawn on ``device``.  Biases start at zero."""

    def __init__(self, cfg: GNNConfig, *, device="cuda",
                 compute_dtype: torch.dtype = COMPUTE_DTYPE):
        super().__init__()
        if cfg.aggregator not in ("mean", "pool"):
            raise ValueError(f"unknown aggregator {cfg.aggregator!r}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        defs = build_defs(cfg)
        keys = dict(zip(sorted(defs), rng.split(rng.key(0), len(defs))))
        for name, (shape, init) in defs.items():
            if init == "zeros":
                w = torch.zeros(shape, device=device)
            else:
                w = rng.normal(keys[name], shape, device=device,
                               scale=1.0 / math.sqrt(max(1, shape[0])))
            self.register_parameter(name, nn.Parameter(w))

    def _p(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        return getattr(self, name).to(dtype)

    def _aggregate(self, l: int, h_neigh: torch.Tensor) -> torch.Tensor:
        """h_neigh: (..., fanout, F) -> (..., F)."""
        if self.cfg.aggregator == "pool":
            z = torch.relu(h_neigh @ self._p(f"l{l}_pool_w", h_neigh.dtype)
                           + self._p(f"l{l}_pool_b", h_neigh.dtype))
            return z.amax(dim=-2)
        return h_neigh.mean(dim=-2)

    def _convolve(self, l: int, h_self: torch.Tensor,
                  h_neigh_agg: torch.Tensor) -> torch.Tensor:
        dt = h_self.dtype
        out = torch.relu(h_self @ self._p(f"l{l}_self", dt)
                         + h_neigh_agg @ self._p(f"l{l}_neigh", dt)
                         + self._p(f"l{l}_bias", dt))
        # L2-normalize (GraphSAGE line 7), in float32, for stability
        out = out.float()
        norm = torch.sqrt(torch.sum(torch.square(out), -1, keepdim=True))
        return (out / torch.clamp(norm, min=1e-6)).to(dt)

    def forward(self, hop_feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """hop_feats[t] has t fanout dims: (M, f1, .., ft, F).  Returns
        logits (M, n_classes) in float32."""
        cfg = self.cfg
        if len(hop_feats) != cfg.depth + 1:
            raise ValueError(f"{len(hop_feats)} hop tensors for depth "
                             f"{cfg.depth}")
        h = [f.to(self.compute_dtype) for f in hop_feats]
        # layer l merges hop t+1 into hop t for all t <= depth-1-l
        for l in range(cfg.depth):
            h = [self._convolve(l, h[t], self._aggregate(l, h[t + 1]))
                 for t in range(cfg.depth - l)]
        dt = h[0].dtype
        logits = h[0] @ self._p("cls", dt) + self._p("cls_bias", dt)
        return logits.float()


def gnn_loss_fn(model: GraphSAGE, hop_feats, labels):
    """Mean cross-entropy and accuracy: (loss, {"loss", "acc"})."""
    logits = model(hop_feats)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    loss = torch.mean(lse - ll)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss.detach(), "acc": acc}
