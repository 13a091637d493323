"""Train, prefill and serve step builders of the port's LM.

The port of the reference's ``repro/train/steps.py`` on one card: the
parameters live in the ``LM`` module, so the steps close over it instead
of taking a params tree, a mesh and sharding rules.  ``train_step``
updates the parameters and the optimizer moments in place (the
reference's donated state) and returns its metrics as tensors, so
nothing waits for the device.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import LM
from repro_torch.models.params import tree_leaves
from repro_torch.optim.adamw import Optimizer

MOE_AUX_WEIGHT = 0.01


def cross_entropy(logits, labels):
    """logits: (B, S, V) float32; labels: (B, S) int.  The reference's
    baseline: the label's logit taken with a gather over the vocab."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def cross_entropy_sharded(logits, labels):
    """The reference's vocab-parallel form: the label's logit selected by
    an iota-compare mask and a sum over the vocab.  On one card it
    computes the same loss as ``cross_entropy``."""
    lse = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    picked = torch.where(vocab == labels.long()[..., None], logits, 0.0)
    return torch.mean(lse - picked.sum(dim=-1))


CE_IMPLS = {"gather": cross_entropy, "sharded": cross_entropy_sharded}


def build_train_step(model: LM, optimizer: Optimizer, *,
                     microbatches: int = 1, ce: str = "gather"):
    """Returns ``train_step(state, batch) -> (state, metrics)`` over the
    model's parameters (``state`` from ``init_train_state``).

    ``microbatches > 1`` splits the batch (every leaf: ``tokens`` or
    ``embeds``, ``src_embeds``, ``labels``) on its leading dim and sums the
    microbatches' gradients and metrics in order before dividing, as the
    reference's ``lax.scan`` does.  ``ce`` picks the cross-entropy
    ("gather" or "sharded").  Metrics: ``loss``, ``moe_aux``,
    ``grad_norm`` and ``lr``."""
    ce_fn = CE_IMPLS[ce]

    def grad_fn(params: list, batch: dict):
        logits, aux = model(batch)
        loss = ce_fn(logits, batch["labels"])
        moe_aux = aux["moe_aux_loss"]
        # a leaf the loss does not reach (the untied ``embed`` table under
        # an ``embeds`` batch) gets a zero gradient, as jax.value_and_grad
        # gives it
        grads = torch.autograd.grad(loss + MOE_AUX_WEIGHT * moe_aux, params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return grads, {"loss": loss.detach(), "moe_aux": moe_aux.detach()}

    def train_step(state: dict, batch: dict):
        tree = state["params"]
        params = tree_leaves(tree)
        if microbatches == 1:
            grads, metrics = grad_fn(params, batch)
        else:
            mbs = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                *v.shape[1:]) for k, v in batch.items()}
            grads, metrics = None, None
            for i in range(microbatches):
                g, m = grad_fn(params, {k: v[i] for k, v in mbs.items()})
                if grads is None:
                    grads, metrics = list(g), m
                    continue
                grads = [a + b for a, b in zip(grads, g)]
                metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = [g / microbatches for g in grads]
            metrics = {k: v / microbatches for k, v in metrics.items()}
        opt_metrics = optimizer.update(_unflatten(tree, iter(grads)),
                                       state["opt"], tree, state["step"])
        state["step"] += 1
        return state, dict(metrics, **opt_metrics)

    return train_step


def _unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves are taken from the
    iterator ``leaves`` in the reference's flatten order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def init_train_state(model: LM, optimizer: Optimizer) -> dict:
    """``{"params": model.param_tree(), "opt": optimizer.init(...),
    "step": 0}``; the parameters are the model's own, updated in
    place."""
    params = model.param_tree()
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def build_prefill_step(model: LM, cache_len: int | None = None):
    """``prefill_step(batch) -> (last logits (B, 1, V) float32, cache)``,
    the cache sized for ``cache_len`` positions (default: the prompt)."""

    def prefill_step(batch):
        return model.prefill(batch, cache_len)

    return prefill_step


def build_serve_step(model: LM):
    """One decode step: ``serve_step(tokens (B, 1), cache, position) ->
    (logits, cache, next_token_greedy (B,) int32)``; the cache is updated
    in place.  ``torch.argmax`` takes the first maximum, as ``jnp.argmax``
    does."""

    def serve_step(tokens, cache, position: int):
        logits, cache = model.decode_step(tokens, cache, position)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return logits, cache, next_tok

    return serve_step
