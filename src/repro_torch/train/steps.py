"""Serving step builders of the port's LM.

The port of ``build_prefill_step`` and ``build_serve_step`` from the
reference's ``repro/train/steps.py``, on one card: the parameters live in
the ``LM`` module, so the steps close over it instead of taking a params
tree, a mesh and sharding rules.  The cross-entropy and training-step
builders come with the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import LM


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
