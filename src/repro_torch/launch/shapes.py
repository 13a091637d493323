"""Concrete model inputs for the port's LM: ``make_batch``.

The port of the reference's ``repro/launch/shapes.py:make_batch`` (the
dry-run's ``input_specs`` and ``SHAPES`` are not carried over): the same
``np.random.default_rng(seed)`` draws in the same order, so the prompt
tokens are bit-equal to the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.registry import ModelConfig
from repro_torch.models.transformer import COMPUTE_DTYPE


def make_batch(cfg: ModelConfig, B: int, S: int, seed: int = 0,
               kind: str = "train", device="cpu") -> dict:
    """Concrete batch: int32 ``tokens`` (B, S) (or bf16 ``embeds``), plus
    ``src_embeds`` for enc-dec and ``labels`` for training; for ``kind ==
    "decode"`` one token per row and the int ``position``."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model

    def tensor(a, dtype):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    if kind in ("train", "prefill"):
        batch = {}
        if cfg.embeds_input and cfg.family != "encdec":
            batch["embeds"] = tensor(
                rng.normal(size=(B, S, d)).astype(np.float32), COMPUTE_DTYPE)
        else:
            batch["tokens"] = tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                     torch.int32)
        if cfg.family == "encdec":
            batch["src_embeds"] = tensor(
                rng.normal(size=(B, S // cfg.enc_seq_divisor, d))
                .astype(np.float32), COMPUTE_DTYPE)
        if kind == "train":
            batch["labels"] = tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                     torch.int32)
        return batch
    return {"tokens": tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                             torch.int32),
            "position": S - 1}
