"""Synthetic LM token pipeline: deterministic, restart-safe.

A copy of the reference's ``repro/data/tokens.py`` (numpy only): every
batch is a pure function of (seed, step), drawn with the same
``np.random.default_rng((seed, step))`` calls in the same order, so the
batches are bit-equal to the reference's.  Sequences are Zipf-distributed
token streams with document boundaries, enough structure for the loss to
move in a short run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    doc_len: int = 512

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, step))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """-> {tokens: (B, S) int32, labels: (B, S) int32}: S + 1 tokens
        drawn per row, labels the next-token shift of tokens."""
        rng = self._rng(step)
        B, S = self.global_batch, self.seq_len
        # Zipf over a capped alphabet
        ranks = rng.zipf(self.zipf_a, size=(B, S + 1)).astype(np.int64)
        toks = (ranks - 1) % self.vocab_size
        # document boundaries: BOS token 0 every ~doc_len
        bos = rng.random((B, S + 1)) < (1.0 / self.doc_len)
        toks = np.where(bos, 0, toks).astype(np.int32)
        return {"tokens": toks[:, :S], "labels": toks[:, 1:]}

    def torch_batch(self, step: int, device="cpu") -> dict[str, torch.Tensor]:
        """``batch(step)`` as int32 tensors on ``device``."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.batch(step).items()}
