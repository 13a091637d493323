"""Synthetic LM token pipeline: deterministic, restart-safe.

A copy of the reference's ``repro/data/tokens.py`` (numpy only): every
batch is a pure function of (seed, step), drawn with the same
``np.random.default_rng((seed, step))`` calls in the same order, so the
batches are bit-equal to the reference's.  Sequences are Zipf-distributed
token streams with document boundaries, enough structure for the loss to
move in a short run.

On a process mesh each rank builds the global batch from the seed and
keeps its rows (``rank_rows``): the reference shards the batch's rows
over the ``data`` axis, and with ``microbatches > 1`` it first reshapes
the global batch to ``(microbatches, B / microbatches)`` and shards the
second dim, so rank ``r``'s microbatch ``j`` is global rows ``j * B / mb
+ r * B / (mb * D)`` onward, not a contiguous block of the batch.

The reference trains wherever the ``D`` data ranks and the ``mb``
microbatches each divide ``B``.  Where ``D`` does not divide a
microbatch's ``m = B / mb`` rows, several microbatches run side by side
(``microbatch_layout``): ``q = gcd(D, m)`` ranks share one microbatch,
``c = D / q`` microbatches run at once, and each rank runs ``mb / c``
passes of ``m / q`` rows.  Where ``D`` divides ``m`` (``q = D``, ``c =
1``) these are the rows above.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

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

    def torch_batch(self, step: int, device="cpu", *, rank: int = 0,
                    ranks: int = 1, microbatches: int = 1
                    ) -> dict[str, torch.Tensor]:
        """``batch(step)`` as int32 tensors on ``device``: the rows of
        ``rank`` of ``ranks`` on the ``data`` axis (``rank_rows``), all
        of them by default."""
        rows = rank_rows(self.global_batch, rank, ranks, microbatches)
        return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
                for k, v in self.batch(step).items()}


class Layout(NamedTuple):
    """How each of ``D`` data ranks takes its share of a global batch's
    microbatches (``microbatch_layout``)."""
    share: int      # q: the data ranks that share one microbatch
    side: int       # c = D / q: the microbatches that run side by side
    passes: int     # mb / c: a rank's passes
    rows: int       # m / q: a rank's rows in a pass


def microbatch_layout(batch: int, microbatches: int, ranks: int) -> Layout:
    """The layout of a ``batch`` of rows in ``microbatches`` microbatches
    over ``ranks`` data ranks (the module docstring); ``ValueError``,
    naming which, unless the ranks and the microbatches each divide the
    batch, as the reference needs."""
    if batch % ranks:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"{ranks} data ranks")
    if batch % microbatches:
        raise ValueError(f"a batch of {batch} rows does not split into "
                         f"{microbatches} microbatches")
    m = batch // microbatches
    q = math.gcd(ranks, m)
    c = ranks // q
    # c divides mb: D divides mb * m, and D / q is prime to m / q
    return Layout(q, c, microbatches // c, m // q)


def rank_rows(batch: int, rank: int, ranks: int,
              microbatches: int = 1) -> np.ndarray:
    """The global batch rows that rank ``rank`` of ``ranks`` on the
    ``data`` axis holds, in the order its passes take them: rank ``s * q
    + t`` takes in pass ``i`` the ``m / q`` rows of microbatch ``j = i *
    c + s`` that start at row ``j * m + t * m / q``
    (``microbatch_layout``; where ``ranks`` divides ``m`` each pass is its
    share of one of the reference's microbatches).  ``ValueError`` where
    the layout refuses the batch."""
    lay = microbatch_layout(batch, microbatches, ranks)
    s, t = divmod(rank, lay.share)
    m = batch // microbatches
    return np.concatenate([
        np.arange(j * m + t * lay.rows, j * m + (t + 1) * lay.rows)
        for j in range(s, microbatches, lay.side)])
