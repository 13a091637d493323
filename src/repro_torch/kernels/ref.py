"""Plain PyTorch versions of the port's kernels.

Each function is the specification its CUDA kernel must match, with the
reference's semantics (``repro/kernels/ref.py`` and the Pallas bodies).
The CPU path of ``kernels.ops`` runs these; on the card they serve only
as the comparison in ``chip_smoke.py``.
"""

from __future__ import annotations

import torch


def neighbor_sample(indptr, indices, targets, rand):
    """CSR fanout sampling with explicit randomness.

    indptr: (N+1,) int32; indices: (E,) int32; targets: (M,) int32;
    rand: (M, S) int32.  Returns (M, S) int32 with ``out[m, s] =
    indices[indptr[t] + rand[m, s] mod deg(t)]`` for ``t = targets[m]``
    (a floor-mod, as ``jnp`` takes it, and the position clamped to
    ``E - 1``); degree-0 targets sample themselves."""
    t = targets.long()
    start = indptr[t].long()
    deg = indptr[t + 1].long() - start
    r = torch.remainder(rand.long(), deg.clamp_min(1)[:, None])
    if indices.shape[0] == 0:
        picked = torch.zeros_like(r)
    else:
        picked = indices[(start[:, None] + r).clamp_max(indices.shape[0] - 1)]
    return torch.where(deg[:, None] > 0, picked.long(),
                       t[:, None]).to(torch.int32)


def feature_gather_mean(table, ids):
    """table: (N, F); ids: (M, K) int -> (M, F) fanout mean, accumulated
    in float32 as ``acc += row_k / K`` in k order (the Pallas body's
    order) and cast to the table's type."""
    K = ids.shape[1]
    acc = torch.zeros(ids.shape[0], table.shape[1], dtype=torch.float32,
                      device=table.device)
    for k in range(K):
        acc += table[ids[:, k].long()].float() / K
    return acc.to(table.dtype)


def feature_gather_rows(table, ids):
    """table: (N, F); ids: (R,) int -> (R, F), the exact row copy
    ``table[ids]`` (the K = 1 case of the mean)."""
    return table[ids.long()]
