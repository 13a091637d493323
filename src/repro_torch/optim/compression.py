"""Gradient compression with error feedback, on trees of tensors.

The port of the reference's ``repro/optim/compression.py``.  Two schemes,
both with error feedback (the residual of the lossy step is added back
into the next step's gradient):

* ``int8``: per-tensor symmetric quantization, ``scale = max|x| / 127 +
  1e-12`` in float32 and ``q = clip(round(x / scale), -127, 127)`` with
  round-half-to-even (``torch.round``, as ``jnp.round``);
* ``topk``: the ``frac`` largest entries by magnitude per tensor, taken
  from a stable descending sort of ``|x|`` so that, as ``lax.top_k``
  does, the lower index comes first among equal magnitudes (after a step
  of error feedback the residual holds many zeros that tie).

Trees are nested dicts of tensors; ``init_error(params)`` gives the
residual tree, ``compress_*(grads, err)`` -> ``(wire, new_err)``,
``decompress_*(wire)`` -> grads.  A top-k wire leaf is a dict of
``values``, ``indices`` (int32) and ``shape`` (a tuple of Python ints,
which ``wire_bytes`` does not count, as the reference's skips it).
Nothing in the port calls this module; it is a library, as the
reference's is.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.params import tree_map


def _map(fn, tree, key: str | None = None):
    """``fn`` over the leaves of a nested dict, a dict holding ``key``
    (a wire leaf) counting as a leaf."""
    if isinstance(tree, dict) and not (key and key in tree):
        return {k: _map(fn, v, key) for k, v in tree.items()}
    return fn(tree)


def _zip2(fn, a, b):
    """``fn(x, y)`` over two trees of the same structure -> (tree of
    first results, tree of second results)."""
    if isinstance(a, dict):
        pairs = {k: _zip2(fn, a[k], b[k]) for k in a}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return fn(a, b)


def init_error(params) -> dict:
    """A float32 zero residual for every leaf of ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


# ---------------------------------------------------------------------------
# int8 symmetric quantization
# ---------------------------------------------------------------------------

def _q8(x):
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _dq8(w):
    return w["q"].to(torch.float32) * w["scale"]


def compress_int8(grads, err):
    """-> (wire tree of {q, scale}, new error residuals)."""
    def one(g, e):
        x = g.to(torch.float32) + e
        w = _q8(x)
        return w, x - _dq8(w)
    return _zip2(one, grads, err)


def decompress_int8(wire):
    return _map(_dq8, wire, "q")


# ---------------------------------------------------------------------------
# top-k sparsification
# ---------------------------------------------------------------------------

def compress_topk(grads, err, *, frac: float = 0.05):
    """Keep the top ``frac`` entries by magnitude per tensor."""
    def one(g, e):
        x = (g.to(torch.float32) + e).reshape(-1)
        k = max(1, int(frac * x.numel()))
        # lax.top_k's order: largest first, the lower index among ties
        idx = torch.sort(torch.abs(x), descending=True, stable=True)[1][:k]
        kept = x[idx]
        resid = x.clone()
        resid[idx] = 0.0
        return ({"values": kept, "indices": idx.to(torch.int32),
                 "shape": tuple(g.shape)}, resid.reshape(g.shape))
    return _zip2(one, grads, err)


def decompress_topk(wire):
    def one(w):
        out = torch.zeros(math.prod(w["shape"]), dtype=torch.float32,
                          device=w["values"].device)
        out[w["indices"].long()] = w["values"]
        return out.reshape(w["shape"])
    return _map(one, wire, "values")


def wire_bytes(wire) -> int:
    """Bytes a wire tree puts on the link: its tensor leaves' bytes (a
    top-k leaf's ``shape`` of Python ints counts nothing)."""
    if isinstance(wire, dict):
        return sum(wire_bytes(v) for v in wire.values())
    if isinstance(wire, torch.Tensor):
        return wire.numel() * wire.element_size()
    return 0
