"""The port's gradient compression (``repro_torch.optim.compression``)
against the reference's ``repro.optim.compression``: the reference's own
tests (``tests/test_compression.py``) on the port, and equal inputs
giving bit-equal wires: int8 ``q`` and ``scale``, top-k ``values`` and
``indices`` (ties among equal magnitudes included: the lower index
first, as ``lax.top_k``), the residuals, and ``wire_bytes``."""

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.optim.compression as jc
import torch
from repro_torch.optim.compression import (compress_int8, compress_topk,
                                           decompress_int8, decompress_topk,
                                           init_error, wire_bytes)


def _t(a):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}


def _j(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


@given(st.integers(0, 100), st.integers(4, 256))
@settings(max_examples=25, deadline=None)
def test_int8_bounded_error(seed, n):
    rng = np.random.default_rng(seed)
    g = {"w": torch.from_numpy(rng.standard_normal(n).astype(np.float32))}
    wire, err = compress_int8(g, init_error(g))
    rec = decompress_int8(wire)
    scale = float(g["w"].abs().max())
    assert float((rec["w"] - g["w"]).abs().max()) <= scale / 127 + 1e-6
    np.testing.assert_allclose(err["w"].numpy(),
                               (g["w"] - rec["w"]).numpy(), atol=1e-6)


def test_int8_wire_is_4x_smaller():
    g = {"w": torch.ones(1024)}
    wire, _ = compress_int8(g, init_error(g))
    assert wire_bytes(wire) < 1024 * 4 / 3.5


def test_topk_sparsity_and_feedback():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((32, 32))
                               .astype(np.float32))}
    wire, err = compress_topk(g, init_error(g), frac=0.1)
    rec = decompress_topk(wire)
    assert int((rec["w"] != 0).sum()) == int(0.1 * 1024)
    kept_min = float(rec["w"].abs()[rec["w"] != 0].min())
    assert kept_min >= float(err["w"].abs().max()) - 1e-6


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_error_feedback_converges(scheme):
    target = torch.from_numpy(np.linspace(-2, 2, 64).astype(np.float32))
    x = {"w": torch.zeros(64)}
    err = init_error(x)
    for _ in range(600):
        g = {"w": x["w"] - target}
        if scheme == "int8":
            wire, err = compress_int8(g, err)
            g = decompress_int8(wire)
        else:
            wire, err = compress_topk(g, err, frac=0.1)
            g = decompress_topk(wire)
        x = {"w": x["w"] - 0.05 * g["w"]}
    assert float((x["w"] - target).abs().max()) < 0.05


def _grads(seed):
    """A nested tree with a 3-d leaf, a leaf whose entries tie in
    magnitude (a run of equal values and signs flipped) and an all-zero
    leaf."""
    rng = np.random.default_rng(seed)
    ties = np.repeat(rng.standard_normal(6).astype(np.float32), 7)
    ties *= rng.choice([-1, 1], size=ties.shape).astype(np.float32)
    return {"a": {"w": rng.standard_normal((4, 5, 6)).astype(np.float32)},
            "b": ties.reshape(6, 7), "z": np.zeros((3, 3), np.float32)}


def _leaves(tree, key):
    if isinstance(tree, dict) and key not in tree:
        return [x for k in sorted(tree) for x in _leaves(tree[k], key)]
    return [tree]


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in _flat(v).items()})
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_int8_bit_equal_to_the_reference_over_error_feedback(seed):
    """Three steps of error feedback from equal gradients: ``q``,
    ``scale``, the residuals and the decompressed gradients bit-equal;
    ``wire_bytes`` equal."""
    g = _flat(_grads(seed))
    err, jerr = init_error(_t(g)), jc.init_error(_j(g))
    for step in range(3):
        gs = {k: v * (step + 1) for k, v in g.items()}
        wire, err = compress_int8(_t(gs), err)
        jwire, jerr = jc.compress_int8(_j(gs), jerr)
        for k in g:
            np.testing.assert_array_equal(wire[k]["q"].numpy(),
                                          np.asarray(jwire[k]["q"]))
            assert wire[k]["q"].dtype == torch.int8
            assert wire[k]["scale"].numpy().tobytes() == \
                np.asarray(jwire[k]["scale"]).tobytes()
            np.testing.assert_array_equal(err[k].numpy(),
                                          np.asarray(jerr[k]))
        rec, jrec = decompress_int8(wire), jc.decompress_int8(jwire)
        for k in g:
            np.testing.assert_array_equal(rec[k].numpy(),
                                          np.asarray(jrec[k]))
        assert wire_bytes(wire) == jc.wire_bytes(jwire)


@pytest.mark.parametrize("frac", [0.05, 0.3])
def test_topk_bit_equal_to_the_reference_with_ties(frac):
    """Top-k over nested trees, three steps of error feedback (the
    residuals' zeros tie after the first): ``values``, ``indices`` (in
    ``lax.top_k``'s order), ``shape``, the residuals and the
    decompressed gradients bit-equal; ``wire_bytes`` equal (the
    ``shape`` tuple counts nothing)."""
    g = _grads(1)
    tg = {"a": _t(g["a"]), "b": torch.from_numpy(g["b"]),
          "z": torch.from_numpy(g["z"])}
    jg = {"a": _j(g["a"]), "b": jnp.asarray(g["b"]), "z": jnp.asarray(g["z"])}
    err, jerr = init_error(tg), jc.init_error(jg)
    for _ in range(3):
        wire, err = compress_topk(tg, err, frac=frac)
        jwire, jerr = jc.compress_topk(jg, jerr, frac=frac)
        for w, jw in zip(_leaves(wire, "values"), _leaves(jwire, "values")):
            np.testing.assert_array_equal(w["indices"].numpy(),
                                          np.asarray(jw["indices"]))
            assert w["indices"].dtype == torch.int32
            np.testing.assert_array_equal(w["values"].numpy(),
                                          np.asarray(jw["values"]))
            assert w["shape"] == tuple(jw["shape"])
        for e, je in zip(_leaves(err, None), _leaves(jerr, None)):
            np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        assert wire_bytes(wire) == jc.wire_bytes(jwire)
        for r, jr in zip(_leaves(decompress_topk(wire), None),
                         _leaves(jc.decompress_topk(jwire), None)):
            np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
