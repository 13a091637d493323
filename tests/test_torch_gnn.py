"""The port's GraphSAGE against the reference's: logits, loss and every
gradient from the same parameters and features.

float32 agrees within 1e-5 relative (the reference's compute type is set
to float32 at run time; no file changes).  bfloat16 agrees within 3e-2,
because the two frameworks round bf16 at different places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.gnn as jgnn
from repro_torch.convert import params_from_jax
from repro_torch.core import gnn

FANOUTS = (3, 2)
M, F, HIDDEN, CLASSES = 8, 24, 16, 5


def _inputs():
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((M,) + FANOUTS[:t] + (F,)).astype(np.float32)
             for t in range(len(FANOUTS) + 1)]
    labels = rng.integers(0, CLASSES, M).astype(np.int32)
    return feats, labels


@pytest.mark.parametrize("aggregator", ["mean", "pool"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_forward_loss_and_grads_match_reference(aggregator, dtype, tol,
                                                monkeypatch):
    monkeypatch.setattr(jgnn, "COMPUTE_DTYPE", getattr(jnp, dtype))
    kw = dict(feat_dim=F, hidden=HIDDEN, n_classes=CLASSES, fanouts=FANOUTS,
              aggregator=aggregator)
    jmodel = jgnn.GraphSAGE(jgnn.GNNConfig(**kw))
    params = jmodel.init(jax.random.key(0))
    feats, labels = _inputs()

    def loss_fn(p):
        return jgnn.gnn_loss_fn(jmodel, p, [jnp.asarray(f) for f in feats],
                                jnp.asarray(labels))

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    jlogits = jax.jit(jmodel.forward)(params, [jnp.asarray(f) for f in feats])

    model = gnn.GraphSAGE(gnn.GNNConfig(**kw), device="cpu",
                          compute_dtype=getattr(torch, dtype))
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    tfeats = [torch.from_numpy(f) for f in feats]
    logits = model(tfeats)
    assert logits.dtype == torch.float32
    loss, metrics = gnn.gnn_loss_fn(model, tfeats, torch.from_numpy(labels))
    loss.backward()

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   rtol=tol, atol=tol)

    close(logits.detach(), jlogits)
    close(loss.detach(), jloss)
    assert float(metrics["acc"]) == pytest.approx(float(jmetrics["acc"]))
    assert set(dict(model.named_parameters())) == set(jgrads)
    for name, p in model.named_parameters():
        close(p.grad, jgrads[name])


def test_init_scale_and_zero_biases():
    """Weights are N(0, 1/fan_in), biases zero, names as the reference."""
    cfg = gnn.GNNConfig(feat_dim=400, hidden=300, n_classes=7, fanouts=(2,))
    model = gnn.GraphSAGE(cfg, device="cpu")
    ref_names = set(jgnn.build_defs(jgnn.GNNConfig(
        feat_dim=400, hidden=300, n_classes=7, fanouts=(2,))))
    assert set(dict(model.named_parameters())) == ref_names
    with torch.no_grad():
        assert float(model.l0_self.std()) == pytest.approx(400 ** -0.5,
                                                           rel=0.02)
        assert float(model.cls.std()) == pytest.approx(300 ** -0.5, rel=0.05)
    assert not model.l0_bias.any() and not model.cls_bias.any()
