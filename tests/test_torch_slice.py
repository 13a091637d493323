"""The port's main path as a whole against the reference's ``pallas``
backend: reddit, batch 8, fanouts (3, 2), hidden 16, seed 0.

Minibatches (targets, every hop's ids and features, labels) are
bit-equal.  From the reference's initial weights carried across, a
4-step loss trajectory through the port's ``build_train_step`` /
``train_loop`` matches within 1e-5 in float32 and 3e-2 in bfloat16 (the
frameworks round bf16 at different places).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.gnn as jgnn
from repro.core import build_train_step as jbuild_train_step
from repro.core import load_dataset as jload_dataset
from repro.core import make_loader
from repro.core import train_loop as jtrain_loop
from repro.optim import adamw as jadamw
from repro_torch.convert import params_from_jax
from repro_torch.core import (GNNConfig, GraphSAGE, PallasSubgraphLoader,
                              build_train_step, load_dataset, train_loop)
from repro_torch.optim import adamw

BATCH, FANOUTS, HIDDEN, SEED, STEPS, LR = 8, (3, 2), 16, 0, 4, 1e-2


@pytest.fixture(scope="module")
def loaders():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = make_loader("pallas", jload_dataset("reddit"), batch_size=BATCH,
                          fanouts=FANOUTS, seed=SEED)
    port = PallasSubgraphLoader(load_dataset("reddit"), batch_size=BATCH,
                                fanouts=FANOUTS, seed=SEED, device="cpu")
    yield ref, port
    ref.close()
    port.close()


@pytest.mark.parametrize("idx", range(4))
def test_minibatch_bit_equal_to_reference(loaders, idx):
    ref, port = loaders
    want, got = ref.get_batch(idx), port.get_batch(idx)
    np.testing.assert_array_equal(got.targets, np.asarray(want.targets))
    assert len(got.hop_ids) == len(want.hop_ids) == len(FANOUTS) + 1
    for g_ids, w_ids, g_f, w_f in zip(got.hop_ids, want.hop_ids,
                                      got.hop_feats, want.hop_feats):
        assert g_ids.dtype == torch.int32
        np.testing.assert_array_equal(g_ids.numpy(), np.asarray(w_ids))
        assert g_f.dtype == torch.float32
        np.testing.assert_array_equal(g_f.numpy(), np.asarray(w_f))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_loss_trajectory_matches_reference(loaders, dtype, tol, monkeypatch):
    ref, port = loaders
    monkeypatch.setattr(jgnn, "COMPUTE_DTYPE", getattr(jnp, dtype))
    g = port.g
    kw = dict(feat_dim=g.feat_dim, hidden=HIDDEN,
              n_classes=int(g.labels.max()) + 1, fanouts=FANOUTS)

    jmodel = jgnn.GraphSAGE(jgnn.GNNConfig(**kw))
    jopt = jadamw(LR)
    params = jmodel.init(jax.random.key(0))
    init = jax.device_get(params)
    jstate = {"params": params, "opt": jopt.init(params),
              "step": jnp.zeros((), jnp.int32)}
    want = []
    jtrain_loop(ref, jbuild_train_step(ref, jmodel, jopt), jstate,
                steps=STEPS,
                on_step=lambda i, s, m: want.append(float(m["loss"])))

    model = GraphSAGE(GNNConfig(**kw), device="cpu",
                      compute_dtype=getattr(torch, dtype))
    model.load_state_dict(params_from_jax(init))
    opt = adamw(LR)
    state = {"opt": opt.init(dict(model.named_parameters())), "step": 0}
    got = []
    state, stats = train_loop(
        port, build_train_step(port, model, opt), state, steps=STEPS,
        on_step=lambda i, s, m: got.append(float(m["loss"])))
    assert state["step"] == STEPS and stats.steps == STEPS
    assert 0.0 <= stats.idle_fraction <= 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
