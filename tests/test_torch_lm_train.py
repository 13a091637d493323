"""The port's LM training path against the reference's, on the CPU: the
reduced qwen2-0.5b (2 layers, d 64, 4 over 2 heads, head dim 16, vocab
256) at equal weights (``convert.lm_params_from_jax``), equal batches and
equal optimizer state (``convert.lm_opt_state_from_jax``).

The training forward and its gradients are compared twice:
- with both packages' ``COMPUTE_DTYPE`` set to float32, where they run
  the same arithmetic in another order: logits within 1e-4, the loss
  within 1e-5, every gradient within 2e-4 of its leaf's largest entry,
  and three optimizer steps' metrics within 1e-5 relative, moments
  within 1e-4 of each leaf's largest entry and parameters within 5 % of
  the learning rates' sum (all but the 0.1 % whose gradient is near 0);
- as trained, in bf16, where the two round their activations at
  different places (see ``test_torch_lm.py``): logits within 0.125 (4
  bf16 ulps at |logit| < 8), the loss within 5e-3, every gradient within
  0.15 of its leaf's largest entry (at random weights bf16 rounding moves
  the gradients of the query/key path by a large share of their size;
  ``test_bf16_moves_the_references_own_gradients`` shows the reference's
  own bf16 gradients further than 0.15 from its float32 ones, so the
  float32 comparison above is the one that pins the arithmetic).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtransformer
from repro.launch.shapes import make_batch as jmake_batch
from repro.models.registry import get_config as jget_config
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train.steps import CE_IMPLS as JCE_IMPLS
from repro.train.steps import build_train_step as jbuild_train_step
from repro_torch import kernels
from repro_torch.convert import lm_opt_state_from_jax, lm_params_from_jax
from repro_torch.models import attention, transformer
from repro_torch.models.registry import get_config
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.launch.shapes import make_batch
from repro_torch.models.params import tree_leaves
from repro_torch.models.registry import ARCH_IDS
from repro_torch.train.steps import (CE_IMPLS, MOE_AUX_WEIGHT,
                                     build_train_step, init_train_state)
from torch.utils.checkpoint import CheckpointPolicy

ARCH = "qwen2-0.5b"
B, S = 2, 32


def _configs(impl):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), attn_impl=impl)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), attn_impl=impl)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture
def compute_dtype(monkeypatch):
    """Set both packages' activation dtype (float32 or bf16) for a test."""
    def set_to(name):
        monkeypatch.setattr(jtransformer, "COMPUTE_DTYPE",
                            getattr(jnp, name))
        monkeypatch.setattr(transformer, "COMPUTE_DTYPE",
                            getattr(torch, name))
    return set_to


def _reference_loss_and_grads(jcfg, jparams, batch, host_mesh, rules):
    model = jtransformer.LM(jcfg)

    def loss_fn(p):
        logits, _ = model.forward(p, batch, host_mesh, rules)
        return JCE_IMPLS["gather"](logits, batch["labels"]), logits

    with host_mesh:
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jparams)
    return (float(loss), np.asarray(logits, np.float32),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _port_loss_and_grads(cfg, jparams, batch):
    model = transformer.LM(cfg, lm_params_from_jax(jax.device_get(jparams)),
                           device="cpu", trainable=True)
    tb = _torch_batch(batch)
    logits, aux = model(tb)
    assert logits.dtype == torch.float32 and float(aux["moe_aux_loss"]) == 0
    loss = CE_IMPLS["gather"](logits, tb["labels"])
    grads = torch.autograd.grad(loss, tree_leaves(model.param_tree()))
    return (float(loss.detach()), logits.detach().numpy(),
            [g.numpy() for g in grads])


TOLS = {"float32": dict(logits=1e-4, loss=1e-5, grad=2e-4),
        "bfloat16": dict(logits=0.125, loss=5e-3, grad=0.15)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_forward_loss_and_every_gradient(impl, dtype, compute_dtype,
                                         host_mesh, rules):
    compute_dtype(dtype)
    jcfg, cfg = _configs(impl)
    jparams = jtransformer.LM(jcfg).init(jax.random.key(0))
    batch = jmake_batch(jcfg, B, S, kind="train")
    want = _reference_loss_and_grads(jcfg, jparams, batch, host_mesh, rules)
    got = _port_loss_and_grads(cfg, jparams, batch)
    tol = TOLS[dtype]
    assert got[1].shape == want[1].shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got[1], want[1], atol=tol["logits"], rtol=0)
    assert abs(got[0] - want[0]) <= tol["loss"]
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert len(got[2]) == len(want[2]) == len(names)
    for name, g, w in zip(names, got[2], want[2]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol["grad"] * np.abs(w).max(),
                                   err_msg=name)


def test_bf16_moves_the_references_own_gradients(compute_dtype, host_mesh,
                                                 rules):
    """Why the bf16 gradient tolerance is loose: the reference's own bf16
    gradients lie further from its float32 ones than the 0.15 of a leaf's
    largest entry that the bf16 comparison allows."""
    jcfg, _ = _configs("chunked")
    jparams = jtransformer.LM(jcfg).init(jax.random.key(0))
    batch = jmake_batch(jcfg, B, S, kind="train")
    grads = {}
    for dtype in ("float32", "bfloat16"):
        compute_dtype(dtype)
        grads[dtype] = _reference_loss_and_grads(jcfg, jparams, batch,
                                                 host_mesh, rules)[2]
    worst = max(np.abs(a - b).max() / np.abs(b).max()
                for a, b in zip(grads["bfloat16"], grads["float32"]))
    assert worst > TOLS["bfloat16"]["grad"]


@pytest.mark.parametrize("microbatches,ce,impl",
                         [(1, "gather", "flash"), (2, "gather", "chunked"),
                          (1, "sharded", "chunked"), (2, "sharded", "flash")])
def test_three_train_steps_match_reference(microbatches, ce, impl,
                                           compute_dtype, host_mesh, rules):
    """``build_train_step`` against the reference's, float32 activations:
    AdamW on ``warmup_cosine(1e-3, 10, 50)``, three batches of 4."""
    compute_dtype("float32")
    jcfg, cfg = _configs(impl)
    jmodel = jtransformer.LM(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    jopt = jadamw(jwarmup_cosine(1e-3, 10, 50))
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    model = transformer.LM(cfg, lm_params_from_jax(jax.device_get(jparams)),
                           device="cpu", trainable=True)
    opt = adamw(warmup_cosine(1e-3, 10, 50))
    state = init_train_state(model, opt)
    state["opt"] = lm_opt_state_from_jax(jax.device_get(jstate["opt"]))
    step = build_train_step(model, opt, microbatches=microbatches, ce=ce)
    with host_mesh:
        jstep = jax.jit(jbuild_train_step(jmodel, jopt, host_mesh, rules,
                                          microbatches=microbatches, ce=ce))
        for i in range(3):
            batch = jmake_batch(jcfg, 4, S, seed=i, kind="train")
            jstate, jm = jstep(jstate, batch)
            state, m = step(state, _torch_batch(batch))
            assert set(m) == set(jm) == {"loss", "moe_aux", "grad_norm", "lr"}
            for k in m:
                assert isinstance(m[k], torch.Tensor)
                assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                    abs=1e-7), k
    assert state["step"] == 3 and state["params"]["embed"] is model.embed
    # Adam divides each entry's moment by its own scale, so an entry whose
    # gradient is near 0 (where the float32 sum order moves it by a large
    # fraction, or flips its sign) moves by another fraction of the step:
    # every parameter within Adam's bound of two learning rates' sum, all
    # but 0.1 % of them within 5 % of it; the moments within 1e-4 of each
    # leaf's largest entry
    lr_sum = sum(warmup_cosine(1e-3, 10, 50)(i) for i in range(3))
    for got, want in zip(tree_leaves(state["params"]),
                         jax.tree.leaves(jstate["params"])):
        diff = np.abs(got.detach().numpy() - np.asarray(want))
        assert diff.max() <= 2 * lr_sum
        assert np.mean(diff > 0.05 * lr_sum) <= 1e-3
    for name in ("m", "v"):
        for got, want in zip(tree_leaves(state["opt"][name]),
                             jax.tree.leaves(jstate["opt"][name])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())


def test_loss_decreases_on_a_fixed_batch():
    """The reference's ``test_loss_decreases`` for qwen2: 12 AdamW steps at
    3e-3 on one batch of 4 x 32 memorize it (loss down by 10 %), through
    the flash path's plain versions, with no kernel launch."""
    cfg = get_config(ARCH).reduced()
    assert cfg.attn_impl == "chunked"
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    model = transformer.LM(cfg, seed=2, device="cpu", trainable=True)
    opt = adamw(3e-3)
    state = init_train_state(model, opt)
    step = build_train_step(model, opt)
    batch = _torch_batch(jmake_batch(cfg, 4, 32, kind="train"))
    kernels.reset_launches()
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("remat,attn_remat", [("full", False),
                                               ("none", True),
                                               ("full", True)])
def test_remat_changes_no_gradient(remat, attn_remat):
    """``cfg.remat == "full"`` recomputes each block in the backward
    (``torch.utils.checkpoint``), ``attn_remat`` each KV step of the
    chunked path: the same gradients, bit for bit, as keeping the
    activations."""
    base = get_config(ARCH).reduced()
    batch = _torch_batch(jmake_batch(base, 2, 32, kind="train"))
    grads = []
    for cfg in (dataclasses.replace(base, remat="none"),
                dataclasses.replace(base, remat=remat,
                                    attn_remat=attn_remat)):
        model = transformer.LM(cfg, seed=1, device="cpu", trainable=True)
        logits, _ = model(batch)
        loss = CE_IMPLS["gather"](logits, batch["labels"])
        grads.append(torch.autograd.grad(loss, tree_leaves(
            model.param_tree())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_mha_chunked_remat_chunks_same_gradients():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    pos = torch.arange(32)
    grads = []
    for remat in (False, True):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = attention.mha_chunked(*leaves, q_positions=pos,
                                    k_positions=pos, window=5, chunk_q=8,
                                    chunk_k=8, remat_chunks=remat)
        grads.append(torch.autograd.grad(out.sin().sum(), leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_training_mode_slices_layers_in_the_graph():
    cfg = get_config(ARCH).reduced()
    train = transformer.LM(cfg, seed=0, device="cpu", trainable=True)
    serve = transformer.LM(cfg, seed=0, device="cpu")
    assert all(p.requires_grad for p in tree_leaves(train.param_tree()))
    assert not any(p.requires_grad for p in tree_leaves(serve.param_tree()))
    assert train._layers is None and len(serve._layers) == cfg.num_layers
    assert set(train.param_tree()) == {"embed", "final_norm", "blocks"}


def _dots_grads(arch: str, remat: str, seen=None):
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    batch = make_batch(cfg, 2, 32, seed=3, kind="train")
    model = transformer.LM(cfg, seed=1, device="cpu", trainable=True)
    logits, aux = model(batch)
    loss = CE_IMPLS["gather"](logits, batch["labels"]) \
        + MOE_AUX_WEIGHT * aux["moe_aux_loss"]
    return [g for g in torch.autograd.grad(
        loss, tree_leaves(model.param_tree()), allow_unused=True)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dots_policy_gradients_equal_full(arch):
    """``remat="dots"`` (the reference's ``checkpoint_dots_with_no_batch_
    dims``) trains every family: the same gradients, bit for bit, as
    ``remat="full"`` (both recompute what they do not keep; the values
    recomputed are the values kept)."""
    full, dots = _dots_grads(arch, "full"), _dots_grads(arch, "dots")
    assert len(full) == len(dots)
    for a, b in zip(full, dots):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_dots_policy_saves_the_no_batch_products(monkeypatch):
    """The products of a block and which way the policy takes each, as
    the reference's policy takes its ``dot_general``s (saved: no batch
    dims; recomputed: batch dims, or no product at all):

    - saved (``aten.mm``): the q, k, v and output projections and the
      three MLP products (``_proj``'s ``reshape @ reshape``), the moe
      family's router (``x @ router``), the ssm mixer's ``in_proj`` and
      ``out_proj``, the encdec decoder's cross-attention projections;
    - recomputed (``aten.bmm``): the chunked attention's score and value
      products (batched over batch and KV heads) and, on the CPU, the
      flash path's plain versions of the same; the moe family's expert
      products (``gecd,edf``: batched over experts); the SSD scan's
      products (batched over batch, chunks and heads);
    - recomputed, not products: norms, RoPE, activations, the MoE's
      routing and gathers, every cast of a weight to bf16.

    A reduced qwen2 block (chunked attention) saves 7 ``mm`` outputs a
    layer and recomputes its ``bmm``s; a moonshot block saves 5 (q, k, v,
    out, router) and recomputes its expert products."""
    seen = []
    real = transformer._dots_policy

    def spy(ctx, op, *args, **kwargs):
        decision = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((op, decision))
        return decision

    monkeypatch.setattr(transformer, "_dots_policy", spy)
    for arch, per_layer in (("qwen2-0.5b", 7), ("moonshot-v1-16b-a3b", 5)):
        seen.clear()
        _dots_grads(arch, "dots")
        layers = get_config(arch).reduced().num_layers
        saved = [op for op, d in seen if d == CheckpointPolicy.MUST_SAVE]
        assert set(saved) == {torch.ops.aten.mm.default}, arch
        assert len(saved) == per_layer * layers, (arch, len(saved))
        bmm = [d for op, d in seen if op == torch.ops.aten.bmm.default]
        assert bmm and set(bmm) == {CheckpointPolicy.PREFER_RECOMPUTE}


def test_dots_train_steps_match_reference(compute_dtype, host_mesh, rules):
    """Three ``build_train_step`` steps under ``remat="dots"`` against the
    reference's ``remat="dots"`` steps, float32 activations, within the
    tolerances of ``test_three_train_steps_match_reference``."""
    compute_dtype("float32")
    jcfg, cfg = (dataclasses.replace(c, remat="dots")
                 for c in _configs("flash"))
    jmodel = jtransformer.LM(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    jopt = jadamw(jwarmup_cosine(1e-3, 10, 50))
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    model = transformer.LM(cfg, lm_params_from_jax(jax.device_get(jparams)),
                           device="cpu", trainable=True)
    opt = adamw(warmup_cosine(1e-3, 10, 50))
    state = init_train_state(model, opt)
    step = build_train_step(model, opt)
    with host_mesh:
        jstep = jax.jit(jbuild_train_step(jmodel, jopt, host_mesh, rules))
        for i in range(3):
            batch = jmake_batch(jcfg, 4, S, seed=i, kind="train")
            jstate, jm = jstep(jstate, batch)
            state, m = step(state, _torch_batch(batch))
            for k in m:
                assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                    abs=1e-7), k
    lr_sum = sum(warmup_cosine(1e-3, 10, 50)(i) for i in range(3))
    for got, want in zip(tree_leaves(state["params"]),
                         jax.tree.leaves(jstate["params"])):
        diff = np.abs(got.detach().numpy() - np.asarray(want))
        assert diff.max() <= 2 * lr_sum
        assert np.mean(diff > 0.05 * lr_sum) <= 1e-3
