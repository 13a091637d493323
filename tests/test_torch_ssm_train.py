"""Training the ssm (mamba2) and hybrid (hymba) families in the port
against the reference, on the CPU.

- ``ops.SSDChunkScan``, the SSD scan with a backward (on the card its
  forward is the kernel; its backward recomputes the plain scan and takes
  its vector-Jacobian product): its gradients, run here with the plain
  forward, against ``jax.grad`` of the reference's ``ssd_chunked`` on
  seeded float32 inputs within 1e-5 of each gradient's largest entry (the
  same float32 products summed in another order), and bit-equal to
  autograd through ``ref.ssd_chunk_scan``.  ``ops.ssd_chunk_scan`` takes
  ``SSDChunkScan`` on either device, so this is the port's CPU path.
- The reduced mamba2 and hymba (2 layers, d 64, 4 SSM heads of 8, state
  16, chunk 8) at equal weights: the training forward, the loss and every
  gradient, and three ``build_train_step`` steps, in float32 activations
  at ``tests/test_torch_lm_train.py``'s float32 tolerances (logits 1e-4,
  loss 1e-5, each gradient 2e-4 of its leaf's largest entry; metrics 1e-5
  relative, moments 1e-4 of each leaf's largest entry, parameters within
  5 % of the learning rates' sum but for 0.1 % of them).
- The reference's ``test_loss_decreases`` for both archs.
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
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train.steps import build_train_step as jbuild_train_step
from repro_torch import kernels
from repro_torch.convert import lm_opt_state_from_jax, lm_params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer
from repro_torch.models.params import tree_leaves
from repro_torch.models.registry import get_config
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train.steps import (CE_IMPLS, build_train_step,
                                     init_train_state)

SCAN_GRAD_TOL = 1e-5     # of each gradient's largest |entry|
TOLS = dict(logits=1e-4, loss=1e-5, grad=2e-4)
# (b, s, h, p, g, n, chunk): one group, two groups, a single chunk
SCAN_CASES = [(2, 32, 4, 8, 1, 16, 8), (1, 48, 6, 4, 2, 8, 16),
              (2, 16, 2, 8, 1, 4, 16)]
CASES = [("mamba2-370m", "chunked"), ("hymba-1.5b", "chunked"),
         ("hymba-1.5b", "flash")]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's plain PyTorch runs: the suite
    runs in parallel worker processes that share the CPU with the
    reference's spawned storage servers, and these runs gain little from
    more threads at the reduced widths."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scan_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, h))) * 0.1).astype(np.float32)
    A = -np.abs(rng.normal(size=(h,))).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    gy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    gs = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return (x, dt, A, B, C), gy, gs


def _leaves(args):
    return [torch.from_numpy(a).requires_grad_() for a in args]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_gradients_match_jax_grad(case):
    *shape, chunk = case
    args, gy, gs = _scan_inputs(sum(case), *shape)

    def loss(*a):
        y, st = jssd_chunked(*a, chunk=chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    leaves = _leaves(args)
    kernels.reset_launches()
    y, st = ops.SSDChunkScan.apply(*leaves, chunk)
    got = torch.autograd.grad((y, st), leaves, (torch.from_numpy(gy),
                                                torch.from_numpy(gs)))
    assert not any(kernels.LAUNCHES.values())
    for name, g, w in zip("x dt A B C".split(), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=SCAN_GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("use_state", [True, False])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_function_is_autograd_of_the_plain_scan(case, use_state):
    """On CPU tensors ``SSDChunkScan`` (the plain forward, then the
    recompute-and-VJP backward) gives autograd's gradients through
    ``ref.ssd_chunk_scan`` bit for bit, with the final state's gradient
    given or not (an unused output's gradient counts as zeros)."""
    *shape, chunk = case
    args, gy, gs = _scan_inputs(3, *shape)
    grads = []
    for fn in (lambda *a: ops.SSDChunkScan.apply(*a, chunk),
               lambda *a: ref.ssd_chunk_scan(*a, chunk=chunk)):
        leaves = _leaves(args)
        y, st = fn(*leaves)
        total = (y * torch.from_numpy(gy)).sum()
        if use_state:
            total = total + (st * torch.from_numpy(gs)).sum()
        grads.append(torch.autograd.grad(total, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_dispatcher_pads_outside_the_function():
    """``ops.ssd_chunk_scan`` over a sequence padded to a chunk multiple
    stays differentiable: the padding's gradient is autograd's (on the
    CPU the plain scan), equal to the gradient of the same scan of the
    unpadded length at a chunk that divides it."""
    args, gy, _ = _scan_inputs(9, 1, 20, 2, 4, 1, 8)
    grads = []
    for chunk in (16, 20):
        leaves = _leaves(args)
        y, _ = ops.ssd_chunk_scan(*leaves, chunk=chunk)
        assert y.shape == (1, 20, 2, 4)
        grads.append(torch.autograd.grad((y * torch.from_numpy(gy)).sum(),
                                         leaves))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=SCAN_GRAD_TOL * b.abs().max().item())


def _configs(arch, impl):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), attn_impl=impl)
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl=impl)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture
def float32_activations(monkeypatch):
    monkeypatch.setattr(jtransformer, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(transformer, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("arch,impl", CASES)
def test_forward_loss_and_every_gradient(arch, impl, float32_activations,
                                         host_mesh, rules):
    jcfg, cfg = _configs(arch, impl)
    jmodel = jtransformer.LM(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    batch = jmake_batch(jcfg, 2, 32, kind="train")

    def loss_fn(p):
        logits, _ = jmodel.forward(p, batch, host_mesh, rules)
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        ll = jnp.take_along_axis(logits, batch["labels"][..., None],
                                 axis=-1)[..., 0]
        return jnp.mean(lse - ll), logits

    with host_mesh:
        (jloss, jlogits), jgrads = jax.value_and_grad(
            loss_fn, has_aux=True)(jparams)
    model = transformer.LM(cfg, lm_params_from_jax(jax.device_get(jparams)),
                           device="cpu", trainable=True)
    tb = _torch_batch(batch)
    logits, _ = model(tb)
    loss = CE_IMPLS["gather"](logits, tb["labels"])
    grads = torch.autograd.grad(loss, tree_leaves(model.param_tree()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=TOLS["logits"], rtol=0)
    assert abs(float(loss.detach()) - float(jloss)) <= TOLS["loss"]
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    jgrads = jax.tree.leaves(jgrads)
    assert len(grads) == len(jgrads) == len(names)
    for name, g, w in zip(names, grads, jgrads):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOLS["grad"] * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("arch,impl", CASES)
def test_three_train_steps_match_reference(arch, impl, float32_activations,
                                           host_mesh, rules):
    """``build_train_step`` against the reference's, float32 activations,
    through the checkpointed blocks (``remat="full"``): AdamW on
    ``warmup_cosine(1e-3, 10, 50)``, three batches of 4 x 32."""
    jcfg, cfg = _configs(arch, impl)
    assert cfg.remat == "full"
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
    step = build_train_step(model, opt)
    with host_mesh:
        jstep = jax.jit(jbuild_train_step(jmodel, jopt, host_mesh, rules))
        for i in range(3):
            batch = jmake_batch(jcfg, 4, 32, seed=i, kind="train")
            jstate, jm = jstep(jstate, batch)
            state, m = step(state, _torch_batch(batch))
            for k in ("loss", "moe_aux", "grad_norm", "lr"):
                assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                    abs=1e-7), (i, k)
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


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_loss_decreases(arch):
    """The reference's ``test_loss_decreases`` for the ssm and hybrid
    families: 12 AdamW steps at 3e-3 on one batch of 4 x 32 memorize it
    (loss down by 10 %), with no kernel launch on the CPU."""
    cfg = get_config(arch).reduced()
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
