"""The port's MoE family against the reference's, on the CPU.

``models/moe.py`` ``apply_moe`` is held against ``repro.models.moe``'s on
the same inputs: its integer outputs bit-equal (the expert ids, each
assignment's position in its expert, the (G, E, C) slot table), read off
the reference's own run by a recording stand-in for its ``jnp`` and
``jax.lax.top_k``; its output within 1e-5 in float32 and 2e-2 in bf16
(one or two bf16 ulps: the two frameworks round the expert products'
activations at different places), the aux loss within 1e-6.

The reduced mixtral-8x7b and moonshot-v1-16b-a3b (2 layers, d 64, 4
experts, top 2; softmax and sigmoid routing) at equal weights
(``convert.lm_params_from_jax``).  In float32 activations they run the
same arithmetic in another order: the training forward's logits, aux
loss and every gradient within ``test_torch_lm_train.py``'s float32
tolerances, one ``build_train_step`` step's metrics within 1e-5 relative
(the grad norm 1e-4), prefill and greedy decode (at the reference's
decode capacity factor, ``max(2, capacity_factor)``) with equal ids and
logits within 1e-4.  In bf16, as trained and served, the router reads
activations that the two frameworks round apart, and a near-tie that
rounding flips moves a token's output by O(1): the greedy ids are equal,
the prefill's logits within 0.125, and every logit, aux loss and
gradient lies no farther from the reference's bf16 run than the
reference's own bf16 run lies from its float32 one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro.models.transformer as jtransformer
from repro.launch.shapes import make_batch as jmake_batch
from repro.models.registry import get_config as jget_config
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.train.steps import build_prefill_step as jbuild_prefill
from repro.train.steps import build_serve_step as jbuild_serve
from repro.train.steps import build_train_step as jbuild_train_step
from repro_torch import kernels
from repro_torch.convert import lm_opt_state_from_jax, lm_params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.shapes import make_batch
from repro_torch.models import moe, transformer
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.registry import get_config
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train.steps import (MOE_AUX_WEIGHT, build_prefill_step,
                                     build_serve_step, build_train_step,
                                     cross_entropy, init_train_state)

ARCHS = ("mixtral-8x7b", "moonshot-v1-16b-a3b")
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
LOGIT_TOL = 0.125
TRAIN_TOLS = {"float32": dict(logits=1e-4, loss=1e-5, grad=2e-4),
              "bfloat16": dict(logits=0.125, loss=5e-3, grad=0.15)}
GEN = 6


class _Stand:
    """A module whose attributes are ``base``'s except those given."""

    def __init__(self, base, **over):
        self._base = base
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _reference_moe(p, x, **kw):
    """The reference's ``apply_moe`` (jitted) and its routing, recorded as
    it traces and returned beside its output: ``lax.top_k``'s expert
    ids; ``take_along_axis``'s first call gathers
    the position at each assignment's expert, its second the token rows
    at the clamped slot table; ``where``'s third call masks them by the
    slot table's validity (the sentinel Tg where it is False)."""
    taken, wheres, top = [], [], {}

    def take_along_axis(a, idx, axis):
        out = jnp.take_along_axis(a, idx, axis=axis)
        taken.append((idx, out))
        return out

    def where(cond, *a):
        wheres.append(cond)
        return jnp.where(cond, *a)

    def top_k(v, k):
        top["out"] = jax.lax.top_k(v, k)
        return top["out"]

    def run(p, x):
        out, aux = jmoe.apply_moe(p, x, **kw)
        (_, pos), (rows, _) = taken[:2]
        return out, aux["moe_aux_loss"], pos, rows, wheres[2], top["out"][1]

    saved = jmoe.jnp, jmoe.jax
    jmoe.jnp = _Stand(jnp, take_along_axis=take_along_axis, where=where)
    jmoe.jax = _Stand(jax, lax=_Stand(jax.lax, top_k=top_k))
    try:
        out, aux, pos, rows, valid, expert_idx = jax.jit(run)(p, x)
    finally:
        jmoe.jnp, jmoe.jax = saved
    G, E = pos.shape[0], p["router"].shape[-1]
    Tg = x.shape[0] * x.shape[1] // G
    slot_tok = np.where(np.asarray(valid)[..., 0],
                        np.asarray(rows)[..., 0].reshape(G, E, -1), Tg)
    return (np.asarray(out, np.float32), float(aux),
            {"expert_idx": np.asarray(expert_idx),
             "pos": np.asarray(pos)[..., 0], "slot_tok": slot_tok})


def _moe_inputs(E, d, f, B, S, seed):
    rs = np.random.default_rng(seed)
    p = {"router": rs.standard_normal((d, E)) / 8,
         "w_gate": rs.standard_normal((E, d, f)) / 8,
         "w_up": rs.standard_normal((E, d, f)) / 8,
         "w_down": rs.standard_normal((E, f, d)) / 6}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, rs.standard_normal((B, S, d)).astype(np.float32)


# (routing, E, top_k, B, S, groups, capacity_factor): mixtral's and
# moonshot's routings at training capacity over 1 and 2 groups, and at the
# decode capacity (one token a row: C = 1 for moonshot's 8 x 6 / 64)
MOE_CASES = [(r, E, k, 2, 16, g, 1.25)
             for r, E, k in (("softmax", 8, 2), ("sigmoid", 64, 6))
             for g in (1, 2)] + [("softmax", 8, 2, 8, 1, 1, 2.0),
                                 ("sigmoid", 64, 6, 8, 1, 1, 2.0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routing,E,top_k,B,S,groups,cf", MOE_CASES)
def test_apply_moe_matches_the_reference(routing, E, top_k, B, S, groups,
                                         cf, dtype):
    p, x = _moe_inputs(E, 64, 32, B, S, seed=E + groups)
    kw = dict(top_k=top_k, routing=routing, groups=groups,
              capacity_factor=cf)
    want, want_aux, route = _reference_moe(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x).astype(getattr(jnp, dtype)), **kw)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got, aux = moe.apply_moe(tp, tx, **kw)
    r = moe.route(tp["router"], tx, **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    for name in ("expert_idx", "pos", "slot_tok"):
        np.testing.assert_array_equal(getattr(r, name).numpy(), route[name],
                                      err_msg=name)
    G = groups if B * S % groups == 0 else 1
    C = moe.capacity(cf, top_k, B * S // G, E)
    assert r.slot_tok.shape == (G, E, C)
    assert torch.equal(r.keep, r.pos < C) and float(r.aux) == float(
        aux["moe_aux_loss"])
    if cf == 2.0 and routing == "sigmoid":
        assert C == 1 and not bool(r.keep.all())  # decode drops
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=MOE_TOL[dtype])
    assert abs(float(aux["moe_aux_loss"]) - want_aux) <= AUX_TOL


def test_convert_carries_the_moe_leaves():
    """``lm_params_from_jax`` copies the router and the expert weights,
    shapes and values, into the port's tree."""
    cfg = jget_config("moonshot-v1-16b-a3b").reduced()
    jparams = jax.device_get(jax.jit(jtransformer.LM(cfg).init)(
        jax.random.key(0)))
    got = lm_params_from_jax(jparams)
    for name in ("router", "w_gate", "w_up", "w_down"):
        want = np.asarray(jparams["blocks"][name])
        assert got["blocks"][name].dtype == torch.float32
        np.testing.assert_array_equal(got["blocks"][name].numpy(), want)
    assert got["blocks"]["w_gate"].shape == (2, 4, 64, 64)


def _configs(arch):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.fixture
def compute_dtype(monkeypatch):
    """Set both packages' activation dtype (float32 or bf16) for a test."""
    def set_to(name):
        monkeypatch.setattr(jtransformer, "COMPUTE_DTYPE",
                            getattr(jnp, name))
        monkeypatch.setattr(transformer, "COMPUTE_DTYPE",
                            getattr(torch, name))
    return set_to


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _reference_forward(jcfg, jparams, batch, host_mesh, rules):
    """The reference's logits, summed aux loss and the gradients of
    ``loss + MOE_AUX_WEIGHT * aux`` (what its train step
    differentiates)."""
    jmodel = jtransformer.LM(jcfg)

    def loss_fn(p):
        logits, aux = jmodel.forward(p, batch, host_mesh, rules)
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        ll = jnp.take_along_axis(logits, batch["labels"][..., None],
                                 axis=-1)[..., 0]
        return jnp.mean(lse - ll) + MOE_AUX_WEIGHT * aux["moe_aux_loss"], (
            logits, aux["moe_aux_loss"])

    with host_mesh:
        (_, (logits, aux)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(jparams)
    return (np.asarray(logits), float(aux),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _port_forward(cfg, jparams, batch):
    model = transformer.LM(cfg, lm_params_from_jax(jax.device_get(jparams)),
                           device="cpu", trainable=True)
    tb = _torch_batch(batch)
    logits, aux = model(tb)
    aux = aux["moe_aux_loss"]
    total = cross_entropy(logits, tb["labels"]) + MOE_AUX_WEIGHT * aux
    grads = torch.autograd.grad(total, tree_leaves(model.param_tree()))
    return (logits.detach().numpy(), float(aux.detach()),
            [g.numpy() for g in grads])


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_and_every_gradient(arch, compute_dtype, host_mesh,
                                        rules):
    """The training forward's logits and summed aux loss, and every
    gradient of ``loss + MOE_AUX_WEIGHT * aux``.  In float32 activations
    within ``test_torch_lm_train.py``'s float32 tolerances (the aux loss
    within the loss's).  In bf16, as trained, each of them no farther from
    the reference's bf16 run than the reference's own bf16 run lies from
    its float32 one: the router reads activations that bf16 rounds, and
    the rounding moves the MoE's gradients by up to a leaf's largest
    entry (more than the dense family's 0.15 of it), in both packages."""
    jcfg, cfg = _configs(arch)
    jparams = jtransformer.LM(jcfg).init(jax.random.key(0))
    batch = jmake_batch(jcfg, 2, 32, kind="train")
    runs = {}
    for dtype in ("float32", "bfloat16"):
        compute_dtype(dtype)
        runs[dtype] = (_reference_forward(jcfg, jparams, batch, host_mesh,
                                          rules),
                       _port_forward(cfg, jparams, batch))
    (want, got), tol = runs["float32"], TRAIN_TOLS["float32"]
    np.testing.assert_allclose(got[0], want[0], atol=tol["logits"], rtol=0)
    assert want[1] > 0 and abs(got[1] - want[1]) <= tol["loss"]
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert len(got[2]) == len(want[2]) == len(names)
    for name, g, w in zip(names, got[2], want[2]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol["grad"] * np.abs(w).max(),
                                   err_msg=name)
    want16, got16 = runs["bfloat16"]
    for i, what in ((0, "logits"), (1, "aux")):
        assert _dist(got16[i], want16[i]) <= _dist(want16[i], want[i]), what
    for name, g, w16, w32 in zip(names, got16[2], want16[2], want[2]):
        assert _dist(g, w16) <= _dist(w16, w32), name


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_metrics_match_the_reference(arch, compute_dtype,
                                                host_mesh, rules):
    """One ``build_train_step`` step, float32 activations, through the
    checkpointed blocks (``remat="full"``): loss, ``moe_aux`` (the aux
    term reaches the loss the step differentiates) and lr within 1e-5
    relative, the grad norm within 1e-4 (every leaf's gradient moves by
    ~2e-5 relative L2 in float32 sum order; the reference's own grad
    norm moves by 1.2e-5 between its jitted step and an eager
    ``value_and_grad``)."""
    compute_dtype("float32")
    jcfg, cfg = _configs(arch)
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
    batch = jmake_batch(jcfg, 4, 32, kind="train")
    with host_mesh:
        jstate, jm = jax.jit(jbuild_train_step(jmodel, jopt, host_mesh,
                                               rules))(jstate, batch)
    state, m = build_train_step(model, opt)(state, _torch_batch(batch))
    assert float(jm["moe_aux"]) > 0
    for k in ("loss", "moe_aux", "grad_norm", "lr"):
        rel = 1e-4 if k == "grad_norm" else 1e-5
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=rel,
                                            abs=1e-7), k


def _reference_serve(jcfg, jparams, B, S, host_mesh, rules, feed=None):
    """The reference's prefill and GEN greedy serve steps (fed ``feed``'s
    ids instead of its own picks when given): (ids, each step's
    logits)."""
    model = jtransformer.LM(jcfg)
    batch = jmake_batch(jcfg, B, S, kind="prefill")
    with host_mesh:
        prefill = jax.jit(jbuild_prefill(model, host_mesh, rules))
        serve = jax.jit(jbuild_serve(model, host_mesh, rules))
        logits, cache = prefill(jparams, batch)
        cache = jax.tree.map(
            lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, GEN)] + [(0, 0)] * 2),
            cache)
        tok = jnp.argmax(logits[:, -1, :], -1).astype(jnp.int32)[:, None]
        toks, step_logits = [tok], [np.asarray(logits)]
        for i in range(GEN):
            if feed is not None:
                tok = jnp.asarray(feed[:, i:i + 1])
            lg, cache, nxt = serve(jparams, tok, cache,
                                   jnp.asarray(S + i, jnp.int32))
            tok = nxt[:, None]
            toks.append(tok)
            step_logits.append(np.asarray(lg))
    return np.concatenate([np.asarray(t) for t in toks], 1), step_logits


def _port_serve(cfg, jparams, B, S):
    model = transformer.LM(cfg, lm_params_from_jax(jax.device_get(jparams)),
                           device="cpu")
    logits, cache = build_prefill_step(model, S + GEN)(
        make_batch(cfg, B, S, kind="prefill"))
    step = build_serve_step(model)
    tok = torch.argmax(logits[:, -1, :], -1).to(torch.int32)[:, None]
    toks, step_logits = [tok], [logits.numpy()]
    for i in range(GEN):
        lg, cache, nxt = step(tok, cache, S + i)
        tok = nxt[:, None]
        toks.append(tok)
        step_logits.append(lg.numpy())
    return torch.cat(toks, 1).numpy(), step_logits


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_the_reference(arch, compute_dtype,
                                                       host_mesh, rules):
    """Prefill and GEN greedy steps (decode at capacity factor 2, as the
    reference's).  In float32 activations: ids equal, every step's
    logits within 1e-4.  In bf16, as served: ids equal, the prefill's
    logits within LOGIT_TOL (4 bf16 ulps at |logit| < 8), and every
    step's logits no farther from the reference's bf16 run than that run
    lies from the reference's float32 run fed the same ids (a near-tie
    that bf16 rounding flips moves a token's output by O(1), in either
    package)."""
    jcfg, cfg = _configs(arch)
    jparams = jtransformer.LM(jcfg).init(jax.random.key(0))
    B, S = 2, 16
    compute_dtype("bfloat16")
    ids16, want16 = _reference_serve(jcfg, jparams, B, S, host_mesh, rules)
    got_ids, got16 = _port_serve(cfg, jparams, B, S)
    compute_dtype("float32")
    ids32, want32 = _reference_serve(jcfg, jparams, B, S, host_mesh, rules)
    got_ids32, got32 = _port_serve(cfg, jparams, B, S)
    _, want32_fed = _reference_serve(jcfg, jparams, B, S, host_mesh, rules,
                                     feed=ids16[:, :GEN])
    np.testing.assert_array_equal(got_ids32, ids32)
    for a, b in zip(got32, want32):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got_ids, ids16)
    np.testing.assert_allclose(got16[0], want16[0], atol=LOGIT_TOL, rtol=0)
    spread = max(_dist(a, b) for a, b in zip(want16, want32_fed))
    assert max(_dist(a, b) for a, b in zip(got16, want16)) <= spread


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's ``test_decode_matches_forward`` for the moe family:
    prefill(S-1) + one decode step against a prefill over all S tokens,
    within its 0.75 (decode's capacity drops other tokens than a
    16-token dispatch does)."""
    cfg = get_config(arch).reduced()
    model = transformer.LM(cfg, seed=0, device="cpu")
    S = 16
    tokens = make_batch(cfg, 2, S, kind="prefill")["tokens"]
    full, _ = model.prefill({"tokens": tokens})
    _, cache = model.prefill({"tokens": tokens[:, :S - 1]}, cache_len=S)
    dec, _ = model.decode_step(tokens[:, S - 1:], cache, S - 1)
    assert float((dec - full).abs().max()) < 0.75


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_full_configs(arch):
    cfg = get_config(arch)
    model = transformer.LM(cfg, tree_map(
        lambda d: torch.empty(d.shape, device="meta"),
        transformer.build_defs(cfg)))
    assert model.active_param_count() == \
        jtransformer.LM(jget_config(arch)).active_param_count()
    assert model.active_param_count() < sum(
        t.numel() for t in tree_leaves(model.param_tree()))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_decreases(arch):
    """The reference's ``test_loss_decreases`` for the moe family: 12
    AdamW steps at 3e-3 on one batch of 4 x 32 memorize it (loss down by
    10 %), with no kernel launch on the CPU."""
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
        assert float(m["moe_aux"]) > 0
    assert losses[-1] < losses[0] * 0.9, losses
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_moe_archs(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <moe> --device cpu``
    serves the reduced config from the reference's seed-0 weights."""
    out = serve_cli.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                          "--prompt-len", "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 4) and out["init_s"] >= 0
    assert bool(torch.isfinite(out["logits"]).all())
    assert "weights drawn in" in capsys.readouterr().out
