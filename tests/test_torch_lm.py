"""The port's dense LM and serve steps against the reference's, at equal
weights (carried over with ``convert.lm_params_from_jax``) and equal
prompts, on the CPU through the plain attention paths.

Integer outputs are bit-equal: prompt tokens and greedy ids.  Values
computed with arithmetic agree within stated tolerances: both packages run
bf16 activations, but round their activations at different places (XLA
computes ``silu`` as a bf16 ``logistic`` times x and the tanh gelu as a
chain of bf16 ops; PyTorch's ``F.silu`` and ``F.gelu`` round once), which
moves about a third of the MLP's bf16 activations by one ulp.  So each
layer's bf16 K/V cache agrees within 2 % of its largest entry (first
layer bit-equal in practice, one bf16 ulp at the largest entry later),
and the float32 logits (magnitude up to ~5) within 0.05 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.shapes import make_batch as jmake_batch
from repro.models.registry import ARCH_IDS as JARCH_IDS
from repro.models.registry import get_config as jget_config
from repro.models.transformer import LM as JLM
from repro.train.steps import build_prefill_step as jbuild_prefill
from repro.train.steps import build_serve_step as jbuild_serve
from repro_torch.convert import lm_cache_from_jax, lm_params_from_jax
from repro_torch.launch.shapes import make_batch
from repro_torch.models import transformer
from repro_torch.models.params import (cast_tree, count_params,
                                       init_params, tree_leaves)
from repro_torch.models.registry import ARCH_IDS, get_config
from repro_torch.train.steps import build_prefill_step, build_serve_step

LOGIT_TOL = 5e-2
CACHE_TOL = 0.02     # of each layer's largest |entry|
GEN = 8
CASES = [("qwen2-0.5b", "chunked"), ("qwen2-0.5b", "flash"),
         ("gemma3-1b", "chunked")]


def _configs(arch, impl):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), attn_impl=impl)
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl=impl)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _np(x):
    return np.asarray(x, np.float32)


def _reference_serve(jcfg, params, B, S, host_mesh, rules):
    """The reference's prefill + GEN greedy serve steps, as
    ``repro.launch.serve`` runs them."""
    model = JLM(jcfg)
    batch = jmake_batch(jcfg, B, S, kind="prefill")
    with host_mesh:
        prefill = jax.jit(jbuild_prefill(model, host_mesh, rules))
        serve = jax.jit(jbuild_serve(model, host_mesh, rules))
        logits, cache = prefill(params, batch)
        seed_cache = jax.device_get(cache)
        cache = jax.tree.map(
            lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, GEN)] + [(0, 0)] * 2),
            cache)
        tok = jnp.argmax(logits[:, -1, :], -1).astype(jnp.int32)[:, None]
        toks, step_logits = [tok], []
        for i in range(GEN):
            lg, cache, nxt = serve(params, tok, cache,
                                   jnp.asarray(S + i, jnp.int32))
            tok = nxt[:, None]
            toks.append(tok)
            step_logits.append(_np(lg))
    return {"tokens": np.asarray(batch["tokens"]), "prefill": _np(logits),
            "cache": seed_cache, "ids": np.concatenate(
                [np.asarray(t) for t in toks], axis=1),
            "step_logits": step_logits}


@pytest.fixture(scope="module")
def served(host_mesh, rules):
    """Per case: the reference's run and the port's, same weights."""
    out = {}
    for arch, impl in CASES:
        jcfg, cfg = _configs(arch, impl)
        jparams = JLM(jcfg).init(jax.random.key(0))
        B, S = 2, 16
        want = _reference_serve(jcfg, jparams, B, S, host_mesh, rules)
        model = transformer.LM(cfg, lm_params_from_jax(
            jax.device_get(jparams)), device="cpu")
        batch = make_batch(cfg, B, S, kind="prefill")
        logits, cache = build_prefill_step(model, S + GEN)(batch)
        serve = build_serve_step(model)
        tok = torch.argmax(logits[:, -1, :], -1).to(torch.int32)[:, None]
        toks, step_logits = [tok], []
        for i in range(GEN):
            lg, cache, nxt = serve(tok, cache, S + i)
            tok = nxt[:, None]
            toks.append(tok)
            step_logits.append(lg.numpy())
        got = {"tokens": batch["tokens"].numpy(), "prefill": logits.numpy(),
               "cache_k": cache["k"].float().numpy(),
               "cache_v": cache["v"].float().numpy(),
               "ids": torch.cat(toks, dim=1).numpy(),
               "step_logits": step_logits}
        out[(arch, impl)] = (want, got, jparams, cfg, S)
    return out


@pytest.mark.parametrize("arch,impl", CASES)
def test_prompt_tokens_bit_equal(served, arch, impl):
    want, got, *_ = served[(arch, impl)]
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("arch,impl", CASES)
def test_prefill_logits_and_cache(served, arch, impl):
    want, got, _, _, S = served[(arch, impl)]
    assert got["prefill"].shape == want["prefill"].shape
    np.testing.assert_allclose(got["prefill"], want["prefill"],
                               atol=LOGIT_TOL, rtol=0)
    for name in ("k", "v"):
        ref = _np(want["cache"][name])
        assert got[f"cache_{name}"].shape[2] == S + GEN
        for layer, (a, b) in enumerate(zip(got[f"cache_{name}"], ref)):
            np.testing.assert_allclose(
                a[:, :S], b, rtol=0, atol=CACHE_TOL * np.abs(b).max(),
                err_msg=f"{name} cache, layer {layer}")


@pytest.mark.parametrize("arch,impl", CASES)
def test_greedy_ids_equal_and_decode_logits_close(served, arch, impl):
    want, got, *_ = served[(arch, impl)]
    np.testing.assert_array_equal(got["ids"], want["ids"])
    for a, b in zip(got["step_logits"], want["step_logits"]):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("arch,impl", CASES)
def test_decode_from_reference_cache(served, arch, impl):
    """One decode step from the reference's own prefill cache
    (``lm_cache_from_jax``) agrees with the reference's first step."""
    want, _, jparams, cfg, S = served[(arch, impl)]
    model = transformer.LM(cfg, lm_params_from_jax(jax.device_get(jparams)),
                           device="cpu")
    cache = lm_cache_from_jax(want["cache"], S + GEN)
    tok = torch.from_numpy(want["ids"][:, :1].copy())
    logits, _ = model.decode_step(tok, cache, S)
    np.testing.assert_allclose(logits.numpy(), want["step_logits"][0],
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "codeqwen1.5-7b",
                                  "mistral-nemo-12b", "gemma3-1b"])
def test_decode_matches_forward(arch):
    """prefill(S-1) + decode_step(token S-1) reproduces the last-position
    logits of a prefill over all S tokens (the reference's
    ``test_decode_matches_forward``, within its 1e-3)."""
    cfg = get_config(arch).reduced()
    model = transformer.LM(cfg, seed=0, device="cpu")
    S = 16
    tokens = make_batch(cfg, 2, S, kind="prefill")["tokens"]
    full, _ = model.prefill({"tokens": tokens})
    _, cache = model.prefill({"tokens": tokens[:, :S - 1]}, cache_len=S)
    dec, _ = model.decode_step(tokens[:, S - 1:], cache, S - 1)
    assert float((dec - full).abs().max()) < 1e-3


def test_bf16_cast_before_serving_changes_nothing():
    """Casting the weights to bf16 once (the serve CLI) gives the logits
    of the float32 weights cast at each use (the reference)."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(transformer.build_defs(cfg), seed=3)
    batch = make_batch(cfg, 2, 16, kind="prefill")
    a, ca = transformer.LM(cfg, params, device="cpu").prefill(batch, 20)
    b, cb = transformer.LM(cfg, cast_tree(params, torch.bfloat16),
                           device="cpu").prefill(batch, 20)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_full_configs(arch):
    assert JARCH_IDS == ARCH_IDS
    assert count_params(transformer.build_defs(get_config(arch))) == \
        JLM(jget_config(arch)).param_count()


@pytest.mark.parametrize("trainable", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_constructs_every_arch(arch, trainable):
    """Every arch serves and trains in the port: the reduced config's LM
    constructs, frozen or trainable, under every remat policy ("dots"
    too, since ROADMAP item 15d, part 3)."""
    cfg = get_config(arch).reduced()
    model = transformer.LM(cfg, device="cpu", trainable=trainable)
    assert all(p.requires_grad == trainable
               for p in tree_leaves(model.param_tree()))
    dots = transformer.LM(dataclasses.replace(cfg, remat="dots"),
                          device="cpu", trainable=trainable)
    assert dots.cfg.remat == "dots"
    assert all(p.requires_grad == trainable
               for p in tree_leaves(dots.param_tree()))
