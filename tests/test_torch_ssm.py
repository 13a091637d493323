"""The port's SSM mixer and the ssm (mamba2) and hybrid (hymba) LM families
against the reference's, at equal weights (carried over with
``convert.lm_params_from_jax``) and equal prompts, on the CPU through the
plain scan; and the serve CLI on those families.

Integer outputs are bit-equal: greedy ids.  Values agree within stated
tolerances: both packages run the mixer's projections and conv in bf16
and its scan in float32 and round at the same places (the port follows
XLA: silu as x * 1 / (1 + exp(-x)) rounded per operation, the gated norm's
product kept in float32), so one layer's mixer output and cache agree
within one bf16 ulp of its largest entry where the float32 scan's sums,
taken in another order, round across a bf16 boundary; the tolerance is 2e-2
of the largest entry (a bf16 ulp is 2**-7 to 2**-8 of a value).  Later
layers, and hymba's attention and MLP (where PyTorch's ``F.silu`` rounds
once), drift by a few ulps more: the caches within 5e-2 of each layer's
largest entry, the float32 logits (magnitude up to ~4) within 0.05
absolute, as ``tests/test_torch_lm.py`` holds the dense family.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.shapes import make_batch as jmake_batch
from repro.models import ssm as jssm
from repro.models.registry import get_config as jget_config
from repro.models.transformer import LM as JLM
from repro.train.steps import build_prefill_step as jbuild_prefill
from repro.train.steps import build_serve_step as jbuild_serve
from repro_torch import kernels
from repro_torch.convert import lm_cache_from_jax, lm_params_from_jax
from repro_torch.launch.shapes import make_batch
from repro_torch.models import ssm, transformer
from repro_torch.models.params import cast_tree
from repro_torch.models.registry import get_config
from repro_torch.train.steps import build_prefill_step, build_serve_step

MIXER_TOL = 2e-2     # of the largest |entry|
CACHE_TOL = 5e-2     # of each layer's largest |entry|
LOGIT_TOL = 5e-2
GEN = 4
SRC = Path(__file__).resolve().parent.parent / "src"


def _np(x):
    return np.asarray(x, np.float32)


def _close_to_largest(got, want, tol, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixer_params():
    """Layer 0 of the reduced mamba2's reference weights, bf16 on both
    sides."""
    jcfg = jget_config("mamba2-370m").reduced()
    blocks = jax.device_get(JLM(jcfg).init(jax.random.key(0))["blocks"])
    layer = {k: v[0] for k, v in blocks.items() if k != "ssm_norm"}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in layer.items()}
    tp = cast_tree(lm_params_from_jax(layer), torch.bfloat16)
    kw = dict(n_heads=jcfg.ssm_heads, d_state=jcfg.ssm_state,
              d_conv=jcfg.d_conv, n_groups=jcfg.ssm_groups)
    return jcfg, jp, tp, kw


def _bf16_pair(a):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


@pytest.mark.parametrize("S", [20, 16])
def test_apply_ssm_matches_reference(mixer_params, S):
    """S 20 is not a multiple of the reduced config's chunk 8 (padded with
    dt = 0), S 16 is."""
    jcfg, jp, tp, kw = mixer_params
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model))
    jx, tx = _bf16_pair(x.astype(np.float32))
    want_out, (want_st, want_tail) = jax.jit(
        lambda p, x: jssm.apply_ssm(p, x, chunk=jcfg.ssm_chunk, **kw))(jp, jx)
    out, (st, tail) = ssm.apply_ssm(tp, tx, chunk=jcfg.ssm_chunk, **kw)
    assert out.dtype == st.dtype == tail.dtype == torch.bfloat16
    assert st.shape == want_st.shape and tail.shape == want_tail.shape
    _close_to_largest(out.float(), want_out, MIXER_TOL, "out")
    _close_to_largest(st.float(), want_st, MIXER_TOL, "final_state")
    np.testing.assert_array_equal(tail.float().numpy(), _np(want_tail))


def test_apply_ssm_decode_matches_reference(mixer_params):
    jcfg, jp, tp, kw = mixer_params
    rng = np.random.default_rng(1)
    conv_dim = jcfg.d_inner + 2 * jcfg.ssm_state
    x, st, cc = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, 1, jcfg.d_model),
        (2, jcfg.ssm_heads, jcfg.d_inner // jcfg.ssm_heads, jcfg.ssm_state),
        (2, jcfg.d_conv - 1, conv_dim)))
    (jx, tx), (jst, tst), (jcc, tcc) = map(_bf16_pair, (x, st, cc))
    want = jax.jit(lambda p, x, s, c: jssm.apply_ssm_decode(p, x, s, c, **kw))(
        jp, jx, jst, jcc)
    got = ssm.apply_ssm_decode(tp, tx, tst, tcc, **kw)
    for name, a, b in zip(("out", "state", "conv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _close_to_largest(a.float(), b, MIXER_TOL, name)


def test_decode_steps_continue_the_prefill(mixer_params):
    """prefill(S - 1) then one decode step gives the output of prefill(S)
    at position S - 1: the conv tail and the state carry over (within the
    bf16 rounding of the cached state)."""
    jcfg, _, tp, kw = mixer_params
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 13, jcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    full, _ = ssm.apply_ssm(tp, x, chunk=jcfg.ssm_chunk, **kw)
    _, (st, tail) = ssm.apply_ssm(tp, x[:, :12], chunk=jcfg.ssm_chunk, **kw)
    out, _, _ = ssm.apply_ssm_decode(tp, x[:, 12:], st, tail, **kw)
    _close_to_largest(out.float(), full[:, 12:].float(), MIXER_TOL)


def test_cpu_scan_counts_no_launch(mixer_params):
    jcfg, _, tp, kw = mixer_params
    kernels.reset_launches()
    x = torch.zeros((1, 9, jcfg.d_model), dtype=torch.bfloat16)
    ssm.apply_ssm(tp, x, chunk=jcfg.ssm_chunk, **kw)
    assert kernels.LAUNCHES["ssd_chunk_scan"] == 0


# ---------------------------------------------------------------------------
# the whole LM: prefill + GEN greedy decode steps
# ---------------------------------------------------------------------------

CASES = {"mamba2": ("mamba2-370m", True, 2, 20),
         "hymba": ("hymba-1.5b", True, 2, 16),
         "mamba2-full-width": ("mamba2-370m", False, 1, 300)}


def _configs(arch, reduced):
    """The reduced config, or the full config cut to 2 layers."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    else:
        jcfg = dataclasses.replace(jcfg, num_layers=2)
        cfg = dataclasses.replace(cfg, num_layers=2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _reference_serve(jcfg, params, B, S, host_mesh, rules):
    """The reference's prefill + GEN greedy serve steps, the KV leaves
    right-padded by GEN (the SSM leaves have no sequence axis)."""
    model = JLM(jcfg)
    batch = jmake_batch(jcfg, B, S, kind="prefill")
    with host_mesh:
        prefill = jax.jit(jbuild_prefill(model, host_mesh, rules))
        serve = jax.jit(jbuild_serve(model, host_mesh, rules))
        logits, cache = prefill(params, batch)
        seed_cache = jax.device_get(cache)
        cache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, GEN), (0, 0), (0, 0)])
                 if k in ("k", "v") else v for k, v in cache.items()}
        tok = jnp.argmax(logits[:, -1, :], -1).astype(jnp.int32)[:, None]
        toks, step_logits = [tok], []
        for i in range(GEN):
            lg, cache, nxt = serve(params, tok, cache,
                                   jnp.asarray(S + i, jnp.int32))
            tok = nxt[:, None]
            toks.append(tok)
            step_logits.append(_np(lg))
    return {"prefill": _np(logits), "cache": seed_cache,
            "ids": np.concatenate([np.asarray(t) for t in toks], axis=1),
            "step_logits": step_logits}


@pytest.fixture(scope="module")
def served(host_mesh, rules):
    out = {}
    for case, (arch, reduced, B, S) in CASES.items():
        jcfg, cfg = _configs(arch, reduced)
        jparams = JLM(jcfg).init(jax.random.key(0))
        want = _reference_serve(jcfg, jparams, B, S, host_mesh, rules)
        model = transformer.LM(cfg, lm_params_from_jax(
            jax.device_get(jparams)), device="cpu")
        batch = make_batch(cfg, B, S, kind="prefill")
        logits, cache = build_prefill_step(model, S + GEN)(batch)
        prefill_cache = {k: v.clone() for k, v in cache.items()}
        serve = build_serve_step(model)
        tok = torch.argmax(logits[:, -1, :], -1).to(torch.int32)[:, None]
        toks, step_logits = [tok], []
        for i in range(GEN):
            lg, cache, nxt = serve(tok, cache, S + i)
            tok = nxt[:, None]
            toks.append(tok)
            step_logits.append(lg.numpy())
        got = {"prefill": logits.numpy(), "cache": prefill_cache,
               "ids": torch.cat(toks, dim=1).numpy(),
               "step_logits": step_logits}
        out[case] = (want, got, model, S)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_logits_and_cache(served, case):
    want, got, _, S = served[case]
    np.testing.assert_allclose(got["prefill"], want["prefill"],
                               atol=LOGIT_TOL, rtol=0)
    ref_cache = lm_cache_from_jax(want["cache"], S + GEN)
    assert sorted(got["cache"]) == sorted(ref_cache) == sorted(
        transformer.CACHE_LEAVES[served[case][2].cfg.family])
    for name, ref in ref_cache.items():
        mine = got["cache"][name]
        assert mine.dtype == ref.dtype == torch.bfloat16
        assert mine.shape == ref.shape, name
        for layer, (a, b) in enumerate(zip(mine.float(), ref.float())):
            _close_to_largest(a, b.numpy(), CACHE_TOL,
                              f"{name} cache, layer {layer}")


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_ids_equal_and_decode_logits_close(served, case):
    want, got, *_ = served[case]
    np.testing.assert_array_equal(got["ids"], want["ids"])
    for a, b in zip(got["step_logits"], want["step_logits"]):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("case", ["mamba2", "hymba"])
def test_decode_from_reference_cache(served, case):
    """One decode step from the reference's own prefill cache
    (``lm_cache_from_jax``: K and V right-padded, the SSM leaves as they
    are) agrees with the reference's first step."""
    want, _, model, S = served[case]
    cache = lm_cache_from_jax(want["cache"], S + GEN)
    tok = torch.from_numpy(want["ids"][:, :1].copy())
    logits, _ = model.decode_step(tok, cache, S)
    np.testing.assert_allclose(logits.numpy(), want["step_logits"][0],
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_decode_matches_forward(arch):
    """prefill(S-1) + decode_step(token S-1) reproduces the last-position
    logits of a prefill over all S tokens within the reference's own
    tolerance for the family (``tests/test_models_smoke.py``: 0.1 ssm,
    0.15 hybrid; the cached state is rounded to bf16)."""
    cfg = get_config(arch).reduced()
    model = transformer.LM(cfg, seed=0, device="cpu")
    S = 16
    tokens = make_batch(cfg, 2, S, kind="prefill")["tokens"]
    full, _ = model.prefill({"tokens": tokens})
    _, cache = model.prefill({"tokens": tokens[:, :S - 1]}, cache_len=S)
    dec, _ = model.decode_step(tokens[:, S - 1:], cache, S - 1)
    tol = {"ssm": 0.1, "hybrid": 0.15}[cfg.family]
    assert float((dec - full).abs().max()) < tol


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_cache_is_sized_by_family(arch):
    """The SSM leaves have no sequence axis: their shapes do not depend on
    the cache length, and a length equal to the head count or to
    d_conv - 1 changes nothing (the reference's serve launcher pads every
    leaf whose axis 2 equals the prompt length)."""
    cfg = get_config(arch).reduced()
    model = transformer.LM(cfg, seed=0, device="cpu")
    P = cfg.d_inner // cfg.ssm_heads
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    for S in (cfg.ssm_heads, cfg.d_conv - 1, 64):
        cache = model.init_cache(2, S)
        assert cache["state"].shape == (cfg.num_layers, 2, cfg.ssm_heads, P,
                                        cfg.ssm_state)
        assert cache["conv"].shape == (cfg.num_layers, 2, cfg.d_conv - 1,
                                       conv_dim)
        if cfg.family == "hybrid":
            assert cache["k"].shape[2] == cache["v"].shape[2] == S


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def _serve(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True,
                          timeout=timeout, env=env)


@pytest.mark.parametrize("arch,prompt", [("mamba2-370m", 12),
                                         ("mamba2-370m", 4),
                                         ("hymba-1.5b", 3)])
def test_serve_cli_on_cpu(arch, prompt):
    """Serves the reduced config; prompt lengths 4 (the reduced mamba2's
    head count) and 3 (d_conv - 1) stop the reference's launcher, whose
    cache padding takes an SSM leaf for a sequence."""
    out = _serve(["--device", "cpu", "--arch", arch, "--batch", "2",
                  "--prompt-len", str(prompt), "--gen", "3"])
    assert out.returncode == 0, out.stderr
    assert f"prefill(2x{prompt})" in out.stdout
    assert "decode 2 steps" in out.stdout and "tok/s" in out.stdout
    assert "sample token ids:" in out.stdout


def test_serve_cli_without_gpu_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = _serve(["--arch", "mamba2-370m", "--gen", "2"])
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
