"""The smaller parts of the port's LM training path against the
reference's, on the CPU: ``TokenPipeline`` batches bit for bit, the
learning-rate schedules exactly, the cross-entropies and the optimizers
over nested trees within 1e-6 (float32, the same arithmetic), and the
training CLI's LM branch.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import TokenPipeline as JTokenPipeline
from repro.optim import adamw as jadamw
from repro.optim import lion as jlion
from repro.optim import sgd as jsgd
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.optim.schedules import constant as jconstant
from repro.train.steps import CE_IMPLS as JCE_IMPLS
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import TokenPipeline
from repro_torch.optim import adamw, constant, lion, sgd, warmup_cosine
from repro_torch.models.params import tree_leaves
from repro_torch.train.steps import CE_IMPLS

SRC = Path(__file__).resolve().parent.parent / "src"
ARCH = "qwen2-0.5b"


@pytest.mark.parametrize("ce", ["gather", "sharded"])
def test_cross_entropy_matches_reference(ce):
    rng = np.random.default_rng(7)
    logits = (4 * rng.standard_normal((2, 8, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 8)).astype(np.int32)
    want = float(JCE_IMPLS[ce](jnp.asarray(logits), jnp.asarray(labels)))
    got = float(CE_IMPLS[ce](torch.from_numpy(logits),
                             torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("step", [0, 1, 7])
@pytest.mark.parametrize("vocab,seq,batch,seed",
                         [(256, 32, 4, 0), (151936, 64, 2, 3)])
def test_token_pipeline_batches_bit_equal(vocab, seq, batch, seed, step):
    want = JTokenPipeline(vocab_size=vocab, seq_len=seq, global_batch=batch,
                          seed=seed).batch(step)
    pipe = TokenPipeline(vocab_size=vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
    got = pipe.batch(step)
    tb = pipe.torch_batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == np.int32 and tb[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(tb[k].numpy(), want[k])


@pytest.mark.parametrize("args", [(1e-3, 10, 50), (3e-4, 0, 7),
                                  (1.0, 5, 5), (7e-4, 3, 200)])
def test_schedules_equal_reference(args):
    want, got = jwarmup_cosine(*args), warmup_cosine(*args)
    for step in range(args[2] + 10):
        assert got(step) == float(want(step)), step
    assert constant(args[0])(3) == float(jconstant(args[0])(3))


def _nested(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((3, 4))).astype(np.float32),
            "blocks": {"b": (scale * rng.standard_normal((2, 5))).astype(
                np.float32), "a": (scale * rng.standard_normal(
                    (4,))).astype(np.float32)}}


@pytest.mark.parametrize("name", ["adamw", "sgd", "lion"])
def test_optimizers_on_nested_trees_match_reference(name):
    """Three steps over a nested tree, the clip binding: parameters,
    state and metrics within 1e-6 (float32, the same arithmetic)."""
    rng = np.random.default_rng(2)
    params = _nested(rng)
    grads = [_nested(rng, scale=2.0) for _ in range(3)]
    make = {"adamw": (jadamw, adamw), "sgd": (jsgd, sgd),
            "lion": (jlion, lion)}[name]
    jopt, opt = make[0](jwarmup_cosine(1e-2, 2, 5)), make[1](
        warmup_cosine(1e-2, 2, 5))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = lm_params_from_jax(params)
    tstate = {k: lm_params_from_jax(v) for k, v in
              jax.device_get(jstate).items()}
    for step, g in enumerate(grads):
        jp, jstate, jm = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                     jp, jnp.asarray(step, jnp.int32))
        tm = opt.update(lm_params_from_jax(g), tstate, tp, step)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
    for tree, jtree in [(tp, jp)] + [(tstate[k], jstate[k])
                                     for k in tstate]:
        for a, b in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_lm_cli_trains_on_cpu_when_asked():
    out = _run(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps",
                "3", "--batch", "4", "--seq-len", "32", "--log-every", "1",
                "--microbatches", "2"])
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("loss=") == 3 and "|g|=" in out.stdout
    assert "lr=1.00e-04" in out.stdout and "lr=3.00e-04" in out.stdout
    assert "3 steps in" in out.stdout and "tok/s" in out.stdout


def test_lm_cli_without_gpu_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = _run(["--arch", ARCH, "--reduced", "--steps", "1"])
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr


def test_lm_cli_refuses_other_families_and_checkpoints():
    out = _run(["--device", "cpu", "--arch", "seamless-m4t-large-v2",
                "--reduced", "--steps", "1"])
    assert out.returncode == 2 and "src_embeds" in out.stderr
    out = _run(["--device", "cpu", "--arch", ARCH, "--mesh", "4x1"])
    assert out.returncode == 2 and "unrecognized arguments" in out.stderr
