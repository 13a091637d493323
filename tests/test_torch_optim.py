"""The port's AdamW with global-norm clipping against the reference's:
parameters and both moments agree within 1e-6 over three steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import adamw, clip_by_global_norm

SHAPES = {"a": (5, 3), "b": (3,), "c": (2, 2)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("scale,clipped", [(2.0, True), (0.05, False)],
                         ids=["clip", "no-clip"])
def test_adamw_three_steps_match_reference(scale, clipped):
    """Gradients large enough for the clip at norm 1 to bind, and small
    enough for it not to."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, scale=scale) for _ in range(3)]
    jopt = jadamw(1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    opt = adamw(1e-2)
    tp = params_from_jax(params)
    tstate = opt_state_from_jax(jax.device_get(jstate))
    for step, g in enumerate(grads):
        jp, jstate, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                     jstate, jp, jnp.asarray(step, jnp.int32))
        tm = opt.update(params_from_jax(g), tstate, tp, step)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-6)
        assert (float(jm["grad_norm"]) > 1.0) == clipped
    for k in SHAPES:
        for got, want in ((tp[k], jp[k]), (tstate["m"][k], jstate["m"][k]),
                          (tstate["v"][k], jstate["v"][k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


def test_clip_by_global_norm_scales_to_max_norm():
    rng = np.random.default_rng(1)
    g = params_from_jax(_tree(rng, scale=3.0))
    clipped, gn = clip_by_global_norm(g, 1.0)
    norm = torch.sqrt(sum(torch.sum(v ** 2) for v in clipped.values()))
    assert float(gn) > 1.0
    assert float(norm) == pytest.approx(1.0, rel=1e-6)
