"""Carry the JAX package's weights, optimizer states and LM cache into the
port.

Both packages name and lay out their parameters alike (GraphSAGE's
``l0_self`` is ``(d_in, d_out)`` in both, the LM's ``blocks.wq`` is (L, d,
H, Dh) in both), so conversion is a copy to float32 tensors.
The inputs are plain dicts of numpy arrays (``jax.device_get`` of the
reference's trees), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The reference's parameter dict -> the port's ``state_dict``."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in tree.items()}


def opt_state_from_jax(opt_state: dict, device="cpu") -> dict:
    """The reference's AdamW state ``{"m": {...}, "v": {...}}`` -> the
    port's, for ``repro_torch.optim.adamw``."""
    return {k: params_from_jax(opt_state[k], device) for k in ("m", "v")}


def lm_params_from_jax(tree: dict, device="cpu") -> dict:
    """The reference LM's parameter tree (nested dicts of numpy arrays,
    ``jax.device_get(model.init(key))``) -> the same tree of float32
    tensors for ``repro_torch.models.transformer.LM``."""
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def lm_cache_from_jax(cache: dict, S_total: int) -> dict:
    """The reference's prefill cache -> the port's bf16 cache: K and V
    (L, B, S, Hkv, Dh) at ``S_total`` positions, the prompt's S first and
    zeros after (the reference's right pad); the SSM ``state`` (L, B, H,
    P, N) and ``conv`` tail (L, B, d_conv - 1, conv_dim) as they are (they
    have no sequence axis); the encdec family's ``cross_k`` and
    ``cross_v`` (L, B, S_src, Hkv, Dh) as they are (decode reads them
    whole)."""
    out = {}
    for name in ("k", "v", "state", "conv", "cross_k", "cross_v"):
        if name not in cache:
            continue
        a = torch.from_numpy(np.array(cache[name], np.float32))
        if name in ("k", "v"):
            pad = torch.zeros(a.shape[:2] + (S_total - a.shape[2],)
                              + a.shape[3:])
            a = torch.cat([a, pad], dim=2)
        out[name] = a.to(torch.bfloat16)
    return out


def lm_opt_state_from_jax(opt_state: dict, device="cpu") -> dict:
    """The reference LM's AdamW state ``{"m": tree, "v": tree}`` (nested
    dicts of numpy arrays) -> the port's, for ``repro_torch.optim.adamw``
    over ``LM.param_tree()``."""
    return {k: lm_params_from_jax(opt_state[k], device) for k in ("m", "v")}
