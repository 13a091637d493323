"""Carry the JAX package's GraphSAGE weights and AdamW state into the port.

Both packages name and lay out their parameters alike (``l0_self`` is
``(d_in, d_out)`` in both), so conversion is a copy to float32 tensors.
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
