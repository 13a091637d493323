"""The assigned input-shape cells, the dry-run's abstract inputs, and
concrete model inputs for the port's LM.

The port of the reference's ``repro/launch/shapes.py``.  Every (arch x
shape) cell is defined here (``SHAPES``, ``cell_skip_reason``).
``input_specs`` gives a cell's inputs as one rank of a mesh holds them,
without memory: each leaf a DTensor of the reference's global shape and
dtype, placed by the rules as its logical axes say, whose local tensor is
a fake tensor (``models.params.sharded_fake``).  ``make_batch`` draws a
small concrete batch: the same ``np.random.default_rng(seed)`` draws in
the same order as the reference's, so the prompt tokens are bit-equal to
it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models.params import sharded_fake, tree_map
from repro_torch.models.registry import ModelConfig
from repro_torch.models.transformer import COMPUTE_DTYPE, cache_defs


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_skip_reason(cfg: ModelConfig, shape: ShapeCell) -> str | None:
    """A skip reason or None, the reference's: long_500k only for a
    sub-quadratic arch."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention arch: long_500k requires sub-quadratic "
                "attention (DESIGN.md §4)")
    return None


def input_specs(cfg: ModelConfig, shape: ShapeCell, rules: ShardingRules,
                mesh, device="cuda") -> dict[str, Any]:
    """The abstract model inputs of one cell on ``mesh`` (see the module
    docstring): ``tokens`` (B, S) int32 or bf16 ``embeds`` (B, S, d), the
    encdec family's ``src_embeds`` and, to train, ``labels``, each on
    ("batch", "seq"[, "act_embed"]); to decode, ``tokens`` (B, 1), the
    ``cache`` (``models.transformer.cache_defs``) and the host int
    ``position`` S - 1 (the reference's is an abstract int32 scalar)."""
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model

    def spec(shp, dtype, axes):
        return sharded_fake(shp, dtype, axes, rules, mesh, device)

    if shape.kind in ("train", "prefill"):
        batch: dict[str, Any] = {}
        if cfg.embeds_input and cfg.family != "encdec":
            batch["embeds"] = spec((B, S, d), COMPUTE_DTYPE,
                                   ("batch", "seq", "act_embed"))
        else:
            batch["tokens"] = spec((B, S), torch.int32, ("batch", "seq"))
        if cfg.family == "encdec":
            batch["src_embeds"] = spec((B, S // cfg.enc_seq_divisor, d),
                                       COMPUTE_DTYPE,
                                       ("batch", "enc_seq", "act_embed"))
        if shape.kind == "train":
            batch["labels"] = spec((B, S), torch.int32, ("batch", "seq"))
        return batch
    cache = tree_map(lambda dd: spec(dd.shape, dd.dtype, dd.logical_axes),
                     cache_defs(cfg, B, S))
    return {"tokens": spec((B, 1), torch.int32, ("batch", None)),
            "cache": cache, "position": S - 1}


def make_batch(cfg: ModelConfig, B: int, S: int, seed: int = 0,
               kind: str = "train", device="cpu") -> dict:
    """Concrete batch: int32 ``tokens`` (B, S) (or bf16 ``embeds``), plus
    ``src_embeds`` for enc-dec and ``labels`` for training; for ``kind ==
    "decode"`` one token per row and the int ``position``."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model

    def tensor(a, dtype):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    if kind in ("train", "prefill"):
        batch = {}
        if cfg.embeds_input and cfg.family != "encdec":
            batch["embeds"] = tensor(
                rng.normal(size=(B, S, d)).astype(np.float32), COMPUTE_DTYPE)
        else:
            batch["tokens"] = tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                     torch.int32)
        if cfg.family == "encdec":
            batch["src_embeds"] = tensor(
                rng.normal(size=(B, S // cfg.enc_seq_divisor, d))
                .astype(np.float32), COMPUTE_DTYPE)
        if kind == "train":
            batch["labels"] = tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                     torch.int32)
        return batch
    return {"tokens": tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                             torch.int32),
            "position": S - 1}
