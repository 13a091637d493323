"""Model configuration dataclass and the architecture registry, a copy of
the reference's ``repro/models/registry.py`` (numpy only).

Every assigned architecture registers a ``ModelConfig`` via
``repro_torch/configs/<id>.py``; selectable with ``--arch <id>`` in the
launch scripts.  ``reduced()`` derives the small same-family config used by
the per-arch CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    sliding_window: int = 0        # >0: SWA window for all attn layers
    local_global_ratio: int = 0    # gemma3: N local layers per 1 global
    local_window: int = 1024
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl (t, h, w)
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma: x *= sqrt(d_model)
    post_norms: bool = False       # gemma3 sandwich norms
    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    routing: str = "softmax"       # softmax | sigmoid
    capacity_factor: float = 1.25
    # dispatch groups: 1 = global routing (baseline); = data shards keeps
    # the position-in-expert cumsum shard-local (§Perf MoE fix)
    moe_groups: int = 1
    # ZeRO-3-style use-site gather of expert weights: constrain the layer's
    # expert matrices to (experts@model, None, mlp-replicated...) so the
    # expert einsum contracts an UNSHARDED d — XLA all-gathers the small
    # weights instead of all-reducing the big (G,E,C,f) activations
    # (§Perf MoE fix #2)
    moe_zero3_gather: bool = False
    # ssm
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    d_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1
    expand: int = 2
    # enc-dec
    encoder_layers: int = 0
    enc_seq_divisor: int = 4       # enc frames = seq_len // divisor (stub frontend)
    # modality frontend stub: inputs are precomputed embeddings, not tokens
    embeds_input: bool = False
    # misc
    norm_eps: float = 1e-6
    act: str = "silu"
    # training-time knobs (hillclimb levers)
    remat: str = "full"            # none | full | dots
    attn_chunk_q: int = 2048
    attn_chunk_k: int = 1024
    # checkpoint the attention KV-chunk body: backward recomputes the
    # (cq, ck) score block instead of saving O(S^2) fp32 residuals across
    # the chunk scan (flash-attention-style memory behaviour; §Perf opt)
    attn_remat: bool = False
    # bf16 score/probability blocks (fp32 softmax stats) — halves the
    # attention HBM-traffic term (§Perf)
    attn_scores_bf16: bool = False
    # "chunked" (jnp online-softmax; what the dry-run lowers) or "flash"
    # (Pallas fused fwd+bwd kernel — TPU hot path; full-causal archs only)
    attn_impl: str = "chunked"
    # technique applicability (DESIGN.md §4)
    subquadratic: bool = False     # may run long_500k

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def window_pattern(self) -> np.ndarray:
        """Per-layer sliding windows; -1 = full/global attention."""
        L = self.num_layers
        if self.local_global_ratio > 0:
            pat = []
            for i in range(L):
                is_global = (i + 1) % (self.local_global_ratio + 1) == 0
                pat.append(-1 if is_global else self.local_window)
            return np.array(pat, np.int32)
        if self.sliding_window > 0:
            return np.full((L,), self.sliding_window, np.int32)
        return np.full((L,), -1, np.int32)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2 if self.encoder_layers == 0 else 2,
            encoder_layers=min(self.encoder_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            moe_d_ff=64 if self.num_experts else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            vocab_size=256,
            ssm_heads=4 if self.ssm_heads else 0,
            ssm_head_dim=8 if self.ssm_heads else 64,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=8,
            local_window=8 if self.local_global_ratio else self.local_window,
            sliding_window=8 if self.sliding_window else 0,
            mrope_sections=(2, 3, 3) if self.mrope_sections else (),
            attn_chunk_q=16,
            attn_chunk_k=16,
            expand=2,
        )


ARCH_IDS = (
    "qwen2-0.5b",
    "codeqwen1.5-7b",
    "mistral-nemo-12b",
    "gemma3-1b",
    "mamba2-370m",
    "mixtral-8x7b",
    "moonshot-v1-16b-a3b",
    "qwen2-vl-7b",
    "hymba-1.5b",
    "seamless-m4t-large-v2",
)

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    for a in ARCH_IDS:
        get_config(a)
    return dict(_REGISTRY)
