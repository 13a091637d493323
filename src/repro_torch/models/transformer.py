"""The LM: parameters, the training forward of the dense and MoE
families, and prefill and greedy decode of the dense, MoE, SSM and hybrid
families.

The port of the reference's ``repro/models/transformer.py`` for training
the dense and moe (mixtral, moonshot) families and serving them and the
ssm (mamba2) and hybrid (hymba) families on one card (no mesh, no
sharding constraints).
Parameters keep the reference tree's names and stacked layer shapes
(``blocks.wq`` is (L, d, H, Dh)), so ``convert.lm_params_from_jax``
carries the reference's weights over as a copy; ``lax.scan`` over the
layers becomes a Python loop over layer ``i`` of the stacked tensors.
Activations are bf16 (``COMPUTE_DTYPE``), logits are computed in bf16
and cast to float32.  Training and prefill attention take the flash
kernels under the reference's condition (``attn_impl == "flash"``,
causal, no window; the forward and, in training, the backward kernels
through ``ops.FlashAttention``) and the chunked path otherwise; decode
attention goes through the decode kernel
(``models.attention.decode_attention_local``).  ``LM(...,
trainable=True)`` keeps float32 master parameters that require grad and
are cast to bf16 at each use, as the reference's; ``forward`` slices
layer ``i`` inside the graph on every call and, for ``cfg.remat ==
"full"`` (the reference's default ``jax.checkpoint`` of each layer),
recomputes each block in the backward (``torch.utils.checkpoint``).
The moe family's feed-forward is ``models/moe.py``'s ``apply_moe``; its
load-balancing losses, one a layer, are summed into ``forward``'s
``moe_aux_loss`` (through the checkpoint under ``remat="full"``); prefill
drops them, and decode dispatches at the reference's decode capacity
factor, ``max(2, cfg.capacity_factor)``.

The cache holds each family's leaves (``init_cache``).  The KV cache is
(L, B, S_total, Hkv, Dh) bf16, allocated once for prompt + generation:
prefill writes the first S positions, each decode step writes its
position in place (the reference pads the prefill cache and
``dynamic_update_slice``s it, which gives the same values).  The SSM
cache has no sequence axis: the state (L, B, H, P, N) and the conv tail
(L, B, d_conv - 1, conv_dim), both bf16, written by prefill and replaced
by each decode step.  The SSM mixer (``models/ssm.py``) runs its prefill
scan through the SSD kernel on the card.

``build_defs`` declares every family, so ``count_params`` counts all ten
archs; ``LM`` itself refuses what the port does not run (enc-dec,
M-RoPE, embedding inputs, the ``"dots"`` remat policy, and training of
the ssm and hybrid families, which needs an SSD backward) with
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import decode_attention_local, mha_chunked
from repro_torch.models.layers import (activation, apply_rope, embed_def,
                                       embed_lookup, rmsnorm, rmsnorm_def,
                                       unembed_def)
from repro_torch.models.params import (ParamDef, count_params, init_params,
                                       tree_map)
from repro_torch.models.registry import ModelConfig

COMPUTE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# Parameter definitions (every family, for ``count_params``)
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig, L: int) -> dict[str, ParamDef]:
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "attn_norm": rmsnorm_def(d, L),
        "wq": ParamDef((L, d, H, Dh)),
        "wk": ParamDef((L, d, Hkv, Dh)),
        "wv": ParamDef((L, d, Hkv, Dh)),
        "wo": ParamDef((L, H, Dh, d), fan_in_axes=(1, 2)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((L, H, Dh), init="zeros")
        defs["bk"] = ParamDef((L, Hkv, Dh), init="zeros")
        defs["bv"] = ParamDef((L, Hkv, Dh), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((L, Dh), init="ones")
        defs["k_norm"] = ParamDef((L, Dh), init="ones")
    if cfg.post_norms:
        defs["post_attn_norm"] = rmsnorm_def(d, L)
    return defs


def _mlp_defs(cfg: ModelConfig, L: int) -> dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    defs = {
        "mlp_norm": rmsnorm_def(d, L),
        "w_gate": ParamDef((L, d, f)),
        "w_up": ParamDef((L, d, f)),
        "w_down": ParamDef((L, f, d)),
    }
    if cfg.post_norms:
        defs["post_mlp_norm"] = rmsnorm_def(d, L)
    return defs


def _ssm_defs(cfg: ModelConfig, L: int) -> dict[str, ParamDef]:
    return ssm_lib.ssm_defs(cfg.d_model, cfg.d_inner, cfg.ssm_heads,
                            cfg.ssm_state, cfg.d_conv, L,
                            n_groups=cfg.ssm_groups)


def _cross_defs(cfg: ModelConfig, L: int) -> dict[str, ParamDef]:
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "cross_norm": rmsnorm_def(d, L),
        "wq_c": ParamDef((L, d, H, Dh)),
        "wk_c": ParamDef((L, d, Hkv, Dh)),
        "wv_c": ParamDef((L, d, Hkv, Dh)),
        "wo_c": ParamDef((L, H, Dh, d), fan_in_axes=(1, 2)),
    }


def _block_defs(cfg: ModelConfig, L: int, *, decoder_of_encdec=False) -> dict:
    fam = cfg.family
    if fam == "ssm":
        return {"ssm_norm": rmsnorm_def(cfg.d_model, L), **_ssm_defs(cfg, L)}
    defs = _attn_defs(cfg, L)
    if fam == "moe":
        defs["mlp_norm"] = rmsnorm_def(cfg.d_model, L)
        defs.update(moe_lib.moe_defs(cfg.d_model, cfg.moe_d_ff,
                                     cfg.num_experts, L))
    elif fam == "hybrid":
        defs.update(_ssm_defs(cfg, L))
        defs["attn_branch_norm"] = rmsnorm_def(cfg.d_model, L)
        defs["ssm_branch_norm"] = rmsnorm_def(cfg.d_model, L)
        defs.update(_mlp_defs(cfg, L))
    else:  # dense / encdec
        defs.update(_mlp_defs(cfg, L))
    if decoder_of_encdec:
        defs.update(_cross_defs(cfg, L))
    return defs


def build_defs(cfg: ModelConfig) -> dict:
    defs = {
        "embed": embed_def(cfg.vocab_size, cfg.d_model),
        "final_norm": rmsnorm_def(cfg.d_model),
        "blocks": _block_defs(cfg, cfg.num_layers,
                              decoder_of_encdec=cfg.family == "encdec"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = unembed_def(cfg.d_model, cfg.vocab_size)
    if cfg.family == "encdec":
        enc_cfg = dataclasses.replace(cfg, family="dense", post_norms=False)
        defs["enc_blocks"] = _block_defs(enc_cfg, cfg.encoder_layers)
        defs["enc_final_norm"] = rmsnorm_def(cfg.d_model)
    return defs


SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid")
TRAINED_FAMILIES = ("dense", "moe")


def check_supported(cfg: ModelConfig) -> None:
    """Refuse what the port's LM does not run yet."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (the "
            f"port's LM serves the {', '.join(SERVED_FAMILIES)} families)")
    for field, what in (("mrope_sections", "M-RoPE"),
                        ("embeds_input", "embedding inputs")):
        if getattr(cfg, field):
            raise NotImplementedError(f"{cfg.name}: {what} ({field}) is not "
                                      "ported yet")


# ---------------------------------------------------------------------------
# Block application (``p`` is one layer's slice of the stacked parameters)
# ---------------------------------------------------------------------------

def _proj(x, w):
    """einsum "bsd,d...->bs..." as one matmul in x's dtype."""
    d = w.shape[0]
    out = x.reshape(-1, d) @ w.reshape(d, -1).to(x.dtype)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _project_qkv(cfg: ModelConfig, p, x):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope_qk(cfg: ModelConfig, q, k, positions):
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _out_proj(cfg: ModelConfig, p, out):
    """(B, S, H, Dh) @ wo (H, Dh, d), then the post-attention norm."""
    H, Dh, d = p["wo"].shape
    out = _proj(out.reshape(*out.shape[:-2], H * Dh), p["wo"].reshape(
        H * Dh, d))
    if cfg.post_norms:
        out = rmsnorm(out, p["post_attn_norm"], cfg.norm_eps)
    return out


def _attn_block(cfg: ModelConfig, p, x, positions, window: int):
    """Full-sequence causal attention sub-block (training and prefill).
    Returns (out, (k, v)), the roped k and v for the cache."""
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, p, h)
    bpos = positions.expand(x.shape[0], -1)
    q, kr = _rope_qk(cfg, q, k, bpos)
    if (cfg.attn_impl == "flash" and cfg.sliding_window == 0
            and cfg.local_global_ratio == 0):
        out = ops.flash_attention_bshd(q, kr, v, causal=True)
    else:
        out = mha_chunked(q, kr, v, q_positions=positions,
                          k_positions=positions, window=window, causal=True,
                          chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k,
                          remat_chunks=cfg.attn_remat,
                          scores_bf16=cfg.attn_scores_bf16)
    return _out_proj(cfg, p, out), (kr, v)


def _mlp_block(cfg: ModelConfig, p, x):
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    g = activation(cfg.act)(_proj(h, p["w_gate"]))
    out = _proj(g * _proj(h, p["w_up"]), p["w_down"])
    if cfg.post_norms:
        out = rmsnorm(out, p["post_mlp_norm"], cfg.norm_eps)
    return out


def _ssm_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
                d_conv=cfg.d_conv, n_groups=cfg.ssm_groups)


def _ssm_decode(cfg: ModelConfig, p, h, cache: dict, i: int):
    """The SSM mixer's decode step on layer ``i``'s state and conv tail,
    which it replaces in ``cache``; returns the mixer's output."""
    out, cache["state"][i], cache["conv"][i] = ssm_lib.apply_ssm_decode(
        p, h, cache["state"][i], cache["conv"][i], **_ssm_kw(cfg))
    return out


def _branch_mix(cfg: ModelConfig, p, attn_out, ssm_out):
    """The hybrid block's mean of its two normalized branches."""
    return 0.5 * (rmsnorm(attn_out, p["attn_branch_norm"], cfg.norm_eps)
                  + rmsnorm(ssm_out, p["ssm_branch_norm"], cfg.norm_eps))


def _moe_block(cfg: ModelConfig, p, x, capacity_factor: float):
    """The moe family's feed-forward: (out, {"moe_aux_loss": ...})."""
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return moe_lib.apply_moe(p, h, top_k=cfg.experts_per_token,
                             capacity_factor=capacity_factor,
                             act=activation(cfg.act), routing=cfg.routing,
                             groups=cfg.moe_groups)


def _apply_block(cfg: ModelConfig, p, x, positions, window: int):
    """One decoder block, training and prefill path.  Returns (x, the
    family's cache seeds, the MoE aux loss or None): seeds (k, v) for
    dense and moe, (state, conv_tail) for ssm, (k, v, state, conv_tail)
    for hybrid."""
    if cfg.family == "ssm":
        h = rmsnorm(x, p["ssm_norm"], cfg.norm_eps)
        out, seeds = ssm_lib.apply_ssm(p, h, chunk=cfg.ssm_chunk,
                                       **_ssm_kw(cfg))
        return x + out, seeds, None
    attn_out, kv = _attn_block(cfg, p, x, positions, window)
    if cfg.family == "hybrid":
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        ssm_out, seeds = ssm_lib.apply_ssm(p, h, chunk=cfg.ssm_chunk,
                                           **_ssm_kw(cfg))
        x = x + _branch_mix(cfg, p, attn_out, ssm_out)
        return x + _mlp_block(cfg, p, x), kv + seeds, None
    x = x + attn_out
    if cfg.family == "moe":
        out, aux = _moe_block(cfg, p, x, cfg.capacity_factor)
        return x + out, kv, aux["moe_aux_loss"]
    return x + _mlp_block(cfg, p, x), kv, None


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

CACHE_LEAVES = {"dense": ("k", "v"), "moe": ("k", "v"),
                "ssm": ("state", "conv"),
                "hybrid": ("k", "v", "state", "conv")}


class LM(nn.Module):
    """The LM: the training forward (dense and moe families), prefill and
    decode.

    ``params`` is a tree like the reference's (``convert.lm_params_from_jax``
    or ``params.init_params(build_defs(cfg), seed)``); without it the
    weights are drawn from ``seed`` on ``device``.  Parameters are kept in
    their given dtype.  Frozen by default (serving: draw the tree with
    ``init_params(..., dtype=COMPUTE_DTYPE)`` to serve in bf16, the MoE
    router staying float32, or cast a dense tree with
    ``params.cast_tree``); ``trainable=True`` makes
    them require grad, for float32 master parameters as the reference
    trains them."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 seed: int = 0, device="cuda", trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        if trainable and cfg.family not in TRAINED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: training the {cfg.family!r} family is not "
                "ported yet (the SSD scan has no backward kernel)")
        if trainable and cfg.remat not in ("none", "full"):
            raise NotImplementedError(
                f"{cfg.name}: remat={cfg.remat!r} has no counterpart in "
                "torch (the port takes 'none' and 'full')")
        self.cfg = cfg
        self.defs = build_defs(cfg)
        if params is None:
            params = init_params(self.defs, seed=seed, device=device)
        tree = tree_map(lambda t: nn.Parameter(t, requires_grad=trainable),
                        params)
        self.embed = tree["embed"]
        self.final_norm = tree["final_norm"]
        self.unembed = tree.get("unembed")
        self.blocks = nn.ParameterDict(tree["blocks"])
        # serving: per-layer views of the stacked tensors, made once (the
        # decode loop is host-bound; views of parameters that are never
        # replaced).  Training slices layer i inside the graph on every
        # forward, so no view carries autograd state across steps.
        self._layers = None if trainable else [
            {k: w[i] for k, w in self.blocks.items()}
            for i in range(cfg.num_layers)]
        self._windows = [int(w) for w in cfg.window_pattern()]
        # the reference multiplies by sqrt(d) rounded to bf16
        self._embed_scale = float(torch.tensor(math.sqrt(cfg.d_model),
                                               dtype=COMPUTE_DTYPE))

    def active_param_count(self) -> int:
        """Parameters a token uses: the expert weights of the
        ``num_experts - experts_per_token`` experts it is not routed to
        taken off (the reference's ``LM.active_param_count``)."""
        cfg = self.cfg
        total = count_params(self.defs)
        if cfg.num_experts:
            expert = 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_layers
            total -= expert * (cfg.num_experts - cfg.experts_per_token)
        return total

    def param_tree(self) -> dict:
        """The parameters as the reference's tree (``embed``,
        ``final_norm``, ``blocks``, ``unembed`` when untied): what the
        optimizer updates in place."""
        tree = {"embed": self.embed, "final_norm": self.final_norm,
                "blocks": dict(self.blocks)}
        if self.unembed is not None:
            tree["unembed"] = self.unembed
        return tree

    def _layer(self, i: int) -> dict:
        if self._layers is not None:
            return self._layers[i]
        return {k: w[i] for k, w in self.blocks.items()}

    def _embed(self, tokens):
        x = embed_lookup(self.embed, tokens, COMPUTE_DTYPE)
        if self.cfg.embed_scale:
            x = x * self._embed_scale
        return x

    def _logits(self, x):
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            w = self.embed.to(COMPUTE_DTYPE)             # (V, d)
            logits = x @ w.T
        else:
            logits = x @ self.unembed.to(COMPUTE_DTYPE)
        return logits.float()

    def _train_block(self, x, positions, i: int):
        x, _, aux = _apply_block(self.cfg, self._layer(i), x, positions,
                                 self._windows[i])
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux

    def forward(self, batch: dict):
        """Training forward: ``batch["tokens"]`` (B, S) -> (logits (B, S,
        V) float32, {"moe_aux_loss": the layers' summed load-balancing
        losses, 0 outside the moe family}), the reference's
        ``LM.forward``.  With ``cfg.remat == "full"`` each block is
        recomputed in the backward."""
        x = self._embed(batch["tokens"])
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        auxes = []
        for i in range(self.cfg.num_layers):
            if self.cfg.remat == "full":
                x, aux = checkpoint(self._train_block, x, positions, i,
                                    use_reentrant=False)
            else:
                x, aux = self._train_block(x, positions, i)
            auxes.append(aux)
        return self._logits(x), {"moe_aux_loss": torch.stack(auxes).sum()}

    def init_cache(self, B: int, S: int) -> dict:
        """A zero bf16 cache of the family's leaves on the model's device:
        K and V (L, B, S, Hkv, Dh); the SSM state (L, B, H, P, N) and conv
        tail (L, B, d_conv - 1, conv_dim), which do not depend on S."""
        cfg = self.cfg
        L = cfg.num_layers
        kv = (L, B, S, cfg.num_kv_heads, cfg.head_dim)
        shapes = {"k": kv, "v": kv}
        if cfg.ssm_heads:
            shapes["state"] = (L, B, cfg.ssm_heads,
                               cfg.d_inner // cfg.ssm_heads, cfg.ssm_state)
            shapes["conv"] = (L, B, cfg.d_conv - 1, cfg.d_inner
                              + 2 * cfg.ssm_groups * cfg.ssm_state)
        return {n: torch.zeros(shapes[n], dtype=COMPUTE_DTYPE,
                               device=self.embed.device)
                for n in CACHE_LEAVES[cfg.family]}

    @torch.no_grad()
    def prefill(self, batch: dict, cache_len: int | None = None):
        """Forward over the prompt, writing each layer's cache seeds into
        a fresh cache: K and V at the first S of ``cache_len`` positions
        (default: the prompt length), the SSM state and conv tail whole.
        Returns (last-position logits (B, 1, V) float32, cache)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        cache = self.init_cache(B, S if cache_len is None else cache_len)
        for i, window in enumerate(self._windows):
            x, seeds, _ = _apply_block(self.cfg, self._layer(i), x,
                                       positions, window)
            for name, seed in zip(CACHE_LEAVES[self.cfg.family], seeds):
                if name in ("k", "v"):
                    cache[name][i, :, :S] = seed
                else:
                    cache[name][i] = seed
        return self._logits(x[:, -1:, :]), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, position: int):
        """One-token decode: tokens (B, 1); ``position`` is the host int
        index the new K and V are written at (attention sees [0,
        position]); the SSM state and conv tail advance one step.
        Updates ``cache`` in place; returns (logits (B, 1, V) float32,
        cache)."""
        cfg = self.cfg
        x = self._embed(tokens)
        pos = torch.full((x.shape[0], 1), position, dtype=torch.int32,
                         device=x.device)
        for i, window in enumerate(self._windows):
            p = self._layer(i)
            if cfg.family == "ssm":
                h = rmsnorm(x, p["ssm_norm"], cfg.norm_eps)
                x = x + _ssm_decode(cfg, p, h, cache, i)
                continue
            h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
            q, k_new, v_new = _project_qkv(cfg, p, h)
            q, k_new = _rope_qk(cfg, q, k_new, pos)
            ck, cv = cache["k"][i], cache["v"][i]
            ck[:, position] = k_new[:, 0]
            cv[:, position] = v_new[:, 0]
            out = decode_attention_local(q[:, 0], ck, cv, position + 1,
                                         window=window)
            attn_out = _out_proj(cfg, p, out[:, None])
            if cfg.family == "hybrid":
                # the SSM branch reads the same normalized input
                ssm_out = _ssm_decode(cfg, p, h, cache, i)
                x = x + _branch_mix(cfg, p, attn_out, ssm_out)
                x = x + _mlp_block(cfg, p, x)
                continue
            x = x + attn_out
            if cfg.family == "moe":
                out, _ = _moe_block(cfg, p, x, max(2.0, cfg.capacity_factor))
                x = x + out
            else:
                x = x + _mlp_block(cfg, p, x)
        return self._logits(x), cache
