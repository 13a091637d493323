"""The LM: parameters, the training forward, prefill and greedy decode of
every family: dense, moe, ssm, hybrid and encdec.

The port of the reference's ``repro/models/transformer.py`` on one card
(no mesh, no sharding constraints).
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
factor, ``max(2, cfg.capacity_factor)``.  The ssm and hybrid families'
mixer (``models/ssm.py``) scans through the SSD kernel on the card, in
training through ``ops.SSDChunkScan``, whose backward is autograd of the
plain scan (the reference trains the SSM by autodiff of its plain
``ssd_chunked``).

qwen2-vl-7b rotates with M-RoPE (``layers.apply_mrope``, its three
position rows equal, as the reference passes them) and takes float
``embeds`` in place of ``tokens`` (``cfg.embeds_input``; int32 ids are
still looked up, as the reference's ``_embed`` does).  The encdec family
(seamless-m4t-large-v2) runs a non-causal encoder over ``src_embeds``
(the decoder's blocks as the dense family without post-norms, no window,
always the chunked path, as the reference routes it) and, after each
decoder block's self-attention, cross-attention to the encoder's output
(``mha_chunked``, no mask, no RoPE).

The cache holds each family's leaves (``init_cache``).  The KV cache is
(L, B, S_total, Hkv, Dh) bf16, allocated once for prompt + generation:
prefill writes the first S positions, each decode step writes its
position in place (the reference pads the prefill cache and
``dynamic_update_slice``s it, which gives the same values).  The SSM
cache has no sequence axis: the state (L, B, H, P, N) and the conv tail
(L, B, d_conv - 1, conv_dim), both bf16, written by prefill and replaced
by each decode step.  The encdec family's cross K and V, (L, B, S_src,
Hkv, Dh) bf16, are computed once by prefill from the encoder's output and
read whole by each decode step (a second decode-kernel launch a layer,
``valid_len`` S_src, no window).

``LM`` refuses only the ``"dots"`` remat policy in training, with
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
from repro_torch.models.layers import (activation, apply_mrope, apply_rope,
                                       embed_def, embed_lookup, rmsnorm,
                                       rmsnorm_def, unembed_def)
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


def check_supported(cfg: ModelConfig, trainable: bool) -> None:
    """Refuse what the port's LM does not run yet: in training, a remat
    policy other than "none" and "full"."""
    if trainable and cfg.remat not in ("none", "full"):
        raise NotImplementedError(
            f"{cfg.name}: remat={cfg.remat!r} has no counterpart in "
            "torch (the port takes 'none' and 'full')")


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
    """RoPE, or M-RoPE with its three position rows equal to
    ``positions`` (B, S), as the reference's LM passes them."""
    if cfg.mrope_sections:
        pos3 = positions[None].expand(3, *positions.shape)
        return (apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta),
                apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta))
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


def _attn_block(cfg: ModelConfig, p, x, positions, window: int, *,
                causal: bool = True):
    """Full-sequence attention sub-block (training, prefill and the
    encoder, which is not causal).  Returns (out, (k, v)), the roped k and
    v for the cache."""
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, p, h)
    bpos = positions.expand(x.shape[0], -1)
    q, kr = _rope_qk(cfg, q, k, bpos)
    if (cfg.attn_impl == "flash" and causal and cfg.sliding_window == 0
            and cfg.local_global_ratio == 0):
        out = ops.flash_attention_bshd(q, kr, v, causal=True)
    else:
        out = mha_chunked(q, kr, v, q_positions=positions,
                          k_positions=positions, window=window, causal=causal,
                          chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k,
                          remat_chunks=cfg.attn_remat,
                          scores_bf16=cfg.attn_scores_bf16)
    return _out_proj(cfg, p, out), (kr, v)


def _cross_attn_block(cfg: ModelConfig, p, x, enc_out):
    """The encdec decoder's cross-attention to the encoder's output (no
    mask, no RoPE, the chunked path).  Returns (out, (k, v)), the cross K
    and V for the cache."""
    h = rmsnorm(x, p["cross_norm"], cfg.norm_eps)
    q = _proj(h, p["wq_c"])
    k, v = _proj(enc_out, p["wk_c"]), _proj(enc_out, p["wv_c"])
    out = mha_chunked(q, k, v,
                      q_positions=torch.arange(x.shape[1], device=x.device),
                      k_positions=torch.arange(enc_out.shape[1],
                                               device=x.device), window=0,
                      causal=False, chunk_q=cfg.attn_chunk_q,
                      chunk_k=cfg.attn_chunk_k)
    return _cross_out(p, out), (k, v)


def _cross_out(p, out):
    """(B, S, H, Dh) @ wo_c (H, Dh, d)."""
    H, Dh, d = p["wo_c"].shape
    return _proj(out.reshape(*out.shape[:-2], H * Dh),
                 p["wo_c"].reshape(H * Dh, d))


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


def _apply_block(cfg: ModelConfig, p, x, positions, window: int, *,
                 causal: bool = True, enc_out=None):
    """One block, training and prefill path (an encoder block with
    ``causal=False``; the encdec decoder's with ``enc_out``).  Returns (x,
    the family's cache seeds, the MoE aux loss or None): seeds (k, v) for
    dense and moe, (state, conv_tail) for ssm, (k, v, state, conv_tail)
    for hybrid, (k, v, cross_k, cross_v) for encdec."""
    if cfg.family == "ssm":
        h = rmsnorm(x, p["ssm_norm"], cfg.norm_eps)
        out, seeds = ssm_lib.apply_ssm(p, h, chunk=cfg.ssm_chunk,
                                       **_ssm_kw(cfg))
        return x + out, seeds, None
    attn_out, kv = _attn_block(cfg, p, x, positions, window, causal=causal)
    if cfg.family == "hybrid":
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        ssm_out, seeds = ssm_lib.apply_ssm(p, h, chunk=cfg.ssm_chunk,
                                           **_ssm_kw(cfg))
        x = x + _branch_mix(cfg, p, attn_out, ssm_out)
        return x + _mlp_block(cfg, p, x), kv + seeds, None
    x = x + attn_out
    if enc_out is not None:
        out, cross_kv = _cross_attn_block(cfg, p, x, enc_out)
        x = x + out
        kv = kv + cross_kv
    if cfg.family == "moe":
        out, aux = _moe_block(cfg, p, x, cfg.capacity_factor)
        return x + out, kv, aux["moe_aux_loss"]
    return x + _mlp_block(cfg, p, x), kv, None


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

CACHE_LEAVES = {"dense": ("k", "v"), "moe": ("k", "v"),
                "ssm": ("state", "conv"),
                "hybrid": ("k", "v", "state", "conv"),
                "encdec": ("k", "v", "cross_k", "cross_v")}


def _layer_views(blocks, n: int) -> list[dict]:
    return [{k: w[i] for k, w in blocks.items()} for i in range(n)]


class LM(nn.Module):
    """The LM: the training forward, prefill and decode.

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
        check_supported(cfg, trainable)
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
        # the encdec family's encoder: the decoder's blocks as the dense
        # family without post-norms (the reference's ``enc_cfg``)
        self.enc_cfg = None
        self.enc_blocks = self.enc_final_norm = None
        if cfg.family == "encdec":
            self.enc_cfg = dataclasses.replace(cfg, family="dense",
                                               post_norms=False)
            self.enc_blocks = nn.ParameterDict(tree["enc_blocks"])
            self.enc_final_norm = tree["enc_final_norm"]
        # serving: per-layer views of the stacked tensors, made once (the
        # decode loop is host-bound; views of parameters that are never
        # replaced).  Training slices layer i inside the graph on every
        # forward, so no view carries autograd state across steps.
        self._layers = self._enc_layers = None
        if not trainable:
            self._layers = _layer_views(self.blocks, cfg.num_layers)
            if self.enc_blocks is not None:
                self._enc_layers = _layer_views(self.enc_blocks,
                                                cfg.encoder_layers)
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
        ``final_norm``, ``blocks``, ``unembed`` when untied, ``enc_blocks``
        and ``enc_final_norm`` for encdec): what the optimizer updates in
        place."""
        tree = {"embed": self.embed, "final_norm": self.final_norm,
                "blocks": dict(self.blocks)}
        if self.unembed is not None:
            tree["unembed"] = self.unembed
        if self.enc_blocks is not None:
            tree["enc_blocks"] = dict(self.enc_blocks)
            tree["enc_final_norm"] = self.enc_final_norm
        return tree

    def _layer(self, i: int) -> dict:
        if self._layers is not None:
            return self._layers[i]
        return {k: w[i] for k, w in self.blocks.items()}

    def _enc_layer(self, i: int) -> dict:
        if self._enc_layers is not None:
            return self._enc_layers[i]
        return {k: w[i] for k, w in self.enc_blocks.items()}

    def _embed(self, x):
        """Token ids, or (with ``cfg.embeds_input``) float embeddings
        taken as they are, in the compute dtype."""
        if self.cfg.embeds_input and x.is_floating_point():
            x = x.to(COMPUTE_DTYPE)
        else:
            x = embed_lookup(self.embed, x, COMPUTE_DTYPE)
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

    def _enc_block(self, x, positions, i: int):
        return _apply_block(self.enc_cfg, self._enc_layer(i), x, positions,
                            -1, causal=False)[0]

    def _encode(self, batch: dict):
        """The encdec family's encoder over ``batch["src_embeds"]`` (B,
        S_src, d): the non-causal stack, then ``enc_final_norm``; None for
        the other families.  Under ``remat == "full"`` in training each
        block is recomputed in the backward, as the decoder's."""
        if self.enc_cfg is None:
            return None
        x = batch["src_embeds"].to(COMPUTE_DTYPE)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        remat = self.cfg.remat == "full" and torch.is_grad_enabled()
        for i in range(self.cfg.encoder_layers):
            if remat:
                x = checkpoint(self._enc_block, x, positions, i,
                               use_reentrant=False)
            else:
                x = self._enc_block(x, positions, i)
        return rmsnorm(x, self.enc_final_norm, self.cfg.norm_eps)

    def _train_block(self, x, positions, i: int, enc_out):
        x, _, aux = _apply_block(self.cfg, self._layer(i), x, positions,
                                 self._windows[i], enc_out=enc_out)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux

    def forward(self, batch: dict):
        """Training forward: ``batch["tokens"]`` (B, S) or
        ``batch["embeds"]`` (B, S, d), and ``batch["src_embeds"]`` for
        encdec -> (logits (B, S, V) float32, {"moe_aux_loss": the layers'
        summed load-balancing losses, 0 outside the moe family}), the
        reference's ``LM.forward``.  With ``cfg.remat == "full"`` each
        block is recomputed in the backward."""
        enc_out = self._encode(batch)
        x = self._embed(batch.get("embeds", batch.get("tokens")))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        auxes = []
        for i in range(self.cfg.num_layers):
            if self.cfg.remat == "full":
                x, aux = checkpoint(self._train_block, x, positions, i,
                                    enc_out, use_reentrant=False)
            else:
                x, aux = self._train_block(x, positions, i, enc_out)
            auxes.append(aux)
        return self._logits(x), {"moe_aux_loss": torch.stack(auxes).sum()}

    def init_cache(self, B: int, S: int, src_len: int = 0) -> dict:
        """A zero bf16 cache of the family's leaves on the model's device:
        K and V (L, B, S, Hkv, Dh); the SSM state (L, B, H, P, N) and conv
        tail (L, B, d_conv - 1, conv_dim), which do not depend on S; the
        cross K and V (L, B, ``src_len``, Hkv, Dh)."""
        cfg = self.cfg
        L = cfg.num_layers
        kv = (L, B, S, cfg.num_kv_heads, cfg.head_dim)
        cross = (L, B, src_len, cfg.num_kv_heads, cfg.head_dim)
        shapes = {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}
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
        """Forward over the prompt (``tokens`` or ``embeds``; the encdec
        family's encoder over ``src_embeds``), writing each layer's cache
        seeds into a fresh cache: K and V at the first S of ``cache_len``
        positions (default: the prompt length), the SSM state and conv
        tail whole, the cross K and V at the source's S_src positions.
        Returns (last-position logits (B, 1, V) float32, cache)."""
        enc_out = self._encode(batch)
        x = self._embed(batch.get("embeds", batch.get("tokens")))
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        cache = self.init_cache(B, S if cache_len is None else cache_len,
                                0 if enc_out is None else enc_out.shape[1])
        for i, window in enumerate(self._windows):
            x, seeds, _ = _apply_block(self.cfg, self._layer(i), x,
                                       positions, window, enc_out=enc_out)
            for name, seed in zip(CACHE_LEAVES[self.cfg.family], seeds):
                if name in ("k", "v"):
                    cache[name][i, :, :S] = seed
                else:
                    cache[name][i] = seed
        return self._logits(x[:, -1:, :]), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, position: int):
        """One-token decode: token ids (B, 1) or, with
        ``cfg.embeds_input``, embeddings (B, 1, d); ``position`` is the
        host int index the new K and V are written at (attention sees [0,
        position]); the SSM state and conv tail advance one step; the
        encdec family attends to its whole cross K and V.  Updates
        ``cache`` in place; returns (logits (B, 1, V) float32, cache)."""
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
            if cfg.family == "encdec":
                xk, xv = cache["cross_k"][i], cache["cross_v"][i]
                qc = _proj(rmsnorm(x, p["cross_norm"], cfg.norm_eps),
                           p["wq_c"])
                out = decode_attention_local(qc[:, 0], xk, xv, xk.shape[1],
                                             window=0)
                x = x + _cross_out(p, out[:, None])
            if cfg.family == "moe":
                out, _ = _moe_block(cfg, p, x, max(2.0, cfg.capacity_factor))
                x = x + out
            else:
                x = x + _mlp_block(cfg, p, x)
        return self._logits(x), cache
