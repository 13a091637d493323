"""The LM: parameters, the training forward, prefill and greedy decode of
every family: dense, moe, ssm, hybrid and encdec.

The port of the reference's ``repro/models/transformer.py``: the model
runs whole on its device (a data-parallel mesh shards the training state
around it, ``train.steps``; the sequence-sharded decode splits its cache,
below), or tensor-parallel over a process mesh's ``model`` axis (``LM(...,
mesh=)``: each rank holds the ``model`` shard of each leaf that the
reference's rules split, and the layers insert the sums over the axis
that the reference's partitioner inserts; ``distributed.sharding.
TensorParallel``), without the reference's activation sharding
constraints.
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
``cfg.remat == "dots"`` is the reference's ``jax.checkpoint`` under
``checkpoint_dots_with_no_batch_dims``: each block's products without
batch dims (the projections, ``aten.mm``: ``_proj`` and the MoE router)
are saved and everything else (elementwise ops, attention scores, the
MoE's expert products, which are batched over experts) is recomputed,
through ``torch.utils.checkpoint`` with a selective-checkpoint policy
(``_dots_policy``).  The CUDA kernels launch outside the dispatcher, so
the policy never sees them: the flash forward is recomputed, as the
reference's policy does not save a ``pallas_call`` either.
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

Decode on a process mesh (``build_serve_step(model, mesh)``) takes the
reference's sequence-sharded path exactly where the reference does: the
mesh's ``model`` axis larger than 1 and dividing the cache's S.  Each
rank holds its slice of the K/V cache on S, only the rank that owns
``position`` writes the new K and V, and each rank's online-softmax
partials are combined across the ``model`` ranks
(``attention.sharded_decode_attention``), over every q and kv head (a
tensor-parallel model gathers its heads first, the reference's
whole-head ``qspec``).  A tensor-parallel model whose ``model`` axis does
not divide S decodes through the decode kernel on each rank's own heads,
its cache holding the kv heads they read.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import (NO_TP, ShardingRules,
                                              TensorParallel, take_groups)
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import (decode_attention_local,
                                          mha_chunked,
                                          sharded_decode_attention)
from repro_torch.models.layers import (activation, apply_mrope, apply_rope,
                                       embed_def, embed_lookup, rmsnorm,
                                       rmsnorm_def, unembed_def)
from repro_torch.models.params import (ParamDef, abstract_params,
                                       count_params, fake_params,
                                       init_params, tree_map)
from repro_torch.models.registry import ModelConfig

COMPUTE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# Parameter definitions (every family): shapes and the reference's logical
# axes
# ---------------------------------------------------------------------------

_QKV = ("layers", "embed", "heads", "qkv")
_KV = ("layers", "embed", "kv_heads", "qkv")
_WO = ("layers", "heads", "qkv", "embed")

def _attn_defs(cfg: ModelConfig, L: int) -> dict[str, ParamDef]:
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "attn_norm": rmsnorm_def(d, L),
        "wq": ParamDef((L, d, H, Dh), logical_axes=_QKV),
        "wk": ParamDef((L, d, Hkv, Dh), logical_axes=_KV),
        "wv": ParamDef((L, d, Hkv, Dh), logical_axes=_KV),
        "wo": ParamDef((L, H, Dh, d), fan_in_axes=(1, 2), logical_axes=_WO),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((L, H, Dh), init="zeros",
                              logical_axes=("layers", "heads", "qkv"))
        defs["bk"] = ParamDef((L, Hkv, Dh), init="zeros",
                              logical_axes=("layers", "kv_heads", "qkv"))
        defs["bv"] = ParamDef((L, Hkv, Dh), init="zeros",
                              logical_axes=("layers", "kv_heads", "qkv"))
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((L, Dh), init="ones",
                                  logical_axes=("layers", "qkv"))
        defs["k_norm"] = ParamDef((L, Dh), init="ones",
                                  logical_axes=("layers", "qkv"))
    if cfg.post_norms:
        defs["post_attn_norm"] = rmsnorm_def(d, L)
    return defs


def _mlp_defs(cfg: ModelConfig, L: int) -> dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    defs = {
        "mlp_norm": rmsnorm_def(d, L),
        "w_gate": ParamDef((L, d, f), logical_axes=("layers", "embed", "mlp")),
        "w_up": ParamDef((L, d, f), logical_axes=("layers", "embed", "mlp")),
        "w_down": ParamDef((L, f, d), logical_axes=("layers", "mlp", "embed")),
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
        "wq_c": ParamDef((L, d, H, Dh), logical_axes=_QKV),
        "wk_c": ParamDef((L, d, Hkv, Dh), logical_axes=_KV),
        "wv_c": ParamDef((L, d, Hkv, Dh), logical_axes=_KV),
        "wo_c": ParamDef((L, H, Dh, d), fan_in_axes=(1, 2), logical_axes=_WO),
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


def cache_defs(cfg: ModelConfig, B: int, S: int) -> dict:
    """The reference's ``ParamDef`` tree of the decode cache at batch B and
    S positions (shapes, bf16, the logical axes that place it on a mesh):
    K and V (L, B, S, Hkv, Dh) on ("layers", "kv_batch", "kv_seq"); the
    SSM state (L, B, H, P, N) on ("layers", "kv_batch", "ssm_head") and
    conv tail (L, B, d_conv - 1, conv_dim); the encdec family's cross K
    and V (L, B, max(1, S // enc_seq_divisor), Hkv, Dh) on ("layers",
    "kv_batch", "enc_seq").  ``LM.init_cache`` allocates a rank's cache;
    this describes the whole one."""
    L, Hkv, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zeros(shape, axes):
        return ParamDef(tuple(shape), dtype=COMPUTE_DTYPE, init="zeros",
                        logical_axes=axes)

    kv_axes = ("layers", "kv_batch", "kv_seq", None, None)
    defs = {}
    if cfg.family in ("dense", "moe", "hybrid", "encdec"):
        defs["k"] = zeros((L, B, S, Hkv, Dh), kv_axes)
        defs["v"] = zeros((L, B, S, Hkv, Dh), kv_axes)
    if cfg.family in ("ssm", "hybrid"):
        P = cfg.d_inner // cfg.ssm_heads
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        defs["state"] = zeros((L, B, cfg.ssm_heads, P, cfg.ssm_state),
                              ("layers", "kv_batch", "ssm_head", None, None))
        defs["conv"] = zeros((L, B, cfg.d_conv - 1, conv_dim),
                             ("layers", "kv_batch", None, None))
    if cfg.family == "encdec":
        enc_S = max(1, S // cfg.enc_seq_divisor)
        cross = ("layers", "kv_batch", "enc_seq", None, None)
        defs["cross_k"] = zeros((L, B, enc_S, Hkv, Dh), cross)
        defs["cross_v"] = zeros((L, B, enc_S, Hkv, Dh), cross)
    return defs


# ---------------------------------------------------------------------------
# Remat: "full" recomputes a block, "dots" saves its no-batch products
# ---------------------------------------------------------------------------

# the products a "dots" block saves: the reference's dot_generals without
# batch dims, which reach these ops and only these (a batched einsum
# reaches aten.bmm)
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: save the no-batch
    products' outputs, recompute the rest."""
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(policy: str, fn, *args):
    """``fn(*args)`` under the block remat ``policy`` ("none", "full" or
    "dots")."""
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    if policy != "none":
        raise ValueError(f"remat={policy!r}: not one of none, full, dots")
    return fn(*args)


# ---------------------------------------------------------------------------
# Block application (``p`` is one layer's slice of the stacked parameters)
# ---------------------------------------------------------------------------

def _proj(x, w):
    """einsum "bsd,d...->bs..." as one matmul in x's dtype."""
    d = w.shape[0]
    out = x.reshape(-1, d) @ w.reshape(d, -1).to(x.dtype)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _kv_pick(cfg: ModelConfig, tp: TensorParallel, q_name: str = "wq",
             kv_name: str = "wk"):
    """The kv heads that this rank's q heads read
    (``TensorParallel.group_pick``) where the rules split the q heads and
    keep the kv heads whole; None where each rank reads the kv heads it
    holds."""
    if not tp.sharded(q_name) or tp.sharded(kv_name):
        return None
    return tp.group_pick(cfg.num_heads, cfg.num_kv_heads)


def _attn_kv(cfg: ModelConfig, tp: TensorParallel, k, v, q_name="wq",
             kv_name="wk"):
    """The k and v that this rank's q heads attend to: as they are, or,
    where the q heads are split and k and v whole on every rank, their
    gradient summed over the ranks (each rank's q heads read a part) and
    the kv heads picked (``_kv_pick``)."""
    pick = _kv_pick(cfg, tp, q_name, kv_name)
    if pick is None:
        return k, v
    return (take_groups(tp.enter(k), pick, 2),
            take_groups(tp.enter(v), pick, 2))


def _col_in(tp: TensorParallel, x, name: str):
    """The input of a product by the leaf ``name``: ``x`` entering the
    rank's own region where that leaf is split on its output dim."""
    return tp.enter(x) if tp.sharded(name) else x


def _project_qkv(cfg: ModelConfig, p, x, tp: TensorParallel = None):
    """q, k, v of the normalized input ``x``: q on this rank's heads and
    k, v on its kv heads where the rules split them (column-parallel),
    whole where they do not."""
    tp = tp or NO_TP
    xq = _col_in(tp, x, "wq")
    xkv = xq if tp.sharded("wk") else x
    q, k, v = _proj(xq, p["wq"]), _proj(xkv, p["wk"]), _proj(xkv, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        # a whole norm scale on the rank's own heads: its gradient there
        # is a part
        q = rmsnorm(q, _col_in(tp, p["q_norm"], "wq"), cfg.norm_eps)
        k = rmsnorm(k, _col_in(tp, p["k_norm"], "wk"), cfg.norm_eps)
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


def _row_out(tp: TensorParallel, y, w, name: str):
    """``y @ w`` for the leaf ``w`` named ``name``: where the rules split
    its contraction dim, this rank's partial product summed over the
    ranks (row-parallel; ``y`` is taken at the rank's block where it is
    whole), else the whole product."""
    if not tp.sharded(name):
        return _proj(y, w)
    n = w.shape[0]
    if y.shape[-1] != n:      # a whole input: the rank's block of it
        lo = tp.rank * n
        y = tp.enter(y)[..., lo:lo + n]
    return tp.exit(_proj(y, w))


def _out_proj(cfg: ModelConfig, p, out, tp: TensorParallel = None):
    """(B, S, H, Dh) @ wo (H, Dh, d), then the post-attention norm (on a
    split ``wo``: the rank's heads, summed over the ranks)."""
    H, Dh, d = p["wo"].shape
    out = _row_out(tp or NO_TP, out.reshape(*out.shape[:-2], -1),
                   p["wo"].reshape(H * Dh, d), "wo")
    if cfg.post_norms:
        out = rmsnorm(out, p["post_attn_norm"], cfg.norm_eps)
    return out


def _attn_block(cfg: ModelConfig, p, x, positions, window: int, *,
                causal: bool = True, tp: TensorParallel = None):
    """Full-sequence attention sub-block (training, prefill and the
    encoder, which is not causal).  Returns (out, (k, v)), the roped k and
    v for the cache (on this rank's kv heads where the rules split them,
    else whole)."""
    tp = tp or NO_TP
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, p, h, tp)
    bpos = positions.expand(x.shape[0], -1)
    q, kr = _rope_qk(cfg, q, k, bpos)
    ka, va = _attn_kv(cfg, tp, kr, v)
    if (cfg.attn_impl == "flash" and causal and cfg.sliding_window == 0
            and cfg.local_global_ratio == 0):
        out = ops.flash_attention_bshd(q, ka, va, causal=True)
    else:
        out = mha_chunked(q, ka, va, q_positions=positions,
                          k_positions=positions, window=window, causal=causal,
                          chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k,
                          remat_chunks=cfg.attn_remat,
                          scores_bf16=cfg.attn_scores_bf16)
    return _out_proj(cfg, p, out, tp), (kr, v)


def _cross_attn_block(cfg: ModelConfig, p, x, enc_out,
                      tp: TensorParallel = None):
    """The encdec decoder's cross-attention to the encoder's output (no
    mask, no RoPE, the chunked path).  Returns (out, (k, v)), the cross K
    and V for the cache (the kv heads this rank's q heads read)."""
    tp = tp or NO_TP
    h = rmsnorm(x, p["cross_norm"], cfg.norm_eps)
    q = _proj(_col_in(tp, h, "wq_c"), p["wq_c"])
    e = _col_in(tp, enc_out, "wk_c")
    k, v = _attn_kv(cfg, tp, _proj(e, p["wk_c"]), _proj(e, p["wv_c"]),
                    "wq_c", "wk_c")
    out = mha_chunked(q, k, v,
                      q_positions=torch.arange(x.shape[1], device=x.device),
                      k_positions=torch.arange(enc_out.shape[1],
                                               device=x.device), window=0,
                      causal=False, chunk_q=cfg.attn_chunk_q,
                      chunk_k=cfg.attn_chunk_k)
    return _cross_out(p, out, tp), (k, v)


def _cross_out(p, out, tp: TensorParallel = None):
    """(B, S, H, Dh) @ wo_c (H, Dh, d)."""
    H, Dh, d = p["wo_c"].shape
    return _row_out(tp or NO_TP, out.reshape(*out.shape[:-2], -1),
                    p["wo_c"].reshape(H * Dh, d), "wo_c")


def _mlp_block(cfg: ModelConfig, p, x, tp: TensorParallel = None):
    """The gated MLP: gate and up column-parallel, down row-parallel
    where the rules split ``mlp``."""
    tp = tp or NO_TP
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    hi = _col_in(tp, h, "w_gate")
    g = activation(cfg.act)(_proj(hi, p["w_gate"]))
    out = _row_out(tp, g * _proj(hi, p["w_up"]), p["w_down"], "w_down")
    if cfg.post_norms:
        out = rmsnorm(out, p["post_mlp_norm"], cfg.norm_eps)
    return out


def _ssm_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
                d_conv=cfg.d_conv, n_groups=cfg.ssm_groups)


def _ssm_decode(cfg: ModelConfig, p, h, cache: dict, i: int,
                tp: TensorParallel = None):
    """The SSM mixer's decode step on layer ``i``'s state and conv tail,
    which it replaces in ``cache``; returns the mixer's output."""
    out, cache["state"][i], cache["conv"][i] = ssm_lib.apply_ssm_decode(
        p, h, cache["state"][i], cache["conv"][i], tp=tp, **_ssm_kw(cfg))
    return out


def _branch_mix(cfg: ModelConfig, p, attn_out, ssm_out):
    """The hybrid block's mean of its two normalized branches."""
    return 0.5 * (rmsnorm(attn_out, p["attn_branch_norm"], cfg.norm_eps)
                  + rmsnorm(ssm_out, p["ssm_branch_norm"], cfg.norm_eps))


def _moe_block(cfg: ModelConfig, p, x, capacity_factor: float,
               tp: TensorParallel = None):
    """The moe family's feed-forward: (out, {"moe_aux_loss": ...})."""
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return moe_lib.apply_moe(p, h, top_k=cfg.experts_per_token,
                             capacity_factor=capacity_factor,
                             act=activation(cfg.act), routing=cfg.routing,
                             groups=cfg.moe_groups, tp=tp)


def _apply_block(cfg: ModelConfig, p, x, positions, window: int, *,
                 causal: bool = True, enc_out=None,
                 tp: TensorParallel = None):
    """One block, training and prefill path (an encoder block with
    ``causal=False``; the encdec decoder's with ``enc_out``).  Returns (x,
    the family's cache seeds, the MoE aux loss or None): seeds (k, v) for
    dense and moe, (state, conv_tail) for ssm, (k, v, state, conv_tail)
    for hybrid, (k, v, cross_k, cross_v) for encdec.  ``tp``: the
    ``model`` axis that splits ``p``'s leaves (default: none)."""
    tp = tp or NO_TP
    if cfg.family == "ssm":
        h = rmsnorm(x, p["ssm_norm"], cfg.norm_eps)
        out, seeds = ssm_lib.apply_ssm(p, h, chunk=cfg.ssm_chunk, tp=tp,
                                       **_ssm_kw(cfg))
        return x + out, seeds, None
    attn_out, kv = _attn_block(cfg, p, x, positions, window, causal=causal,
                               tp=tp)
    if cfg.family == "hybrid":
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        ssm_out, seeds = ssm_lib.apply_ssm(p, h, chunk=cfg.ssm_chunk, tp=tp,
                                           **_ssm_kw(cfg))
        x = x + _branch_mix(cfg, p, attn_out, ssm_out)
        return x + _mlp_block(cfg, p, x, tp), kv + seeds, None
    x = x + attn_out
    if enc_out is not None:
        out, cross_kv = _cross_attn_block(cfg, p, x, enc_out, tp)
        x = x + out
        kv = kv + cross_kv
    if cfg.family == "moe":
        out, aux = _moe_block(cfg, p, x, cfg.capacity_factor, tp)
        return x + out, kv, aux["moe_aux_loss"]
    return x + _mlp_block(cfg, p, x, tp), kv, None


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def abstract_lm(cfg: ModelConfig, mesh=None,
                rules: ShardingRules | None = None, *, device="cuda",
                dtype: torch.dtype | None = None,
                trainable: bool = False) -> "LM":
    """The ``LM`` that a rank of ``mesh`` builds (``LM(cfg, mesh=mesh,
    ...)``: its ``model`` shards, tensor-parallel), with fake parameters
    in ``dtype`` (default: float32, the master weights; the serve entry
    point draws bf16) instead of drawn ones: no weight is drawn and no
    memory is held (``params.fake_params``).  For the dry-run, which
    runs its steps on fake tensors."""
    tp = TensorParallel.of(build_defs(cfg), mesh, rules)
    params = fake_params(build_defs(cfg), device, dtype, tp)
    return LM(cfg, params, device=device, trainable=trainable, mesh=mesh,
              rules=rules)


def seq_shards(mesh, S: int) -> int:
    """The ranks the decode splits a cache of S positions over: the
    mesh's ``model`` size where it is larger than 1 and divides S (the
    reference's condition), else 1."""
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return 1
    n = mesh.shape[mesh.mesh_dim_names.index("model")]
    return n if n > 1 and S % n == 0 else 1


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
    trains them.

    On a ``mesh`` (a ``DeviceMesh`` with a ``model`` axis larger than 1)
    the model is tensor-parallel: each rank holds the ``model`` shard of
    each leaf that ``logical_to_spec`` splits under ``rules`` (default:
    the reference's), drawn as that block of the seed's leaf or sliced
    out of a whole ``params`` tree, and the layers insert the sums over
    the axis that the reference's partitioner inserts
    (``distributed.sharding.TensorParallel``)."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 seed: int = 0, device="cuda", trainable: bool = False,
                 mesh=None, rules: ShardingRules | None = None):
        super().__init__()
        self.cfg = cfg
        self.defs = build_defs(cfg)
        self.mesh = mesh
        self.tp = TensorParallel.of(self.defs, mesh, rules)
        if params is None:
            params = init_params(self.defs, seed=seed, device=device,
                                 tp=self.tp)
        else:
            params = self._local_tree(params, self.defs)
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

    def _local_tree(self, tree: dict, defs: dict) -> dict:
        """``tree`` with each leaf that ``self.tp`` splits cut to this
        rank's shard (a leaf already cut is kept)."""
        out = {}
        for k, t in tree.items():
            if isinstance(t, dict):
                out[k] = self._local_tree(t, defs[k])
                continue
            dim = self.tp.dims.get(k)
            whole = self.tp.sharded(k) and t.shape[dim] == defs[k].shape[dim]
            out[k] = self.tp.local(k, t).contiguous() if whole else t
        return out

    def param_count(self) -> int:
        """Parameters of the whole model (every leaf of ``defs``, whatever
        this rank holds)."""
        return count_params(self.defs)

    def abstract(self, mesh, rules: ShardingRules | None = None) -> dict:
        """The parameter tree as this rank of ``mesh`` holds it in the
        sharded training state, without weights or memory: each leaf a
        DTensor with the placements ``rules`` (default: the reference's)
        give it and a fake local shard (``params.abstract_params``)."""
        return abstract_params(self.defs, rules or ShardingRules.default(),
                               mesh, self.embed.device)

    def cache_defs(self, B: int, S: int) -> dict:
        """The reference's ``ParamDef`` tree of the decode cache
        (``cache_defs``)."""
        return cache_defs(self.cfg, B, S)

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
        taken as they are, in the compute dtype.  On a vocab-split table
        each rank looks up the ids it holds and the rows are summed over
        the ranks."""
        if self.cfg.embeds_input and x.is_floating_point():
            x = x.to(COMPUTE_DTYPE)
        else:
            x = embed_lookup(self.embed, x, COMPUTE_DTYPE, self.tp)
        if self.cfg.embed_scale:
            x = x * self._embed_scale
        return x

    def vocab_split(self) -> bool:
        """Whether the logits' vocab is split over the ``model`` ranks."""
        return self.tp.sharded("embed" if self.cfg.tie_embeddings
                               else "unembed")

    def _logits(self, x, whole: bool = True):
        """float32 logits (B, S, V) of the last hidden states, computed in
        the compute dtype; on a vocab-split table this rank's block of V,
        gathered whole over the ranks unless ``whole`` is False."""
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        split = self.vocab_split()
        if split:
            x = self.tp.enter(x)
        if self.cfg.tie_embeddings:
            w = self.embed.to(COMPUTE_DTYPE)             # (V, d)
            logits = x @ w.T
        else:
            logits = x @ self.unembed.to(COMPUTE_DTYPE)
        if split and whole:
            logits = self.tp.gather(logits, -1)
        return logits.float()

    def _enc_block(self, x, positions, i: int):
        return _apply_block(self.enc_cfg, self._enc_layer(i), x, positions,
                            -1, causal=False, tp=self.tp)[0]

    def _encode(self, batch: dict):
        """The encdec family's encoder over ``batch["src_embeds"]`` (B,
        S_src, d): the non-causal stack, then ``enc_final_norm``; None for
        the other families.  In training each block is rematerialized
        under ``cfg.remat``, as the decoder's."""
        if self.enc_cfg is None:
            return None
        x = batch["src_embeds"].to(COMPUTE_DTYPE)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        remat = self.cfg.remat if torch.is_grad_enabled() else "none"
        for i in range(self.cfg.encoder_layers):
            x = _remat(remat, self._enc_block, x, positions, i)
        return rmsnorm(x, self.enc_final_norm, self.cfg.norm_eps)

    def _train_block(self, x, positions, i: int, enc_out):
        x, _, aux = _apply_block(self.cfg, self._layer(i), x, positions,
                                 self._windows[i], enc_out=enc_out,
                                 tp=self.tp)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux

    def forward(self, batch: dict, whole_logits: bool = True):
        """Training forward: ``batch["tokens"]`` (B, S) or
        ``batch["embeds"]`` (B, S, d), and ``batch["src_embeds"]`` for
        encdec -> (logits (B, S, V) float32, {"moe_aux_loss": the layers'
        summed load-balancing losses, 0 outside the moe family}), the
        reference's ``LM.forward``.  Each block is rematerialized under
        ``cfg.remat``: "full" recomputes it in the backward, "dots" keeps
        its no-batch products' outputs and recomputes the rest.  With
        ``whole_logits`` False a vocab-split model returns this rank's
        block of V (the vocab-parallel cross-entropy's input)."""
        enc_out = self._encode(batch)
        x = self._embed(batch.get("embeds", batch.get("tokens")))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        auxes = []
        for i in range(self.cfg.num_layers):
            x, aux = _remat(self.cfg.remat, self._train_block, x, positions,
                            i, enc_out)
            auxes.append(aux)
        return (self._logits(x, whole_logits),
                {"moe_aux_loss": torch.stack(auxes).sum()})

    def _kv_heads(self) -> int:
        """The kv heads this rank's attention reads (its cache holds them
        outside the sequence-sharded decode)."""
        cfg, pick = self.cfg, _kv_pick(self.cfg, self.tp)
        if pick is None:
            return cfg.num_kv_heads // (self.tp.size if self.tp.sharded("wk")
                                        else 1)
        return pick.stop - pick.start if isinstance(pick, slice) \
            else len(pick)

    def init_cache(self, B: int, S: int, src_len: int = 0,
                   whole_kv: bool = False) -> dict:
        """A zero bf16 cache of the family's leaves on the model's device:
        K and V (L, B, S, Hkv, Dh); the SSM state (L, B, H, P, N) and conv
        tail (L, B, d_conv - 1, conv_dim), which do not depend on S; the
        cross K and V (L, B, ``src_len``, Hkv, Dh).  On a tensor-parallel
        model the heads and channels are this rank's (``Hkv`` the kv heads
        its attention reads, or every kv head with ``whole_kv``: the
        sequence-sharded decode's)."""
        cfg, tp = self.cfg, self.tp
        L = cfg.num_layers
        hkv = cfg.num_kv_heads if whole_kv else self._kv_heads()
        kv = (L, B, S, hkv, cfg.head_dim)
        cross = (L, B, src_len, self._kv_heads(), cfg.head_dim)
        shapes = {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}
        if cfg.ssm_heads:
            H = cfg.ssm_heads // (tp.size if tp.sharded("A_log") else 1)
            P = cfg.d_inner // cfg.ssm_heads
            shapes["state"] = (L, B, H, P, cfg.ssm_state)
            shapes["conv"] = (L, B, cfg.d_conv - 1,
                              H * P + 2 * cfg.ssm_groups * cfg.ssm_state)
        return {n: torch.zeros(shapes[n], dtype=COMPUTE_DTYPE,
                               device=self.embed.device)
                for n in CACHE_LEAVES[cfg.family]}

    @torch.no_grad()
    def prefill(self, batch: dict, cache_len: int | None = None, mesh=None):
        """Forward over the prompt (``tokens`` or ``embeds``; the encdec
        family's encoder over ``src_embeds``), writing each layer's cache
        seeds into a fresh cache: K and V at the first S of ``cache_len``
        positions (default: the prompt length), the SSM state and conv
        tail whole, the cross K and V at the source's S_src positions.
        On a ``mesh`` (a tensor-parallel model's own by default) whose
        decode shards the sequence (``seq_shards``) the K and V hold every
        kv head and come back as DTensors split on S (``shard_cache``).
        Returns (last-position logits (B, 1, V) float32, cache)."""
        mesh = mesh if mesh is not None else self.mesh
        enc_out = self._encode(batch)
        x = self._embed(batch.get("embeds", batch.get("tokens")))
        B, S = x.shape[:2]
        S_total = S if cache_len is None else cache_len
        whole_kv = seq_shards(mesh, S_total) > 1
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        cache = self.init_cache(B, S_total,
                                0 if enc_out is None else enc_out.shape[1],
                                whole_kv)
        pick = _kv_pick(self.cfg, self.tp)
        for i, window in enumerate(self._windows):
            x, seeds, _ = _apply_block(self.cfg, self._layer(i), x,
                                       positions, window, enc_out=enc_out,
                                       tp=self.tp)
            for name, seed in zip(CACHE_LEAVES[self.cfg.family], seeds):
                if name in ("k", "v"):
                    if not whole_kv:
                        seed = take_groups(seed, pick, 2)
                    elif self.tp.sharded("wk"):
                        seed = self.tp.gather(seed, 2)
                    cache[name][i, :, :S] = seed
                else:
                    cache[name][i] = seed
        return self._logits(x[:, -1:, :]), self.shard_cache(cache, mesh)

    def shard_cache(self, cache: dict, mesh) -> dict:
        """``cache`` with its K and V split on S over ``mesh``'s ``model``
        ranks, as DTensors (this rank's slice copied out of the whole),
        where ``seq_shards`` says the decode shards them; as it is
        otherwise (no mesh, already split, or S not divisible)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        kv = cache.get("k")
        if mesh is None or kv is None or isinstance(kv, DTensor) \
                or seq_shards(mesh, kv.shape[2]) == 1:
            return cache
        n = seq_shards(mesh, kv.shape[2])
        idx = mesh.get_local_rank("model")
        pl = [Shard(2) if a == "model" else Replicate()
              for a in mesh.mesh_dim_names]
        out = dict(cache)
        for name in ("k", "v"):
            local = cache[name].chunk(n, dim=2)[idx].clone()
            out[name] = DTensor.from_local(local, mesh, pl)
        return out

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, position: int):
        """One-token decode: token ids (B, 1) or, with
        ``cfg.embeds_input``, embeddings (B, 1, d); ``position`` is the
        host int index the new K and V are written at (attention sees [0,
        position]); the SSM state and conv tail advance one step; the
        encdec family attends to its whole cross K and V.  K and V split
        on S over a mesh (``shard_cache``) take the sequence-sharded
        attention, on every q and kv head (a tensor-parallel model
        gathers its heads first, as the reference's whole-head ``qspec``
        does); otherwise the decode kernel runs on this rank's heads.
        Updates ``cache`` in place; returns (logits (B, 1, V) float32,
        cache)."""
        cfg, tp = self.cfg, self.tp
        kv = cache.get("k")
        sharded = None
        if hasattr(kv, "device_mesh"):                  # a DTensor
            sharded = sharded_decode_attention(kv.device_mesh)
            kv_local = {n: cache[n].to_local() for n in ("k", "v")}
        pick = _kv_pick(cfg, tp)
        x = self._embed(tokens)
        pos = torch.full((x.shape[0], 1), position, dtype=torch.int32,
                         device=x.device)
        for i, window in enumerate(self._windows):
            p = self._layer(i)
            if cfg.family == "ssm":
                h = rmsnorm(x, p["ssm_norm"], cfg.norm_eps)
                x = x + _ssm_decode(cfg, p, h, cache, i, tp)
                continue
            h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
            q, k_new, v_new = _project_qkv(cfg, p, h, tp)
            q, k_new = _rope_qk(cfg, q, k_new, pos)
            if sharded is not None:
                # every q and kv head, in one collective
                split = [t for t, n in ((q, "wq"), (k_new, "wk"),
                                        (v_new, "wv")) if tp.sharded(n)]
                whole = iter(tp.gather_many(split, 2))
                q, k_new, v_new = (next(whole) if tp.sharded(n) else t
                                   for t, n in ((q, "wq"), (k_new, "wk"),
                                                (v_new, "wv")))
                out = sharded(q[:, 0], k_new, v_new, kv_local["k"][i],
                              kv_local["v"][i], position, window)
            else:
                ck, cv = cache["k"][i], cache["v"][i]
                ck[:, position] = take_groups(k_new, pick, 2)[:, 0]
                cv[:, position] = take_groups(v_new, pick, 2)[:, 0]
                out = decode_attention_local(q[:, 0], ck, cv, position + 1,
                                             window=window)
            attn_out = _out_proj(cfg, p, out[:, None], tp)
            if cfg.family == "hybrid":
                # the SSM branch reads the same normalized input
                ssm_out = _ssm_decode(cfg, p, h, cache, i, tp)
                x = x + _branch_mix(cfg, p, attn_out, ssm_out)
                x = x + _mlp_block(cfg, p, x, tp)
                continue
            x = x + attn_out
            if cfg.family == "encdec":
                xk, xv = cache["cross_k"][i], cache["cross_v"][i]
                qc = _proj(rmsnorm(x, p["cross_norm"], cfg.norm_eps),
                           p["wq_c"])
                out = decode_attention_local(qc[:, 0], xk, xv, xk.shape[1],
                                             window=0)
                x = x + _cross_out(p, out[:, None], tp)
            if cfg.family == "moe":
                out, _ = _moe_block(cfg, p, x, max(2.0, cfg.capacity_factor),
                                    tp)
                x = x + out
            else:
                x = x + _mlp_block(cfg, p, x, tp)
        return self._logits(x), cache
