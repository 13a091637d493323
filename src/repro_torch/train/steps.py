"""Train, prefill and serve step builders of the port's LM.

The port of the reference's ``repro/train/steps.py``.  The parameters
live in the ``LM`` module, so the steps close over it instead of taking
a params tree.  ``train_step`` updates the parameters and the optimizer
moments in place (the reference's donated state) and returns its metrics
as tensors, so nothing waits for the device.

On a process mesh (``launch.mesh.make_device_mesh``) the training state
is sharded as the reference's rules shard it: each parameter and its
AdamW moments are DTensors with the placements that
``logical_to_spec(def.logical_axes, rules, mesh, def.shape)`` gives
(``embed`` dims over ``data``: ZeRO; ``heads``, ``kv_heads``, ``mlp``,
``vocab``, ``experts`` and ``ssm_head`` over ``model`` where they
divide).  The model is built on the same mesh (``LM(..., mesh=)``): its
parameters hold each leaf's ``model`` shard, whole over ``data``, and
its layers are tensor-parallel over ``model``.  Each step gathers each
leaf over the ``data`` ranks only into the module's parameters, runs the
forward and backward on this rank's rows of the batch, reduce-scatters
the gradients' mean over the ``data`` ranks onto the shards (DTensor
``Partial`` over ``data`` to the leaf's placements; each rank's
gradient of its ``model`` shard is already whole over ``model``: the
layers sum the parts over ``model`` where a whole tensor enters a
rank's shard) and updates the shards; the loss and aux metrics are
averaged over the ``data`` ranks, and the clip's norm is the global
one.  With microbatches, a rank runs its passes of
``data.tokens.microbatch_layout`` (its rows in ``rank_rows``' order):
every pass has the same size and every row lies on one rank, so the
mean over a rank's passes, averaged over the ranks, is the reference's
mean over microbatches with the sum reordered.  The MoE family routes
each of the reference's microbatches as the reference does, in its
``moe_groups`` dispatch groups, across the ``data`` ranks that hold it
(``moe.global_dispatch`` on ``sharding.microbatch_group``, each rank at
its place in the microbatch's token order, its rank in that group; the
whole group where the ranks divide a microbatch's rows), and runs each
rank's experts.  On a mesh with a "pod" axis (the production
mesh's two pods) the data-parallel ranks are pod x data, as the rules'
``batch`` maps the rows: the means, the metrics and the MoE's dispatch
span both axes.

``abstract_train_state`` builds the sharded state without weights or
memory (fake local shards), for the dry-run (``launch.dryrun``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.data.tokens import microbatch_layout
from repro_torch.distributed.sharding import (ShardingRules, batch_axes,
                                              batch_group, mesh_sizes,
                                              microbatch_group, model_slice,
                                              tree_placements)
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import LM
from repro_torch.models.params import tree_leaves
from repro_torch.optim.adamw import Optimizer

MOE_AUX_WEIGHT = 0.01


def cross_entropy(logits, labels):
    """logits: (B, S, V) float32; labels: (B, S) int.  The reference's
    baseline: the label's logit taken with a gather over the vocab."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def cross_entropy_sharded(logits, labels):
    """The reference's vocab-parallel form: the label's logit selected by
    an iota-compare mask and a sum over the vocab.  On one card it
    computes the same loss as ``cross_entropy``."""
    lse = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    picked = torch.where(vocab == labels.long()[..., None], logits, 0.0)
    return torch.mean(lse - picked.sum(dim=-1))


CE_IMPLS = {"gather": cross_entropy, "sharded": cross_entropy_sharded}


def cross_entropy_vocab_parallel(logits, labels, tp):
    """``cross_entropy_sharded`` on logits whose vocab ``tp`` splits:
    ``logits`` (B, S, V / M) is this rank's block.  The max over the
    vocab (no gradient: it cancels), the sum of exponentials and the
    label's logit (an iota-compare mask on the rank's block) are each
    summed over the ``model`` ranks."""
    m = tp.max(logits.amax(dim=-1))
    sumexp = tp.exit(torch.exp(logits - m[..., None]).sum(dim=-1))
    lo = tp.rank * logits.shape[-1]
    vocab = lo + torch.arange(logits.shape[-1], device=logits.device)
    picked = tp.exit(torch.where(vocab == labels.long()[..., None], logits,
                                 0.0).sum(dim=-1))
    return torch.mean(torch.log(sumexp) + m - picked)


def build_train_step(model: LM, optimizer: Optimizer, mesh=None,
                     rules: ShardingRules | None = None, *,
                     microbatches: int = 1, ce: str = "gather"):
    """Returns ``train_step(state, batch) -> (state, metrics)`` over the
    model's parameters (``state`` from ``init_train_state`` with the same
    ``mesh``).

    ``microbatches > 1`` splits the batch (every leaf: ``tokens`` or
    ``embeds``, ``src_embeds``, ``labels``) on its leading dim and sums the
    microbatches' gradients and metrics in order before dividing, as the
    reference's ``lax.scan`` does.  ``ce`` picks the cross-entropy
    ("gather" or "sharded").  Metrics: ``loss``, ``moe_aux``,
    ``grad_norm`` and ``lr``.  On a ``mesh`` (see the module docstring)
    ``batch`` is this rank's rows (``TokenPipeline.torch_batch(...,
    rank=, ranks=, microbatches=)``), split into the rank's passes of
    ``microbatch_layout`` instead (``microbatches`` of them where the
    data ranks divide a microbatch's rows), and ``rules`` (default: the
    reference's) are those ``init_train_state`` took."""
    ce_fn = CE_IMPLS[ce]
    dp = _DataParallel(model, mesh) if mesh is not None else None
    # vocab-parallel: the logits stay split over the model ranks
    split_ce = ce == "sharded" and model.vocab_split()

    def grad_fn(params: list, batch: dict):
        logits, aux = model(batch, whole_logits=not split_ce)
        if split_ce:
            loss = cross_entropy_vocab_parallel(logits, batch["labels"],
                                                model.tp)
        else:
            loss = ce_fn(logits, batch["labels"])
        moe_aux = aux["moe_aux_loss"]
        # a leaf the loss does not reach (the untied ``embed`` table under
        # an ``embeds`` batch) gets a zero gradient, as jax.value_and_grad
        # gives it
        grads = torch.autograd.grad(loss + MOE_AUX_WEIGHT * moe_aux, params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return grads, {"loss": loss.detach(), "moe_aux": moe_aux.detach()}

    def local_grads(params: list, batch: dict, passes: int):
        if passes == 1:
            grads, metrics = grad_fn(params, batch)
        else:
            mbs = {k: v.reshape(passes, v.shape[0] // passes, *v.shape[1:])
                   for k, v in batch.items()}
            grads, metrics = None, None
            for i in range(passes):
                g, m = grad_fn(params, {k: v[i] for k, v in mbs.items()})
                if grads is None:
                    grads, metrics = list(g), m
                    continue
                grads = [a + b for a, b in zip(grads, g)]
                metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = [g / passes for g in grads]
            metrics = {k: v / passes for k, v in metrics.items()}
        return grads, metrics

    def train_step(state: dict, batch: dict):
        tree = state["params"]
        if dp is None:
            grads, metrics = local_grads(tree_leaves(tree), batch,
                                         microbatches)
        else:
            grads, metrics = dp.grads(local_grads, tree, batch, microbatches)
        opt_metrics = optimizer.update(_unflatten(tree, iter(grads)),
                                       state["opt"], tree, state["step"])
        state["step"] += 1
        return state, dict(metrics, **opt_metrics)

    return train_step


def _unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves are taken from the
    iterator ``leaves`` in the reference's flatten order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


class _DataParallel:
    """The gather over ``data``, the gradients' reduce-scatter and the
    metrics' mean of a train step on a process mesh.  The data-parallel
    ranks are those of the mesh's batch axes (``sharding.batch_axes``:
    "data", and "pod" where the mesh has one, as the rules' ``batch``
    maps the rows): the gradients' mean, the metrics' and the MoE's global
    dispatch span them all.  With one data-parallel rank nothing crosses
    them (ranks that share a card run gloo, which serves only
    ``all_reduce`` and ``broadcast`` on CUDA tensors)."""

    def __init__(self, model: LM, mesh):
        _check_layout(model, mesh)
        self.model, self.mesh = model, mesh
        self.axes = batch_axes(mesh)
        self.group = batch_group(mesh)
        self.ranks = dist.get_world_size(self.group)

    def _data_whole(self, placements) -> list:
        from torch.distributed.tensor import Replicate

        return [Replicate() if a in self.axes else pl
                for a, pl in zip(self.mesh.mesh_dim_names, placements)]

    def grads(self, local_grads, tree: dict, batch: dict,
              microbatches: int):
        from torch.distributed.tensor import DTensor, Partial

        local = tree_leaves(self.model.param_tree())
        shards = tree_leaves(tree)
        with torch.no_grad():
            for f, sh in zip(local, shards):
                if self.ranks > 1:
                    sh = sh.redistribute(self.mesh,
                                         self._data_whole(sh.placements))
                f.copy_(sh.to_local())
        # each of the reference's microbatches is routed as one by the
        # ranks that hold it
        lay = microbatch_layout(batch["labels"].shape[0] * self.ranks,
                                microbatches, self.ranks)
        with moe_lib.global_dispatch(microbatch_group(self.mesh,
                                                      lay.share)):
            grads, metrics = local_grads(local, batch, lay.passes)
        if self.ranks == 1:
            grads = [DTensor.from_local(g, self.mesh, sh.placements,
                                        run_check=False, shape=sh.shape,
                                        stride=sh.stride())
                     for g, sh in zip(grads, shards)]
            return grads, metrics
        # the mean over the data ranks, scattered onto each leaf's shards
        grads = [DTensor.from_local(
                    g / self.ranks, self.mesh,
                    [Partial("sum") if a in self.axes else pl for a, pl in zip(
                        self.mesh.mesh_dim_names, sh.placements)],
                    run_check=False, shape=sh.shape, stride=sh.stride())
                 .redistribute(self.mesh, sh.placements)
                 for g, sh in zip(grads, shards)]
        metrics = dict(metrics)
        for k, v in metrics.items():
            v = v.clone()
            dist.all_reduce(v, group=self.group)
            metrics[k] = v / self.ranks
        return grads, metrics


def _check_layout(model: LM, mesh) -> None:
    if mesh_sizes(mesh).get("model", 1) > 1 and model.mesh is None:
        raise ValueError("a mesh with a 'model' axis larger than 1 trains "
                         "a tensor-parallel LM: build it with "
                         "LM(..., mesh=mesh)")


def init_train_state(model: LM, optimizer: Optimizer, mesh=None,
                     rules: ShardingRules | None = None) -> dict:
    """``{"params": ..., "opt": optimizer.init(...), "step": 0}``.
    Without a mesh the parameters are the model's own, updated in place.
    On a ``mesh`` each parameter is a DTensor holding this rank's shard
    of the model's leaf (the module holds its ``model`` shard, drawn from
    the seed: the reference's weights) under ``rules`` (default: the
    reference's), and the moments are sharded alike (see the module
    docstring)."""
    params = model.param_tree()
    if mesh is not None:
        _check_layout(model, mesh)
        params = shard_tree(params, tree_placements(
            model.defs, rules or ShardingRules.default(), mesh), mesh,
            model.defs)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def abstract_train_state(model: LM, optimizer: Optimizer, mesh,
                         rules: ShardingRules | None = None) -> dict:
    """``init_train_state``'s state without weights or memory, for the
    dry-run: the parameters as this rank's shards under ``rules``
    (``LM.abstract``: DTensors with fake local tensors) and the
    optimizer's moments made from them, sharded alike (what makes the
    AdamW moments ZeRO-sharded in the memory count), as the reference's
    ``abstract_train_state`` gives them.  Call it in a ``FakeTensorMode``
    (the moments are made by ``optimizer.init``)."""
    params = model.abstract(mesh, rules)
    return {"params": params, "opt": optimizer.init(params), "step": 0}


def shard_tree(tree: dict, placements: dict, mesh, defs: dict) -> dict:
    """Each leaf of ``tree`` (its ``model`` shard under ``placements``,
    or the whole leaf where ``model`` does not split it) as a DTensor of
    the ``ParamDef`` tree ``defs``' shape with its ``placements``, this
    rank's ``data`` shard copied out of it."""
    from torch.distributed.tensor import DTensor

    names = mesh.mesh_dim_names

    def one(t, pl, d):
        for axis, p in zip(names, pl):
            if axis == "data" and p.is_shard():
                t = model_slice(t, p.dim, mesh.get_local_rank("data"),
                                mesh.size(names.index("data")))
        return DTensor.from_local(t.detach().clone(), mesh, pl,
                                  run_check=False, shape=torch.Size(d.shape),
                                  stride=_contiguous_stride(d.shape))

    if isinstance(tree, dict):
        return {k: shard_tree(v, placements[k], mesh, defs[k])
                for k, v in tree.items()}
    return one(tree, placements, defs)


def _contiguous_stride(shape) -> tuple:
    stride, out = 1, []
    for n in reversed(shape):
        out.append(stride)
        stride *= n
    return tuple(reversed(out))


def build_prefill_step(model: LM, cache_len: int | None = None, mesh=None):
    """``prefill_step(batch) -> (last logits (B, 1, V) float32, cache)``,
    the cache sized for ``cache_len`` positions (default: the prompt);
    on a ``mesh`` (a tensor-parallel model's own by default) whose decode
    shards the sequence, its K and V split on S (``LM.shard_cache``)."""

    def prefill_step(batch):
        return model.prefill(batch, cache_len, mesh)

    return prefill_step


def build_serve_step(model: LM, mesh=None, rules=None):
    """One decode step: ``serve_step(tokens (B, 1), cache, position) ->
    (logits, cache, next_token_greedy (B,) int32)``; the cache is updated
    in place.  ``torch.argmax`` takes the first maximum, as ``jnp.argmax``
    does.  On a ``DeviceMesh`` (``launch.mesh.make_device_mesh``) the
    decode takes the reference's sequence-sharded path where it does: the
    ``model`` axis larger than 1 and dividing the cache's S; a whole
    cache given is split first (``LM.shard_cache``).  The weights are
    whole on every rank, or the ``model`` shards of a tensor-parallel
    model (``LM(..., mesh=)``), which decodes on its own mesh by default
    (``rules`` is the reference's argument: the model's layout took
    its own)."""

    mesh = mesh if mesh is not None else model.mesh

    def serve_step(tokens, cache, position: int):
        cache = model.shard_cache(cache, mesh)
        logits, cache = model.decode_step(tokens, cache, position)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return logits, cache, next_tok

    return serve_step
