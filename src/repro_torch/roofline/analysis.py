"""Roofline terms of a traced step, per rank, on the H100.

The port of the reference's ``repro/roofline/analysis.py``.  Three terms
a (arch x shape x mesh) cell, in seconds:

  compute    = FLOPs a rank       / PEAK_FLOPS
  memory     = bytes a rank       / HBM_BW
  collective = link bytes a rank  / LINK_BW

The reference reads its counts off XLA's optimized HLO (its
``hlo_parse``).  The port has no compiled module: ``launch.dryrun`` runs
the real step eagerly on fake tensors, one rank of a fake process group,
under ``StepCounter`` (a dispatch mode), and counts what that rank
dispatches:

* FLOPs: ``FlopCounterMode``'s count: its registry of formulas
  (``torch.utils.flop_counter.flop_registry``) applied to each op as
  ``FlopCounterMode`` applies it, which counts the matrix products and
  convolutions and the LM kernels' own (``kernels.ops``: the count behind
  each kernel's "operations" bound).  ``StepCounter`` applies it itself:
  a second dispatch mode would add a fifth to the trace's time, and
  ``FlopCounterMode`` decomposes the ops it has no formula for, which
  would count the bytes of the parts instead of the op that runs.
* Bytes: the sum over the dispatched ops of the bytes of their tensor
  inputs and outputs, each tensor's elements once (its element count times
  its element size, at most its storage's bytes), as if every op read its
  inputs from device memory and wrote its outputs there: no fusion, as
  eager PyTorch runs.  Views, allocations that write nothing and other
  metadata ops count nothing, collectives go to the link term, and a
  kernel (a ``repro_torch::`` op) counts its own inputs and outputs.  A
  DTensor counts its local shard.
* Collectives: every ``c10d`` and ``_c10d_functional`` op the rank issues
  (the tensor-parallel ``all_reduce``s of ``distributed.collectives`` and
  DTensor's redistributions alike), each with its kind, its result bytes
  and its group's size; link bytes a rank by the reference's ring factors
  (``ring_link_bytes``).
* Memory: the peak over the trace of the bytes of the storages alive
  (``StepCounter`` adds each storage an op returns, once, and takes it
  off when it is freed), the state built before the step included.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense rates at the full power
# limit of 700 W: a card set below it runs slower under load).
PEAK_FLOPS = 989e12          # bf16 FLOP/s on the tensor cores
HBM_BW = 3.35e12             # bytes/s of device memory
LINK_BW = 450e9              # bytes/s each way on NVLink (900 GB/s in all)
HBM_BYTES = 80e9             # bytes of device memory
# NVLink joins the 8 cards of one host.  A group wider than a host (the
# production mesh's 256 or 512 ranks) also crosses the network between
# hosts, whose rate the data sheet does not give and which is slower:
# there the collective term is a lower bound.
HOST_CARDS = 8

# the collectives the port issues: ``c10d`` ops (``torch.distributed``'s
# calls) and ``_c10d_functional`` ones (DTensor's redistributions)
_KINDS = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}

# ops that read or write no tensor data (besides views): allocation
# without a write, aliasing, metadata, the wait on a collective
_NO_BYTES = frozenset(
    f"{ns}::{name}" for ns, names in (
        ("aten", ("empty", "empty_strided", "empty_like", "new_empty",
                  "new_empty_strided", "detach", "alias", "lift_fresh",
                  "_unsafe_view", "_local_scalar_dense", "sym_size",
                  "sym_stride", "sym_numel", "sym_storage_offset",
                  "set_", "resize_")),
        ("_c10d_functional", ("wait_tensor",)),
        ("prim", ("device", "layout")))
    for name in names)


def ring_link_bytes(kind: str, nbytes: float, group: int) -> float:
    """Bytes a rank sends in a ring collective of ``kind`` whose result on
    each rank is ``nbytes``, over a group of ``group`` ranks (the
    reference's factors; a group of one rank moves nothing)."""
    if group <= 1:
        return 0.0
    frac = (group - 1) / group
    if kind == "all-gather":
        return nbytes * frac                 # the result is the gathered buffer
    if kind == "all-reduce":
        return 2.0 * nbytes * frac           # reduce-scatter + all-gather
    if kind == "reduce-scatter":
        return nbytes * group * frac         # the operand is the result x g
    if kind == "all-to-all":
        return nbytes * frac
    if kind in ("collective-permute", "broadcast"):
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int] = dataclasses.field(default_factory=dict)
    # sum of each collective's result bytes on this rank
    result_bytes: dict[str, int] = dataclasses.field(default_factory=dict)
    link_bytes_per_chip: float = 0.0      # ring-model traffic a rank
    # the widest group a collective ran over
    max_group: int = 1

    def add(self, kind: str, nbytes: int, group: int) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.result_bytes[kind] = self.result_bytes.get(kind, 0) + nbytes
        self.link_bytes_per_chip += ring_link_bytes(kind, nbytes, group)
        self.max_group = max(self.max_group, group)


@dataclasses.dataclass
class StepCosts:
    """What one rank's traced step does (``StepCounter.costs``): the
    fields ``compute_terms_from_costs`` reads (``flops``, ``hbm_bytes``,
    ``link_bytes``), the collectives, and the rank's memory."""

    flops: float
    hbm_bytes: float
    link_bytes: float
    collectives: CollectiveStats
    peak_bytes: int           # live bytes at the peak of the trace
    state_bytes: int          # live bytes when the step began


@dataclasses.dataclass
class RooflineTerms:
    flops_per_chip: float
    bytes_per_chip: float
    link_bytes_per_chip: float
    n_chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    model_flops_per_chip: float
    useful_flops_ratio: float
    step_time_s: float               # max of the three terms
    roofline_fraction: float         # model-flops-time / step_time

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def compute_terms_from_costs(module_costs, n_chips: int,
                             model_flops_total: float, *,
                             peak_flops: float = PEAK_FLOPS,
                             hbm_bw: float = HBM_BW,
                             link_bw: float = LINK_BW) -> RooflineTerms:
    """The three terms of per-rank ``flops``, ``hbm_bytes`` and
    ``link_bytes`` (a ``StepCosts``, or anything with those fields), the
    reference's arithmetic; the rates default to the H100's."""
    flops = float(module_costs.flops)
    bytes_ = float(module_costs.hbm_bytes)
    link = float(module_costs.link_bytes)

    compute_s = flops / peak_flops
    memory_s = bytes_ / hbm_bw
    collective_s = link / link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=terms.get)
    model_flops_per_chip = model_flops_total / n_chips
    useful = model_flops_per_chip / flops if flops else 0.0
    step = max(compute_s, memory_s, collective_s)
    ideal = model_flops_per_chip / peak_flops
    frac = ideal / step if step > 0 else 0.0
    return RooflineTerms(
        flops_per_chip=flops, bytes_per_chip=bytes_,
        link_bytes_per_chip=link, n_chips=n_chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bound=bound, model_flops_per_chip=model_flops_per_chip,
        useful_flops_ratio=useful, step_time_s=step, roofline_fraction=frac)


def model_flops(cfg, shape, active_params: int) -> float:
    """Useful model FLOPs for the cell (global, not per-chip).

    train:   6 * N_active * tokens   (fwd 2ND + bwd 4ND)
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch    (one token per sequence)
    Attention's O(S^2) FLOPs are left out, as the reference leaves them.
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * active_params * B * S
    if shape.kind == "prefill":
        return 2.0 * active_params * B * S
    return 2.0 * active_params * B


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, a tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    n = t.numel() * t.element_size()
    return min(n, t.untyped_storage().nbytes()) if n else 0


def _group_size(func, args) -> int:
    import torch.distributed as dist

    if func.namespace == "_c10d_functional":
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(args[-1]).size()
    for a in args:
        if isinstance(a, torch.ScriptObject) \
                and "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a).size()
    return dist.get_world_size()


class StepCounter(TorchDispatchMode):
    """Counts, per rank, what the ops dispatched under it do (see the
    module docstring): memory always; FLOPs, bytes and collectives inside
    ``step()``.  Push it inside a ``FakeTensorMode`` (after it), so that
    it sees each op first; DTensor ops it sees at their level and counts
    on their local shards."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = dict(flop_registry)
        self.counting = False
        self.flops = 0
        self.hbm_bytes = 0
        self.collectives = CollectiveStats()
        self.live = self.peak = self.state_bytes = 0
        self._sizes: dict[int, int] = {}     # id(storage) -> bytes

    @contextlib.contextmanager
    def step(self):
        """Count bytes and collectives inside."""
        self.state_bytes = self.live
        self.counting = True
        try:
            yield self
        finally:
            self.counting = False

    def track(self, tree) -> None:
        """Count the storages of the tensors in ``tree`` (made before the
        mode was entered) as alive."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._alloc(t)

    def _alloc(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._alloc(t)
        if self.counting:
            formula = self._formulas.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            name = func.overloadpacket._qualified_op_name
            if func.namespace in ("c10d", "_c10d_functional") \
                    and func._opname in _KINDS:
                moved = outs or [a for a in tree_leaves(args)
                                 if isinstance(a, torch.Tensor)][:1]
                self.collectives.add(_KINDS[func._opname],
                                     sum(map(_nbytes, moved)),
                                     _group_size(func, args))
            elif not func.is_view and name not in _NO_BYTES \
                    and func.namespace not in ("c10d", "_c10d_functional"):
                ins = [t for t in tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)]
                self.hbm_bytes += sum(map(_nbytes, ins)) \
                    + sum(map(_nbytes, outs))
        return out

    def costs(self) -> StepCosts:
        return StepCosts(flops=float(self.flops),
                         hbm_bytes=float(self.hbm_bytes),
                         link_bytes=self.collectives.link_bytes_per_chip,
                         collectives=self.collectives, peak_bytes=self.peak,
                         state_bytes=self.state_bytes)
