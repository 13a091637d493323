"""The minibatch data plane and the training loop, in PyTorch.

The port of the reference's ``core/loader.py`` for the main path: the
``pallas`` backend with the whole graph uploaded to the device.  A batch
is sampled k hops by the ``neighbor_sample`` kernel and its features are
gathered by the ``feature_gather_rows`` kernel, both hand-written CUDA for
Hopper when the loader's device is a GPU (the plain PyTorch versions on
the CPU, as the tests run it).

Randomness matches the reference exactly: targets of batch ``i`` come
from ``np.random.default_rng(seed + i)``, and sampling bits from the
threefry stream ``fold_in(fold_in(key(seed), i), hop)`` (``repro_torch.
rng``), so the port's minibatches equal the reference's at equal seeds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.gnn import gnn_loss_fn
from repro_torch.core.graph import CSRGraph
from repro_torch.kernels import ops
from repro_torch.obs.metrics import idle_fraction as _idle_fraction


@dataclasses.dataclass
class Minibatch:
    """One training minibatch.

    targets:   (M,) int32 numpy -- the batch's seed nodes.
    hop_ids:   hop_ids[t] has shape (M, f1, ..., ft) -- sampled node ids.
    hop_feats: hop_feats[t] has shape (M, f1, ..., ft, F) -- their features.
    labels:    (M,) int32.
    """

    targets: np.ndarray
    hop_ids: list
    hop_feats: list
    labels: torch.Tensor


LOADERS: dict[str, type] = {}


def register_loader(name: str):
    def deco(cls):
        cls.backend = name
        LOADERS[name] = cls
        return cls
    return deco


def batch_targets(g, idx: int, batch_size: int, seed: int = 0) -> np.ndarray:
    """The shared per-batch target stream (a pure function of the index)."""
    rng_ = np.random.default_rng(seed + idx)
    return rng_.integers(0, g.num_nodes, batch_size).astype(np.int32)


@register_loader("pallas")
class PallasSubgraphLoader:
    """Kernel data preparation on one device: the graph's CSR arrays,
    features and labels are uploaded once, and each batch runs the
    ``neighbor_sample`` kernel once per hop and the
    ``feature_gather_rows`` kernel once per hop tensor -- on a GPU the
    hand-written Hopper kernels in ``csrc/``."""

    backend = "pallas"

    def __init__(self, g: CSRGraph, *, batch_size: int,
                 fanouts: Sequence[int], seed: int = 0, device="cuda"):
        self.g = g
        self.batch_size = batch_size
        self.fanouts = tuple(fanouts)
        self.seed = seed
        self.device = torch.device(device)
        # the reference casts the int64 offsets to int32 as well
        self.indptr = torch.as_tensor(np.asarray(g.indptr, np.int32),
                                      device=self.device)
        self.indices = torch.as_tensor(np.asarray(g.indices, np.int32),
                                       device=self.device)
        self.features = torch.as_tensor(np.asarray(g.features, np.float32),
                                        device=self.device)
        self.labels = torch.as_tensor(np.asarray(g.labels, np.int32),
                                      device=self.device)
        self.max_degree = int(g.degrees().max()) if g.num_edges else 1
        self._key = rng.key(seed)

    def targets(self, idx: int) -> np.ndarray:
        return batch_targets(self.g, idx, self.batch_size, self.seed)

    def get_batch(self, idx: int) -> Minibatch:
        targets = self.targets(idx)
        t = torch.as_tensor(targets, device=self.device)
        hops = ops.sample_khop_kernel(self.indptr, self.indices, t,
                                      self.fanouts,
                                      key=rng.fold_in(self._key, idx),
                                      max_degree=self.max_degree)
        hop_feats = [ops.feature_gather_rows(self.features, h) for h in hops]
        return Minibatch(targets=targets, hop_ids=hops, hop_feats=hop_feats,
                         labels=self.labels[t.long()])

    def stats(self) -> dict:
        return {"backend": self.backend, "sampler": "khop"}

    def close(self) -> None:
        pass


def build_train_step(loader, gnn, optimizer):
    """GraphSAGE update over a ``Minibatch``: loss, gradients and the
    optimizer step.  The parameters live in ``gnn`` and are updated in
    place; ``state`` carries the optimizer state and the step count.
    Returns ``train_step(state, mb) -> (state, metrics)``."""
    if loader is not None and tuple(loader.fanouts) != tuple(gnn.cfg.fanouts):
        raise ValueError(f"loader fanouts {loader.fanouts} != "
                         f"gnn fanouts {gnn.cfg.fanouts}")
    params = dict(gnn.named_parameters())

    def train_step(state: dict, mb: Minibatch):
        hop_feats = [f.float() for f in mb.hop_feats]
        loss, metrics = gnn_loss_fn(gnn, hop_feats, mb.labels)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt_metrics = optimizer.update(dict(zip(params, grads)), state["opt"],
                                       params, state["step"])
        return ({"opt": state["opt"], "step": state["step"] + 1},
                dict(metrics, **opt_metrics))

    return train_step


@dataclasses.dataclass
class RunStats:
    """Loop telemetry: the paper's Fig. 7 metrics."""

    steps: int = 0
    idle_s: float = 0.0          # consumer waiting on data preparation
    busy_s: float = 0.0          # consumer in the train step
    wall_s: float = 0.0

    @property
    def idle_fraction(self) -> float:
        return _idle_fraction(self.idle_s, self.busy_s)

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.wall_s if self.wall_s > 0 else 0.0


def _block_until_ready(metrics: dict) -> None:
    """Wait for the device that computed ``metrics``, if it is a GPU."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


def train_loop(loader, train_step, state, *, steps: int, start: int = 0,
               on_step=None) -> tuple[object, RunStats]:
    """Drive ``train_step`` over ``loader`` batches; record the idle/busy
    split.  ``on_step(i, state, metrics)`` is called after every step."""
    stats = RunStats()
    t_start = time.perf_counter()
    for i in range(start, steps):
        t0 = time.perf_counter()
        mb = loader.get_batch(i)
        t1 = time.perf_counter()
        state, metrics = train_step(state, mb)
        # kernels run asynchronously: without the wait, device time would
        # fall into the next step's idle window
        _block_until_ready(metrics)
        t2 = time.perf_counter()
        stats.idle_s += t1 - t0
        stats.busy_s += t2 - t1
        stats.steps += 1
        if on_step is not None:
            on_step(i, state, metrics)
    stats.wall_s = time.perf_counter() - t_start
    return state, stats
