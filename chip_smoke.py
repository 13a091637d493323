#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` and report the
     build time and ptxas's register report;
  3. every kernel against its plain PyTorch version on the card, at the
     shapes of a training step at batch 1024 and fanouts 25,10: on reddit
     ``--large-scale`` and on a reddit-sized R-MAT graph (2**18 nodes,
     2**23 edges drawn, 602 features); ids and rows bit-equal, the mean
     within 1e-6.  Each kernel is timed (median of 20 launches, L2
     flushed before each) beside its plain version, one PyTorch library
     call for the same function, and its bound;
  4. three batches sampled and gathered on the card equal the CPU plain
     path's bit for bit, and four fp32 training steps on the card match
     the CPU's losses within 1e-4;
  5. the main path through its entry point,
     ``repro_torch.launch.train.main``: reddit ``--large-scale``, F=602,
     hidden 256, fanouts 25,10, batch 1024, 8 steps, with the kernel
     launch counters reset just before and read just after;
  6. where the time goes: the same step timed at steady state, then
     profiled (device time by kernel, device busy share);
  7. a JSON line of the kernels' numbers, the card line, and the result.

It needs one CUDA device and exits nonzero without one.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels, rng  # noqa: E402
from repro_torch.core import (GNNConfig, GraphSAGE,  # noqa: E402
                              PallasSubgraphLoader, attach_features,
                              build_train_step, load_dataset, rmat_graph,
                              train_loop)
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.feature_gather import (  # noqa: E402
    feature_gather_mean, feature_gather_rows)
from repro_torch.kernels.neighbor_sample import neighbor_sample  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

BATCH, FANOUTS = 1024, (25, 10)
DEVICE = "cuda"
# H100 SXM data sheet: HBM bandwidth, and the float32 rate outside the
# tensor cores (used for the kernels' scalar integer and float work)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
REPLACES = {
    "neighbor_sample": "src/repro/kernels/neighbor_sample.py:104",
    "feature_gather_rows": "src/repro/kernels/feature_gather.py:106",
    "feature_gather_mean": "src/repro/kernels/feature_gather.py:90",
}
SOURCES = {
    "neighbor_sample": "src/repro_torch/csrc/neighbor_sample.cu",
    "feature_gather_rows": "src/repro_torch/csrc/feature_gather.cu",
    "feature_gather_mean": "src/repro_torch/csrc/feature_gather.cu",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median time of a call on the card over ``reps`` launches after a
    warm-up, by CUDA events.  A 256 MB buffer is rewritten before each
    launch: no launch finds the previous one's data in L2, and the card
    stays busy (~0.1 ms) while the host enqueues the call, so the events
    time the device's work rather than the host's launch overhead."""

    def __init__(self, reps: int = 20, warmup: int = 3):
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device=DEVICE)

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def n_unique(x: torch.Tensor) -> int:
    return int(torch.unique(x).numel())


def sample_case(loader, timer, targets, rand):
    """neighbor_sample at (M, S): kernel == plain bit for bit, timed."""
    ip, ix = loader.indptr, loader.indices
    got = neighbor_sample(ip, ix, targets, rand)
    want = ref.neighbor_sample(ip, ix, targets, rand)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"neighbor_sample {tuple(rand.shape)} "
          "differs from its plain version")
    M, S = rand.shape
    t = targets.long()
    deg = ip[t + 1] - ip[t]
    pos = (ip[t].long()[:, None]
           + torch.remainder(rand.long(), deg.clamp_min(1).long()[:, None]))
    # what this data needs: each distinct offset and sampled entry once,
    # plus targets and rand read and the output written
    nbytes = (4 * n_unique(torch.cat([t, t + 1])) + 4 * M + 8 * M * S
              + 4 * n_unique(pos[deg > 0]))
    b, by = bound_ms(nbytes, 8 * M * S)
    return got, {
        "shape": [M, S], "max_abs_err": 0.0,
        "ms": timer(lambda: neighbor_sample(ip, ix, targets, rand)),
        "plain_ms": timer(lambda: ref.neighbor_sample(ip, ix, targets, rand)),
        "library_ms": None, "bound_ms": b, "bound_by": by}


def rows_case(loader, timer, ids):
    """feature_gather_rows at R rows: kernel == plain bit for bit."""
    tab = loader.features
    got = feature_gather_rows(tab, ids)
    want = ref.feature_gather_rows(tab, ids)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"feature_gather_rows R={ids.shape[0]} "
          "differs from its plain version")
    R, F = ids.shape[0], tab.shape[1]
    ids64 = ids.long()
    b, by = bound_ms(4 * R + 4 * F * (n_unique(ids) + R), 0)
    return {"shape": [R, F], "max_abs_err": 0.0,
            "ms": timer(lambda: feature_gather_rows(tab, ids)),
            "plain_ms": timer(lambda: ref.feature_gather_rows(tab, ids)),
            "library_ms": timer(lambda: torch.index_select(tab, 0, ids64)),
            "bound_ms": b, "bound_by": by}


def mean_case(loader, timer, ids2d):
    """feature_gather_mean at (M, K): kernel vs plain within 1e-6 (the
    plain version on the card may divide by a reciprocal multiply)."""
    tab = loader.features
    got = feature_gather_mean(tab, ids2d)
    want = ref.feature_gather_mean(tab, ids2d)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
          f"feature_gather_mean {tuple(ids2d.shape)} off by {err}")
    (M, K), F = ids2d.shape, tab.shape[1]
    flat = ids2d.reshape(-1).long()
    b, by = bound_ms(4 * M * K + 4 * F * (n_unique(ids2d) + M), 2 * M * K * F)
    return {"shape": [M, K, F], "max_abs_err": err,
            "ms": timer(lambda: feature_gather_mean(tab, ids2d)),
            "plain_ms": timer(lambda: ref.feature_gather_mean(tab, ids2d)),
            "library_ms": timer(lambda: torch.index_select(tab, 0, flat)
                                .view(M, K, F).mean(1)),
            "bound_ms": b, "bound_by": by}


def kernel_phase(name: str, g, timer) -> dict:
    """Phase 3 on one graph: the inputs are batch 0 of the main path."""
    loader = PallasSubgraphLoader(g, batch_size=BATCH, fanouts=FANOUTS,
                                  seed=0, device=DEVICE)
    key = rng.fold_in(rng.key(0), 0)
    t = torch.as_tensor(loader.targets(0), device=DEVICE)
    r1 = rng.randint(rng.fold_in(key, 0), (BATCH, FANOUTS[0]), 0, 2**31 - 1,
                     device=DEVICE)
    hop1, ns1 = sample_case(loader, timer, t, r1)
    flat1 = hop1.reshape(-1)
    r2 = rng.randint(rng.fold_in(key, 1), (BATCH, FANOUTS[0], FANOUTS[1]),
                     0, 2**31 - 1, device=DEVICE).reshape(-1, FANOUTS[1])
    hop2, ns2 = sample_case(loader, timer, flat1, r2)
    cases = {
        "neighbor_sample": [ns1, ns2],
        "feature_gather_rows": [rows_case(loader, timer, ids)
                                for ids in (t, flat1, hop2.reshape(-1))],
        "feature_gather_mean": [mean_case(loader, timer, hop2)],
    }
    for kname, rows in cases.items():
        for c in rows:
            lib = ("-" if c["library_ms"] is None
                   else f"{c['library_ms']:.4f}")
            print(f"[smoke]   {name:10s} {kname:20s} {str(c['shape']):18s} "
                  f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  "
                  f"library {lib} ms  bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})  max_abs_err {c['max_abs_err']:g}")
    del loader
    torch.cuda.empty_cache()
    return cases


def parity_phase(g) -> None:
    """Phase 4: card == CPU plain path for 3 batches; fp32 steps agree."""
    gpu = PallasSubgraphLoader(g, batch_size=BATCH, fanouts=FANOUTS, seed=0,
                               device=DEVICE)
    cpu = PallasSubgraphLoader(g, batch_size=BATCH, fanouts=FANOUTS, seed=0,
                               device="cpu")
    for idx in range(3):
        a, b = gpu.get_batch(idx), cpu.get_batch(idx)
        for x, y in zip(a.hop_ids + a.hop_feats + [a.labels],
                        b.hop_ids + b.hop_feats + [b.labels]):
            check(torch.equal(x.cpu(), y), f"batch {idx}: card and CPU "
                  f"differ in a {tuple(y.shape)} tensor")
    print("[smoke] phase 4: 3 batches bit-equal between card and CPU")

    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products
    losses = {}
    for dev in (DEVICE, "cpu"):
        loader = PallasSubgraphLoader(g, batch_size=64, fanouts=(10, 5),
                                      seed=0, device=dev)
        cfg = GNNConfig(feat_dim=g.feat_dim, hidden=64,
                        n_classes=int(g.labels.max()) + 1, fanouts=(10, 5))
        model = GraphSAGE(cfg, device=dev, compute_dtype=torch.float32)
        opt = adamw(1e-3)
        state = {"opt": opt.init(dict(model.named_parameters())), "step": 0}
        out = []
        train_loop(loader, build_train_step(loader, model, opt), state,
                   steps=4,
                   on_step=lambda i, s, m: out.append(float(m["loss"])))
        losses[dev] = out
    check(np.allclose(losses[DEVICE], losses["cpu"], rtol=1e-4, atol=1e-4),
          f"fp32 losses on card {losses[DEVICE]} vs CPU {losses['cpu']}")
    print(f"[smoke] phase 4: fp32 losses card {losses[DEVICE]} "
          f"cpu {losses['cpu']}")


def _merged_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_phase(g) -> dict:
    """Phase 6, where the time goes: the main path's step (batch 1024,
    fanouts 25,10, hidden 256) warmed up for 2 steps, timed for 8 steps
    without the profiler, then 4 more steps under ``torch.profiler``:
    device time by kernel name per step, and the device's busy share of
    the profiled loop's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loader = PallasSubgraphLoader(g, batch_size=BATCH, fanouts=FANOUTS,
                                  seed=0, device=DEVICE)
    cfg = GNNConfig(feat_dim=g.feat_dim, hidden=256,
                    n_classes=int(g.labels.max()) + 1, fanouts=FANOUTS)
    model = GraphSAGE(cfg, device=DEVICE)
    opt = adamw(1e-3)
    step = build_train_step(loader, model, opt)
    state = {"opt": opt.init(dict(model.named_parameters())), "step": 0}
    state, _ = train_loop(loader, step, state, steps=2)
    state, steady = train_loop(loader, step, state, start=2, steps=10)
    prof_steps = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, traced = train_loop(loader, step, state, start=10,
                                   steps=10 + prof_steps)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in dev:
        slot = by_name.setdefault(e.name, [0.0, 0])
        slot[0] += e.time_range.elapsed_us() / 1e3 / prof_steps
        slot[1] += 1
    busy_ms = _merged_us((e.time_range.start, e.time_range.end)
                         for e in dev) / 1e3
    out = {"steady_steps_per_s": steady.steps_per_s,
           "steady_idle_fraction": steady.idle_fraction,
           "steady_ms_per_step": 1e3 * steady.wall_s / steady.steps,
           "profiled_ms_per_step": 1e3 * traced.wall_s / prof_steps,
           "device_busy_ms_per_step": busy_ms / prof_steps if dev else None,
           "device_busy_share": (busy_ms / (1e3 * traced.wall_s)
                                 if dev else None),
           "device_ops_per_step": len(dev) / prof_steps,
           "by_kernel_ms_per_step": dict(sorted(
               ((k, v[0]) for k, v in by_name.items()),
               key=lambda kv: -kv[1])),
           "by_kernel_count": {k: v[1] // prof_steps
                               for k, v in by_name.items()}}
    print(f"[smoke] phase 6: steady {out['steady_steps_per_s']:.3f} steps/s "
          f"({out['steady_ms_per_step']:.3f} ms/step, consumer idle "
          f"{out['steady_idle_fraction']:.4f}); profiled "
          f"{out['profiled_ms_per_step']:.3f} ms/step, device busy "
          f"{out['device_busy_ms_per_step']} ms/step "
          f"(share {out['device_busy_share']}), "
          f"{out['device_ops_per_step']:.0f} device ops/step")
    for name, ms in list(out["by_kernel_ms_per_step"].items())[:12]:
        count = out["by_kernel_count"][name]
        print(f"[smoke]   {ms:9.4f} ms/step  x{count:<4d} {name[:110]}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    card = card_line()
    print(f"[smoke] phase 1: {card}; {torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"[smoke] phase 2: built {sorted(logs) or 'nothing (cached)'} in "
          f"{build_s:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[smoke]   {src}: {line.strip()}")

    print("[smoke] phase 3: kernels against their plain versions")
    timer = Timer()
    reddit = load_dataset("reddit", large_scale=True)
    t0 = time.perf_counter()
    synth = attach_features(rmat_graph(1 << 18, 1 << 23, seed=0,
                                       name="rmat-2^18"), 602, seed=2)
    print(f"[smoke]   {synth.name}: {synth.num_nodes} nodes "
          f"{synth.num_edges} edges, features "
          f"{synth.features.nbytes / 1e6:.0f} MB, built in "
          f"{time.perf_counter() - t0:.1f} s")
    per_graph = {"reddit-large": kernel_phase("reddit-lg", reddit, timer),
                 "rmat-2^18": kernel_phase("rmat-2^18", synth, timer)}
    del synth

    parity_phase(reddit)

    argv = ["--arch", "graphsage", "--backend", "pallas", "--dataset",
            "reddit", "--large-scale", "--batch", str(BATCH), "--fanouts",
            ",".join(map(str, FANOUTS)), "--hidden", "256", "--steps", "8",
            "--log-every", "1", "--device", DEVICE]
    print(f"[smoke] phase 5: train {' '.join(argv)}")
    kernels.reset_launches()
    stats, losses = train.main(argv)
    launches = dict(kernels.LAUNCHES)
    check(len(losses) == 8 and all(math.isfinite(x) for x in losses),
          f"losses {losses}")
    check(launches["neighbor_sample"] == 2 * 8,
          f"neighbor_sample launched {launches['neighbor_sample']} times")
    check(launches["feature_gather_rows"] == 3 * 8,
          f"feature_gather_rows launched {launches['feature_gather_rows']}")
    print(f"[smoke] phase 5: {stats.steps_per_s:.3f} steps/s, consumer idle "
          f"{stats.idle_fraction:.4f}, launches {launches}")

    profile = profile_phase(reddit)

    # the JSON line: per kernel, summed over one step's launches on the
    # reddit-sized graph (its 631 MB table does not fit in L2)
    table = []
    for kname, cases in per_graph["rmat-2^18"].items():
        libs = [c["library_ms"] for c in cases]
        table.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": sum(c["bound_ms"] for c in cases),
            "bound_by": cases[0]["bound_by"],
            "library_ms": None if None in libs else sum(libs),
            "shapes": [c["shape"] for c in cases],
            "on_main_path": kname != "feature_gather_mean"})
    details = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda,
               "build_s": build_s, "kernels": table, "per_graph": per_graph,
               "train": {"argv": argv, "losses": losses,
                         "steps_per_s": stats.steps_per_s,
                         "idle_fraction": stats.idle_fraction,
                         "idle_s": stats.idle_s, "busy_s": stats.busy_s,
                         "wall_s": stats.wall_s, "launches": launches},
               "profile": profile,
               "seconds": time.perf_counter() - t_all}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
