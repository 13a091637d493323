#!/usr/bin/env python3
"""Time two commits' cached GNN kernels against each other, in turns, on
one card, at the widths the out-of-core step launches.

  python3 benchmarks/torch_cached_kernels_ab.py [--parent DIR]
      [--order parent,tree,tree,parent] [--flush write|read]

``tree`` is this checkout.  ``--parent DIR`` names the root of another
commit's package (``git archive <commit> src/repro_torch | tar -x -C
_checkout/parent``: ``_checkout/`` is git-ignored, and a package without
tests leaves pytest's collection alone).  A build is that tree's own
``neighbor_sample_cached`` and ``feature_gather_cached`` wrappers, loaded
from its ``kernels/`` beside its own ``_build``, so each build compiles
its own sources and calls them with its own C arguments, as the
out-of-core path calls them.  ``--order`` lists the builds to time, one
turn each, so ``parent,tree,tree,parent`` times both twice in
alternation.

The inputs are ``chip_smoke.py``'s phase-3 inputs, made by its own
helpers: reddit --large-scale, batch 1024, fanouts 25,10, batch 0; every
chunk of the edge-block cache's plan (one sampler launch each) and every
segment of the feature cache's plan (one gather launch each), timed by
chip_smoke's ``Timer`` (median of 20 launches, L2 rewritten before each;
``--flush read`` reads it instead, leaving no dirty lines to write back),
beside the card's launch floor (``torch.cuda._sleep(0)``) and a contiguous
``copy_`` of each segment's bytes.  Every build's outputs equal the plain
versions' bit for bit there and at ``chip_smoke.cached_edge_inputs``.
Needs one CUDA device; writes ``chiprun_out/cached_kernels_ab_<flush>.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def load_build(tag: str, root: Path) -> types.SimpleNamespace:
    """The cached kernels' wrappers of the tree at ``root``: its
    ``kernels/neighbor_sample.py`` and ``kernels/feature_gather.py``,
    importing its own ``kernels/_build.py`` (which builds that tree's
    ``csrc``) where they import ``repro_torch.kernels._build``."""
    kdir = root / "src" / "repro_torch" / "kernels"

    def load(name):
        spec = importlib.util.spec_from_file_location(f"_ab_{tag}_{name}",
                                                      kdir / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    saved, kernels._build = kernels._build, load("_build")
    try:
        ns, fg = load("neighbor_sample"), load("feature_gather")
    finally:
        kernels._build = saved
    return types.SimpleNamespace(sample=ns.neighbor_sample_cached,
                                 gather=fg.feature_gather_cached)


def check_build(name: str, b, edge) -> None:
    """The build at ``chip_smoke.cached_edge_inputs``, bit-equal to the
    plain versions."""
    samples, gathers = edge
    for ip, _, slots, targets, rand, cache, block_e, max_block in samples:
        kw = dict(block_e=block_e, max_block=max_block)
        cs.check(torch.equal(b.sample(ip, slots, targets, rand, cache, **kw),
                             ref.neighbor_sample_cached(
                                 ip, slots, targets, rand, cache, **kw)),
                 f"{name}: sampler edge case {tuple(rand.shape)}, "
                 f"{slots.numel()} slots differs")
    for args in gathers:
        cs.check(torch.equal(b.gather(*args),
                             ref.feature_gather_cached(*args)),
                 f"{name}: gather edge case {tuple(args[2].shape)} differs")


class CleanTimer(cs.Timer):
    """chip_smoke's ``Timer`` with its 256 MB buffer read, not rewritten,
    before each launch: L2 then holds clean lines, and the timed kernel's
    misses evict them without writing them back."""

    def flush_l2(self) -> None:
        self.flush.amax()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="root of another commit's src/repro_torch")
    ap.add_argument("--order", default="tree",
                    help="comma-separated builds, one timed turn each")
    ap.add_argument("--flush", choices=("write", "read"), default="write",
                    help="how L2 is flushed before each timed launch: "
                         "rewritten (chip_smoke's Timer, the default) or "
                         "read (clean lines)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_cached_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    roots = {"tree": ROOT}
    if args.parent:
        roots["parent"] = Path(args.parent).resolve()
    order = args.order.split(",")
    unknown = set(order) - set(roots)
    if unknown:
        ap.error(f"--order names unknown builds {sorted(unknown)}")
    builds = {n: load_build(n, roots[n]) for n in dict.fromkeys(order)}
    card = cs.card_line()
    print(f"[ab] {card}; builds {list(builds)}, order {order}")

    g = cs.load_dataset("reddit", large_scale=True)
    loader = cs.PallasSubgraphLoader(g, batch_size=cs.BATCH,
                                     fanouts=cs.FANOUTS, seed=0,
                                     device=cs.DEVICE)
    t, r1, r2 = cs.batch0(loader)
    flat1 = ref.neighbor_sample(loader.indptr, loader.indices, t,
                                r1).reshape(-1)
    hop2 = ref.neighbor_sample(loader.indptr, loader.indices, flat1, r2)
    cache, slot_of, uniq = cs.gather_cache(
        g, loader, torch.cat([t, flat1, hop2.reshape(-1)]))
    chunks, segments = cs.ooc_plan(g, t, flat1, uniq)
    block_cache, block_slots, block_e, max_block = cs.block_cache(
        loader, (t, flat1))
    kw = dict(block_e=block_e, max_block=max_block)
    frontiers, rands = (t, flat1), (r1, r2)
    samples = [(loader.indptr, block_slots, frontiers[hop][sl].contiguous(),
                rands[hop][sl].contiguous(), block_cache)
               for hop, sl in chunks]
    samples = [(a, ref.neighbor_sample_cached(*a, **kw)) for a in samples]
    gathers = [(cache, slot_of, torch.as_tensor(np.asarray(seg, np.int32),
                                                device=cs.DEVICE))
               for seg in segments]
    gathers = [(a, ref.feature_gather_cached(*a)) for a in gathers]
    timer = cs.Timer() if args.flush == "write" else CleanTimer()
    # a yardstick: one contiguous copy of each segment's bytes
    copy_ms = []
    for _, want in gathers:
        dst = torch.empty_like(want)
        copy_ms.append(timer(lambda: dst.copy_(cache[:want.shape[0]])))
    edge = cs.cached_edge_inputs(loader)
    for name, b in builds.items():
        check_build(name, b, edge)
    widths = [a[2].numel() for a, _ in samples]
    rows = [a[2].numel() for a, _ in gathers]
    print(f"[ab] {len(samples)} sampler chunks (widths {min(widths)}-"
          f"{max(widths)}), gather segments {rows}; every build bit-equal "
          f"to the plain versions at the edge cases; a contiguous copy of "
          f"each segment's bytes (copy_) {[round(x, 4) for x in copy_ms]} ms")

    turns = []
    for turn, name in enumerate(order):
        b = builds[name]
        floor = cs.launch_floor_ms(timer)
        sample_ms, gather_ms = [], []
        for a, want in samples:
            cs.check(torch.equal(b.sample(*a, **kw), want), f"{name}: chunk "
                     f"{tuple(a[3].shape)} differs from the plain version")
            sample_ms.append(timer(lambda: b.sample(*a, **kw)))
        for a, want in gathers:
            cs.check(torch.equal(b.gather(*a), want), f"{name}: segment "
                     f"{a[2].numel()} differs from the plain version")
            gather_ms.append(timer(lambda: b.gather(*a)))
        row = {"turn": turn, "build": name, "floor_ms": floor,
               "sample_ms": sample_ms, "gather_ms": gather_ms,
               "sample_ms_per_step": sum(sample_ms),
               "sample_ms_per_launch": statistics.mean(sample_ms),
               "gather_ms_per_step": sum(gather_ms)}
        turns.append(row)
        print(f"[ab] turn {turn} {name:6s} floor {floor:.4f} ms; sampler "
              f"{row['sample_ms_per_step']:.4f} ms a step, "
              f"{row['sample_ms_per_launch']:.4f} a launch (median "
              f"{statistics.median(sample_ms):.4f}); gather "
              + ", ".join(f"{n} rows {ms:.4f}"
                          for n, ms in zip(rows, gather_ms))
              + f" ms ({row['gather_ms_per_step']:.4f} a step)")
    out = {"card": card, "device": torch.cuda.get_device_name(0),
           "order": order, "flush": args.flush,
           "roots": {n: str(roots[n]) for n in builds},
           "sample_widths": [list(a[3].shape) for a, _ in samples],
           "gather_rows": rows, "contiguous_copy_ms": copy_ms,
           "turns": turns}
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / f"cached_kernels_ab_{args.flush}.json",
              "w") as f:
        json.dump(out, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
