#!/usr/bin/env python3
"""Time two or more commits' GNN kernels against each other, in turns, on
one card, at the widths the training step launches them.

  python3 benchmarks/torch_cached_kernels_ab.py [--build NAME=DIR ...]
      [--order parent,tree,tree,parent] [--kernels cached,inmem]
      [--flush write|read]

``tree`` is this checkout.  ``--build NAME=DIR`` names the root of
another tree's package under NAME: another commit's (``git archive
<commit> src/repro_torch | tar -x -C _checkout/parent``, then ``--build
parent=_checkout/parent``; ``_checkout/`` is git-ignored, and a package
without tests leaves pytest's collection alone) or a scratch copy with a
kernel edited.  A build is that tree's own wrappers, loaded from its ``kernels/`` beside its
own ``_build``, so each build compiles its own sources and calls them with
its own C arguments, as the training step calls them.  ``--order`` lists
the builds to time, one turn each, so ``parent,tree,tree,parent`` times
both twice in alternation.

The kernel groups (``--kernels``, comma-separated):

- ``cached`` (the default): ``neighbor_sample_cached`` and
  ``feature_gather_cached`` at ``chip_smoke.py``'s phase-3 inputs, made
  by its own helpers: reddit --large-scale, batch 1024, fanouts 25,10,
  batch 0; every chunk of the edge-block cache's plan (one sampler launch
  each) and every segment of the feature cache's plan (one gather launch
  each), beside a contiguous ``copy_`` of each segment's bytes, checked
  bit-equal to the plain versions there and compared with them at
  ``chip_smoke.cached_edge_inputs``.
- ``inmem``: the in-memory step's kernels on the R-MAT graph of phase 3
  (2**18 nodes, 2**23 edges drawn, 602 features), batch 0:
  ``neighbor_sample`` at both hops (1024, 25) and (25600, 10),
  ``feature_gather_rows`` at its three hop widths (the guard of the main
  path) and ``feature_gather_mean`` at hop 2's ids (25600, 10, 602),
  each checked bit-equal to its plain version there and compared with it
  at ``chip_smoke.inmem_edge_inputs``, with the mean's bytes
  bound and two yardsticks beside it: (a) the mean over as many ids with
  no repeats (distinct rows, cycled if the table has fewer), which no L2
  reuse can help, and (b) a contiguous ``copy_`` of the bytes the mean
  requests (M x K rows).  It also reports in how many entries the plain
  mean with a Python-scalar divisor (which ATen may turn into a multiply
  by the reciprocal on the card) differs from the true division.

A build that differs from the plain versions at an edge case is reported
and still timed; one that differs at a timed input stops the run.  Every
time is chip_smoke's ``Timer`` (median of 20 launches, L2 rewritten
before each; ``--flush read`` reads it instead, leaving no dirty lines to
write back), beside the card's launch floor (``torch.cuda._sleep(0)``),
taken at the start of each turn.  Each build prints ptxas's registers
for each GNN kernel instance and writes the SASS of its two GNN sources
(``cuobjdump -sass``) to ``chiprun_out/sass/``.  Needs one CUDA device; writes ``chiprun_out/kernels_ab_<groups>_<flush>.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
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

GROUPS = ("cached", "inmem")
GNN_SOURCES = ("neighbor_sample", "feature_gather")


def load_build(tag: str, root: Path) -> types.SimpleNamespace:
    """The GNN kernels' wrappers of the tree at ``root``: its
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

    build = load("_build")
    saved, kernels._build = kernels._build, build
    try:
        ns, fg = load("neighbor_sample"), load("feature_gather")
    finally:
        kernels._build = saved
    return types.SimpleNamespace(
        build=build, sample_cached=ns.neighbor_sample_cached,
        gather_cached=fg.feature_gather_cached, sample=ns.neighbor_sample,
        rows=fg.feature_gather_rows, mean=fg.feature_gather_mean)


def report_build(name: str, b) -> None:
    """Build the GNN sources of ``b``, print ptxas's registers for each
    kernel instance and write their SASS."""
    logs = b.build.build(GNN_SOURCES)
    for r in b.build.ptxas_report(logs):
        print(f"[ab] {name}: {r['source']} {r['kernel']} {r['registers']} "
              f"registers, {r['spill_stores']} bytes spill stores")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = ROOT / "chiprun_out" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    for src in GNN_SOURCES:
        text = subprocess.run([tool, "-sass", str(b.build.lib_path(src))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        (out / f"{name}_{src}.sass").write_text(text)
    print(f"[ab] {name}: SASS in {out}")


class CleanTimer(cs.Timer):
    """chip_smoke's ``Timer`` with its 256 MB buffer read, not rewritten,
    before each launch: L2 then holds clean lines, and the timed kernel's
    misses evict them without writing them back."""

    def flush_l2(self) -> None:
        self.flush.amax()


def equal(got, want, what: str) -> None:
    cs.check(torch.equal(got, want), f"{what} differs from the plain "
             "version")


def differing(pairs) -> list[str]:
    """The names of the (name, got, want, bitwise) cases where ``got`` is
    not ``want``: bit for bit if ``bitwise``, else as values."""
    return [name for name, got, want, bitwise in pairs
            if not (cs.bit_equal(got, want) if bitwise
                    else torch.equal(got, want))]


class Cached:
    """The cached kernels at the out-of-core step's chunks and segments."""

    def __init__(self, timer):
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
        self.kw = dict(block_e=block_e, max_block=max_block)
        frontiers, rands = (t, flat1), (r1, r2)
        samples = [(loader.indptr, block_slots,
                    frontiers[hop][sl].contiguous(),
                    rands[hop][sl].contiguous(), block_cache)
                   for hop, sl in chunks]
        self.samples = [(a, ref.neighbor_sample_cached(*a, **self.kw))
                        for a in samples]
        gathers = [(cache, slot_of, torch.as_tensor(
            np.asarray(seg, np.int32), device=cs.DEVICE)) for seg in segments]
        self.gathers = [(a, ref.feature_gather_cached(*a)) for a in gathers]
        # a yardstick: one contiguous copy of each segment's bytes
        self.copy_ms = []
        for _, want in self.gathers:
            dst = torch.empty_like(want)
            self.copy_ms.append(timer(lambda: dst.copy_(
                cache[:want.shape[0]])))
        self.edge = cs.cached_edge_inputs(loader)
        widths = [a[2].numel() for a, _ in self.samples]
        self.rows = [a[2].numel() for a, _ in self.gathers]
        print(f"[ab] cached: {len(self.samples)} sampler chunks (widths "
              f"{min(widths)}-{max(widths)}), gather segments {self.rows}; "
              f"a contiguous copy of each segment's bytes (copy_) "
              f"{[round(x, 4) for x in self.copy_ms]} ms")

    def check(self, b) -> list[str]:
        """The edge cases of ``chip_smoke.cached_edge_inputs`` where the
        build differs from the plain versions."""
        samples, gathers = self.edge
        pairs = []
        for ip, _, slots, targets, rand, cache, block_e, max_block in samples:
            kw = dict(block_e=block_e, max_block=max_block)
            pairs.append((f"sampler {tuple(rand.shape)}, {slots.numel()} "
                          f"slots", b.sample_cached(ip, slots, targets, rand,
                                                    cache, **kw),
                          ref.neighbor_sample_cached(ip, slots, targets, rand,
                                                     cache, **kw), False))
        for args in gathers:
            pairs.append((f"gather {tuple(args[2].shape)}",
                          b.gather_cached(*args),
                          ref.feature_gather_cached(*args), False))
        return differing(pairs)

    def turn(self, name: str, b, timer) -> dict:
        sample_ms, gather_ms = [], []
        for a, want in self.samples:
            equal(b.sample_cached(*a, **self.kw), want,
                  f"{name}: chunk {tuple(a[3].shape)}")
            sample_ms.append(timer(lambda: b.sample_cached(*a, **self.kw)))
        for a, want in self.gathers:
            equal(b.gather_cached(*a), want,
                  f"{name}: segment {a[2].numel()}")
            gather_ms.append(timer(lambda: b.gather_cached(*a)))
        row = {"sample_ms": sample_ms, "gather_ms": gather_ms,
               "sample_ms_per_step": sum(sample_ms),
               "sample_ms_per_launch": statistics.mean(sample_ms),
               "gather_ms_per_step": sum(gather_ms)}
        print(f"[ab]   cached: sampler {row['sample_ms_per_step']:.4f} ms "
              f"a step, {row['sample_ms_per_launch']:.4f} a launch (median "
              f"{statistics.median(sample_ms):.4f}); gather "
              + ", ".join(f"{n} rows {ms:.4f}"
                          for n, ms in zip(self.rows, gather_ms))
              + f" ms ({row['gather_ms_per_step']:.4f} a step)")
        return row

    def meta(self) -> dict:
        return {"sample_widths": [list(a[3].shape) for a, _ in self.samples],
                "gather_rows": self.rows, "contiguous_copy_ms": self.copy_ms}


class InMemory:
    """The in-memory step's kernels on phase 3's R-MAT graph, batch 0."""

    def __init__(self, timer):
        g = cs.attach_features(cs.rmat_graph(cs.RMAT_NODES, cs.RMAT_EDGES,
                                             seed=0, name="rmat-2^18"),
                               602, seed=2)
        loader = cs.PallasSubgraphLoader(g, batch_size=cs.BATCH,
                                         fanouts=cs.FANOUTS, seed=0,
                                         device=cs.DEVICE)
        ip, ix, tab = loader.indptr, loader.indices, loader.features
        t, r1, r2 = cs.batch0(loader)
        hop1 = ref.neighbor_sample(ip, ix, t, r1)
        flat1 = hop1.reshape(-1)
        hop2 = ref.neighbor_sample(ip, ix, flat1, r2)
        self.samples = [((ip, ix, t, r1), hop1), ((ip, ix, flat1, r2), hop2)]
        self.edge = cs.inmem_edge_inputs(loader)
        self.rows = [((tab, ids), ref.feature_gather_rows(tab, ids))
                     for ids in (t, flat1, hop2.reshape(-1))]
        M, K = hop2.shape
        N, F = tab.shape
        gen = torch.Generator(device="cpu").manual_seed(3)
        distinct = torch.randperm(N, generator=gen)[
            torch.arange(M * K) % N].to(torch.int32)
        self.means = {"hop2": (tab, hop2),
                      "distinct": (tab, distinct.view(M, K).to(cs.DEVICE))}
        self.mean_want = {k: ref.feature_gather_mean(*a)
                          for k, a in self.means.items()}
        scalar = torch.zeros_like(self.mean_want["hop2"])
        for k in range(K):
            scalar += tab[hop2[:, k].long()] / K
        self.scalar_diff = int((scalar != self.mean_want["hop2"]).sum())
        self.bounds = {
            "sample": [cs.sample_bound(ip, a[2], a[3])[0]
                       for a, _ in self.samples],
            "mean": cs.mean_bound(tab, hop2)[0],
            "rows": [cs.bound_ms(4 * ids.numel() + 4 * F * (
                cs.n_unique(ids) + ids.numel()), 0)[0]
                for (_, ids), _ in self.rows]}
        src = torch.empty(M * K * F, device=cs.DEVICE)
        dst = torch.empty_like(src)
        self.copy_ms = timer(lambda: dst.copy_(src))
        del src, dst
        print(f"[ab] inmem: {g.name}, sampler (M, S) "
              f"{[list(a[3].shape) for a, _ in self.samples]}, rows "
              f"{[a[1].numel() for a, _ in self.rows]}, mean ({M}, {K}, "
              f"{F}) over {cs.n_unique(hop2)} distinct rows; bounds "
              f"{self.bounds}; (b) a contiguous copy_ of {M * K * F * 4e-6:.0f}"
              f" MB {self.copy_ms:.4f} ms; the plain mean with a Python-"
              f"scalar divisor differs from the true division in "
              f"{self.scalar_diff} of {M * F} entries")

    def check(self, b) -> list[str]:
        """The edge cases of ``chip_smoke.inmem_edge_inputs`` on this graph
        where the build differs from the plain versions (the mean bit for
        bit)."""
        samples, means = self.edge
        pairs = [(f"sampler {tuple(rand.shape)}, E {ix.numel()}",
                  b.sample(ip, ix, targets, rand),
                  ref.neighbor_sample(ip, ix, targets, rand), False)
                 for ip, ix, targets, rand in samples]
        pairs += [(f"mean {tuple(ids.shape)}, F {table.shape[1]}",
                   b.mean(table, ids), ref.feature_gather_mean(table, ids),
                   True) for table, ids in means]
        return differing(pairs)

    def turn(self, name: str, b, timer) -> dict:
        row = {"sample_ms": [], "rows_ms": [], "mean_ms": {}}
        for a, want in self.samples:
            equal(b.sample(*a), want, f"{name}: sampler {tuple(a[3].shape)}")
            row["sample_ms"].append(timer(lambda: b.sample(*a)))
        for a, want in self.rows:
            equal(b.rows(*a), want, f"{name}: rows {a[1].numel()}")
            row["rows_ms"].append(timer(lambda: b.rows(*a)))
        for k, a in self.means.items():
            cs.check(cs.bit_equal(b.mean(*a), self.mean_want[k]),
                     f"{name}: mean {k} differs from the plain version")
            row["mean_ms"][k] = timer(lambda: b.mean(*a))
        mean = row["mean_ms"]["hop2"]
        row["mean_share_of_bound"] = self.bounds["mean"] / mean
        print(f"[ab]   inmem: sampler "
              + ", ".join(f"{ms:.5f}" for ms in row["sample_ms"])
              + " ms; rows " + ", ".join(f"{ms:.4f}" for ms in row["rows_ms"])
              + f" ms; mean {mean:.4f} ms ({100 * row['mean_share_of_bound']:.1f}"
              f" % of its bound), (a) distinct ids "
              f"{row['mean_ms']['distinct']:.4f} ms")
        return row

    def meta(self) -> dict:
        return {"sample_shapes": [list(a[3].shape) for a, _ in self.samples],
                "rows": [a[1].numel() for a, _ in self.rows],
                "mean_shape": list(self.means["hop2"][1].shape),
                "bounds_ms": self.bounds, "contiguous_copy_ms": self.copy_ms,
                "scalar_divisor_entries_differ": self.scalar_diff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", action="append", default=[],
                    metavar="NAME=DIR",
                    help="the root of another tree's src/repro_torch, "
                         "timed under NAME")
    ap.add_argument("--order", default="tree",
                    help="comma-separated builds, one timed turn each")
    ap.add_argument("--kernels", default="cached",
                    help=f"comma-separated kernel groups of {GROUPS}")
    ap.add_argument("--flush", choices=("write", "read"), default="write",
                    help="how L2 is flushed before each timed launch: "
                         "rewritten (chip_smoke's Timer, the default) or "
                         "read (clean lines)")
    args = ap.parse_args(argv)
    roots = {"tree": ROOT}
    for spec in args.build:
        name, sep, path = spec.partition("=")
        if not sep or not name or name in roots:
            ap.error(f"--build {spec!r}: expected a new NAME=DIR")
        roots[name] = Path(path).resolve()
    order = args.order.split(",")
    unknown = set(order) - set(roots)
    if unknown:
        ap.error(f"--order names unknown builds {sorted(unknown)}")
    groups = args.kernels.split(",")
    if not groups or set(groups) - set(GROUPS):
        ap.error(f"--kernels takes a comma-separated list of {GROUPS}")
    if not torch.cuda.is_available():
        print("torch_cached_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    builds = {n: load_build(n, roots[n]) for n in dict.fromkeys(order)}
    card = cs.card_line()
    print(f"[ab] {card}; builds {list(builds)}, order {order}, kernels "
          f"{groups}")
    for name, b in builds.items():
        report_build(name, b)
    timer = cs.Timer() if args.flush == "write" else CleanTimer()
    made = {"cached": Cached, "inmem": InMemory}
    cases = {gname: made[gname](timer) for gname in groups}
    edge = {name: [f"{gname}: {case}" for gname, c in cases.items()
                   for case in c.check(b)] for name, b in builds.items()}
    for name, bad in edge.items():
        print(f"[ab] {name}: " + (f"differs from the plain versions at the "
                                  f"edge cases {bad}" if bad else
                                  "bit-equal to the plain versions at every "
                                  "edge case"))

    turns = []
    for turn, name in enumerate(order):
        floor = cs.launch_floor_ms(timer)
        print(f"[ab] turn {turn} {name}: floor {floor:.5f} ms")
        row = {"turn": turn, "build": name, "floor_ms": floor}
        for gname, c in cases.items():
            row[gname] = c.turn(name, builds[name], timer)
        turns.append(row)
    out = {"card": card, "device": torch.cuda.get_device_name(0),
           "order": order, "flush": args.flush, "kernels": groups,
           "roots": {n: str(roots[n]) for n in builds},
           "edge_cases_differing": edge,
           **{gname: c.meta() for gname, c in cases.items()},
           "turns": turns}
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    path = ROOT / "chiprun_out" / (f"kernels_ab_{'+'.join(groups)}_"
                                   f"{args.flush}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
