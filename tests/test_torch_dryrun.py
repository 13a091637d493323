"""The port's dry-run (``repro_torch.launch.dryrun``): its CLI, the LM
kernels' entries on fake tensors (``kernels.ops``) and every family's
steps traced on the production meshes.

* The CLI (the reference's flags, ``--set`` parsed as literals only) on
  one cell cut to 1 layer exits 0 and writes a JSON with the
  reference's keys where they mean the same; a skipped cell is written
  and exits 0, a failed one is written and exits 1, as the reference's.
* On fake CUDA tensors each LM kernel entry launches nothing and returns
  outputs of the shapes, dtypes and strides its kernel's wrapper
  allocates; ``FlopCounterMode`` counts each kernel's formula (the
  operations behind ``chip_smoke.py``'s bounds).  Without autograd: a
  CPU build of PyTorch takes no autograd on fake CUDA tensors.
* Every family's train, prefill and decode steps (reduced configs) trace
  on the (16, 16) mesh, and one arch's on (2, 16, 16): positive FLOPs,
  bytes and peak, collectives over the mesh's groups.
* On (2, 16, 16) a train step whose microbatches outnumber a rank's rows
  traces as the reference's does: a dense and an MoE config run a rank's
  passes, the MoE routing over the ranks that hold a microbatch; one CLI
  cell of seamless-m4t-large-v2 (one layer each side) runs 8 passes of
  one row a rank.
* ``--set moe_groups=`` with dispatch groups that span a microbatch's
  ranks (8 over 16 on (16, 16), 16 over 32 on (2, 16, 16)): one layer of
  moonshot train_4k traces, as the reference's does.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh
from repro_torch.launch.shapes import ShapeCell
from repro_torch.models.registry import get_config

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
KEYS = {"arch", "shape", "mesh", "tag", "kind", "n_chips", "device", "ok",
        "ce", "params_total", "params_active", "microbatches", "trace_s",
        "memory", "cost", "collectives", "roofline", "model_flops_total"}
TERMS = {"flops_per_chip", "bytes_per_chip", "link_bytes_per_chip",
         "n_chips", "compute_s", "memory_s", "collective_s", "bound",
         "model_flops_per_chip", "useful_flops_ratio", "step_time_s",
         "roofline_fraction"}
FAMILIES = ("qwen2-0.5b", "gemma3-1b", "mixtral-8x7b", "mamba2-370m",
            "hymba-1.5b", "qwen2-vl-7b", "seamless-m4t-large-v2")
KINDS = (("train", 32, 32), ("prefill", 32, 32), ("decode", 64, 32))


def test_cli_writes_a_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "train_4k", "--set", "num_layers=1",
         "--device", "cpu", "--out", str(tmp_path), "--tag", "one"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "dry-run complete: 1 cells, 0 failures" in r.stdout
    rec = json.loads((tmp_path / "qwen2-0.5b__train_4k__16x16__one.json")
                     .read_text())
    assert set(rec) == KEYS | {"cfg_overrides"}
    assert rec["ok"] and rec["n_chips"] == 256 and rec["device"] == "cpu"
    assert rec["microbatches"] == dryrun.TRAIN_MICROBATCHES["qwen2-0.5b"]
    assert rec["cfg_overrides"] == {"num_layers": "1"}
    assert set(rec["roofline"]) == TERMS
    mem = rec["memory"]
    assert mem["per_chip_live_bytes"] > mem["state_bytes"] > 0
    assert mem["fits_hbm"] == (mem["per_chip_live_bytes"] < 80e9)
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    counts = rec["collectives"]["counts"]
    # ZeRO's gather and reduce-scatter over "data", the sums over "model"
    assert counts["all-gather"] == counts["reduce-scatter"] > 0
    assert counts["all-reduce"] > 0
    assert rec["collectives"]["link_bytes_per_chip"] > 0


def test_cli_records_skips_and_failures(tmp_path, capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / "qwen2-0.5b__long_500k__16x16__baseline"
                      ".json").read_text())
    assert rec["ok"] and rec["skipped"] and "sub-quadratic" in \
        rec["skip_reason"]
    # 16 rows a rank do not split into 3 microbatches: recorded, exit 1
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                     "--microbatches", "3", "--device", "cpu", "--out",
                     str(tmp_path), "--multi-pod"])
    assert done.value.code == 1
    rec = json.loads((tmp_path / "qwen2-0.5b__train_4k__2x16x16__baseline"
                      ".json").read_text())
    assert not rec["ok"] and "3 microbatches" in rec["error"]
    assert "1 failures" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()


def test_set_takes_literals_only():
    assert dryrun.parse_set(["remat='dots'", "num_layers=2",
                             "attn_remat=True"]) == {
        "remat": "dots", "num_layers": 2, "attn_remat": True}
    with pytest.raises(ValueError):
        dryrun.parse_set(["num_layers=__import__('os').getpid()"])


def _fake_cuda(*shapes, dtype=torch.bfloat16):
    return [torch.empty(s, dtype=dtype, device="cuda") for s in shapes]


def _counted(fn):
    """``fn()``'s outputs and its FLOPs by op under FlopCounterMode, with
    no kernel launched."""
    before = dict(kernels.LAUNCHES)
    with FlopCounterMode(display=False) as fc:
        out = fn()
    assert kernels.LAUNCHES == before
    return out, {str(k): v for k, v in fc.get_flop_counts()["Global"]
                 .items()}


def test_fake_flash_entries_allocate_as_the_kernels():
    B, S, Hq, Hkv, D = 2, 96, 6, 2, 64
    with FakeTensorMode(), torch.no_grad():
        q, do = _fake_cuda((B, S, Hq, D), (B, S, Hq, D))
        k, v = _fake_cuda((B, S, Hkv, D), (B, S, Hkv, D))
        (out, lse), flops = _counted(lambda: ops.flash_attention_fwd(q, k, v))
        assert (out.shape, out.dtype, out.stride()) == (
            (B, S, Hq, D), torch.bfloat16, (S * Hq * D, Hq * D, D, 1))
        assert (lse.shape, lse.dtype, lse.stride()) == (
            (B, Hq, S), torch.float32, (Hq * S, S, 1))
        assert out.is_cuda and lse.is_cuda
        assert flops == {"repro_torch.flash_attention_fwd":
                         2 * B * Hq * S * S * D}
        for causal in (True, False):
            (dq, dk, dv), flops = _counted(lambda: ops.flash_attention_bwd(
                q, k, v, out, lse, do, causal=causal))
            assert (dq.shape, dq.dtype, dq.stride()) == (
                q.shape, torch.bfloat16, q.stride())
            for g in (dk, dv):
                assert (g.shape, g.dtype, g.stride()) == (
                    k.shape, torch.bfloat16, k.stride())
            product = 2 * B * Hq * (S * (S + 1) // 2 if causal
                                    else S * S) * D
            assert flops == {"repro_torch.flash_attention_bwd_dq":
                             3 * product,
                             "repro_torch.flash_attention_bwd_dkv":
                             4 * product}


@pytest.mark.parametrize("valid_len,window", [(100, 0), (70, 32), (1, 0)])
def test_fake_decode_entry_allocates_as_the_kernel(valid_len, window):
    B, S, Hq, Hkv, D = 3, 100, 8, 2, 128
    with FakeTensorMode(), torch.no_grad():
        (q,) = _fake_cuda((B, Hq, D))
        k, v = _fake_cuda((B, S, Hkv, D), (B, S, Hkv, D))
        out, flops = _counted(lambda: ops.decode_attention(q, k, v,
                                                           valid_len, window))
        assert (out.shape, out.dtype, out.stride()) == (
            (B, Hq, D), torch.bfloat16, (Hq * D, D, 1))
        lo = max(0, valid_len - window) if window else 0
        assert flops == {"repro_torch.decode_attention":
                         4 * B * Hq * (valid_len - lo) * D}


def test_fake_ssd_entry_allocates_as_the_kernel():
    b, s, h, p, g, n, chunk = 2, 128, 4, 16, 2, 8, 32
    with FakeTensorMode(), torch.no_grad():
        x, dt, A, Bm, Cm = _fake_cuda((b, s, h, p), (b, s, h), (h,),
                                      (b, s, g, n), (b, s, g, n),
                                      dtype=torch.float32)
        # the scan's op, as ``ops._ssd_scan`` calls it (``SSDChunkScan``
        # needs autograd, which takes no fake CUDA tensor on a CPU build)
        (y, state), flops = _counted(lambda: ops._ssd_scan(x, dt, A, Bm, Cm,
                                                           chunk))
        assert (y.shape, y.dtype, y.stride()) == (x.shape, torch.float32,
                                                  x.stride())
        assert (state.shape, state.dtype, state.stride()) == (
            (b, h, p, n), torch.float32, (h * p * n, p * n, n, 1))
        pairs = chunk * (chunk + 1) // 2
        assert flops == {"repro_torch.ssd_chunk_scan": 3 * b * (s // chunk) * (
            g * 2 * pairs * n + h * (2 * pairs * p + 4 * chunk * p * n))}


@pytest.mark.parametrize("kind,S,B", KINDS, ids=[k[0] for k in KINDS])
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_traces_on_the_production_mesh(arch, kind, S, B):
    cfg = get_config(arch).reduced()
    # two microbatches in the dense family's step, one elsewhere (time)
    mb = 2 if kind == "train" and arch == FAMILIES[0] else 1
    with production_mesh(False, "cpu") as mesh:
        costs = dryrun.trace_step(cfg, ShapeCell("t", S, B, kind), mesh,
                                  microbatches=mb, device="cpu")
    assert costs.flops > 0 and costs.hbm_bytes > 0
    assert costs.peak_bytes > costs.state_bytes > 0
    assert 1 < costs.collectives.max_group <= 16
    if kind == "train":
        assert costs.collectives.counts["reduce-scatter"] > 0


@pytest.mark.parametrize("kind,S,B", KINDS, ids=[k[0] for k in KINDS])
def test_multi_pod_steps_trace(kind, S, B):
    """The (2, 16, 16) mesh: the rows split over pod x data (32 ranks),
    whose group takes the gradients' reduce-scatter."""
    cfg = get_config("qwen2-0.5b").reduced()
    with production_mesh(True, "cpu") as mesh:
        costs = dryrun.trace_step(cfg, ShapeCell("t", S, 2 * B, kind),
                                  mesh, device="cpu")
    assert costs.flops > 0 and costs.peak_bytes > costs.state_bytes > 0
    if kind == "train":
        assert costs.collectives.max_group == 32


# a rank's rows fewer than the microbatches on (2, 16, 16): arch, B, mb,
# and the layout (ranks a microbatch, side by side, passes, rows a pass)
F5_CASES = (("seamless-m4t-large-v2", 32, 16, (2, 16, 1, 1)),
            ("mixtral-8x7b", 64, 4, (16, 2, 2, 1)))


@pytest.mark.parametrize("arch,B,mb,layout", F5_CASES,
                         ids=[c[0] for c in F5_CASES])
def test_multi_pod_microbatches_outnumber_a_ranks_rows(arch, B, mb, layout,
                                                       monkeypatch):
    """Microbatches run side by side where the 32 pod x data ranks do not
    divide a microbatch's rows, as the reference traces them: the step
    runs a rank's passes, and the MoE routes each microbatch over the
    ranks that hold it (groups of 16 for mixtral's 16-row microbatches)."""
    from repro_torch.models import moe
    from repro_torch.train import steps

    cfg = get_config(arch).reduced()
    shape = ShapeCell("t", 32, B, "train")
    passes, groups = [], []
    ce = steps.CE_IMPLS["gather"]
    monkeypatch.setitem(steps.CE_IMPLS, "gather", lambda *a: passes.append(
        a[1].shape[0]) or ce(*a))
    ranks = moe._ranks
    monkeypatch.setattr(moe, "_ranks", lambda g: groups.append(ranks(g))
                        or ranks(g))
    with production_mesh(True, "cpu") as mesh:
        assert tuple(dryrun.train_layout(shape, mb, mesh)) == layout
        costs = dryrun.trace_step(cfg, shape, mesh, microbatches=mb,
                                  device="cpu")
    assert costs.flops > 0 and costs.peak_bytes > costs.state_bytes > 0
    assert costs.collectives.max_group == 32
    assert costs.collectives.counts["reduce-scatter"] > 0
    # a loss for each pass, over its rows
    assert passes == [layout[3]] * layout[2]
    if cfg.family == "moe":
        # every route of every layer, forward and remat recompute
        assert groups and {n for _, n in groups} == {layout[0]}
    else:
        assert not groups


def test_cli_multi_pod_cell_of_16_microbatches(tmp_path):
    """seamless-m4t-large-v2 train_4k on (2, 16, 16), cut to one layer
    each side: 16 microbatches of 16 rows over 32 ranks, 8 passes of one
    row a rank."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "seamless-m4t-large-v2", "--shape", "train_4k", "--multi-pod",
         "--set", "num_layers=1", "--set", "encoder_layers=1", "--device",
         "cpu", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads((tmp_path / "seamless-m4t-large-v2__train_4k__2x16x16"
                      "__baseline.json").read_text())
    assert rec["ok"] and rec["microbatches"] == 16 and rec["n_chips"] == 512
    assert set(rec) == KEYS | {"cfg_overrides"}
    assert "passes=8 rows_per_pass=1" in r.stdout


# moonshot train_4k's dispatch groups that span ranks: 8 over the 16
# ranks of a microbatch on (16, 16), 16 over its 32 on (2, 16, 16)
SPAN_CELLS = (("16x16", [], 8), ("2x16x16", ["--multi-pod"], 16))


@pytest.mark.parametrize("mesh,flags,groups", SPAN_CELLS,
                         ids=[c[0] for c in SPAN_CELLS])
def test_cli_moe_groups_spanning_ranks(tmp_path, mesh, flags, groups):
    """``--set moe_groups=G`` where G dispatch groups span a microbatch's
    ranks (the reference traces it): one layer of moonshot train_4k exits
    0 with the cell ``ok`` and its overrides recorded."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "moonshot-v1-16b-a3b", "--shape", "train_4k", *flags, "--set",
         "num_layers=1", "--set", f"moe_groups={groups}", "--device", "cpu",
         "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "[OK]" in r.stdout
    rec = json.loads((tmp_path / f"moonshot-v1-16b-a3b__train_4k__{mesh}"
                      "__baseline.json").read_text())
    assert rec["ok"] and set(rec) == KEYS | {"cfg_overrides"}
    assert rec["cfg_overrides"] == {"num_layers": "1",
                                    "moe_groups": str(groups)}
    assert rec["collectives"]["counts"]["all-reduce"] > 0


@pytest.mark.parametrize("arch", dryrun.TRAIN_MICROBATCHES)
def test_full_width_decode_cells_trace(arch):
    """Every arch at full width, cut to one layer (one encoder layer),
    decodes at decode_32k on (16, 16): where the rules split the heads
    over "model" (mamba2's SSM heads, seamless's attention heads) the
    rank's cache holds its own heads and channels, where "model" divides
    S the K and V are split on S."""
    import dataclasses

    from repro_torch.launch.shapes import SHAPES

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=1, encoder_layers=min(
        cfg.encoder_layers, 1))
    with production_mesh(False, "cpu") as mesh:
        costs = dryrun.trace_step(cfg, SHAPES["decode_32k"], mesh,
                                  device="cpu")
    assert costs.flops > 0 and costs.peak_bytes > costs.state_bytes > 0


def test_moe_dispatch_group_reaches_every_thread():
    """The MoE's dispatch group is read on the thread that recomputes a
    rematerialized block in the backward (autograd's own for CUDA
    tensors), not only on the one that entered ``global_dispatch``."""
    import threading

    from repro_torch.models import moe

    group, seen = object(), []
    with moe.global_dispatch(group):
        t = threading.Thread(target=lambda: seen.append(moe._DISPATCH[0]))
        t.start()
        t.join()
    assert seen == [group] and moe._DISPATCH[0] is None
