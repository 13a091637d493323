"""The port stands alone: it imports neither ``jax`` nor ``repro``, and its
CLI runs on the CPU only when asked and otherwise fails loudly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"


def _run(args, timeout=300):
    # two torch threads, as the mesh tests' ranks take: the suite's other
    # workers share the host's cores
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env)


PORT_MODULES = ("repro_torch", "repro_torch.launch.train",
                "repro_torch.core.sampler", "repro_torch.obs.names",
                "repro_torch.storage", "repro_torch.storage.store",
                "repro_torch.storage.devcache", "repro_torch.storage.blockdev",
                "repro_torch.storage.integrity", "repro_torch.storage.specs",
                "repro_torch.launch.serve", "repro_torch.launch.shapes",
                "repro_torch.train.steps", "repro_torch.models.transformer",
                "repro_torch.models.attention", "repro_torch.models.layers",
                "repro_torch.models.params", "repro_torch.models.registry",
                *(f"repro_torch.configs.{m}" for m in (
                    "qwen2_0_5b", "codeqwen1_5_7b", "mistral_nemo_12b",
                    "gemma3_1b", "mamba2_370m", "mixtral_8x7b",
                    "moonshot_v1_16b_a3b", "qwen2_vl_7b", "hymba_1_5b",
                    "seamless_m4t_large_v2")),
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.decode_attention",
                "repro_torch.kernels.ssd_chunk_scan", "repro_torch.models.ssm",
                "repro_torch.convert",
                "repro_torch.kernels.ops", "repro_torch.kernels.ref",
                "repro_torch.data", "repro_torch.data.tokens",
                "repro_torch.optim", "repro_torch.optim.adamw",
                "repro_torch.optim.schedules", "repro_torch.core.config",
                "repro_torch.core.pipeline", "repro_torch.storage.faults",
                "repro_torch.checkpoint", "repro_torch.checkpoint.store",
                "repro_torch.obs", "repro_torch.obs.metrics",
                "repro_torch.obs.tracer", "repro_torch.obs.session",
                "repro_torch.obs.summary", "repro_torch.isp",
                "repro_torch.isp.protocol", "repro_torch.isp.transport",
                "repro_torch.isp.server", "repro_torch.isp.client",
                "repro_torch.core.isp", "repro_torch.core.partition",
                "repro_torch.launch.mesh", "repro_torch.storage.engines",
                "repro_torch.storage.e2e", "repro_torch.launch.dryrun",
                "repro_torch.roofline", "repro_torch.roofline.analysis")


def test_import_leaves_out_jax_and_repro():
    code = (f"import sys, {', '.join(PORT_MODULES)}\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr


def test_no_source_file_imports_jax_or_repro():
    found = []
    paths = list(PORT.rglob("*.py"))
    for mod in PORT_MODULES[1:]:
        rel = Path(*mod.split(".")[1:])
        assert (PORT / rel.with_suffix(".py")) in paths or \
            (PORT / rel / "__init__.py") in paths, mod
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [(path.name, n) for n in names
                      if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not found, found


def test_cli_trains_on_cpu_when_asked():
    out = _run(["-m", "repro_torch.launch.train", "--device", "cpu",
                "--steps", "2", "--batch", "8", "--fanouts", "3,2",
                "--hidden", "16", "--log-every", "1"])
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("loss=") == 2
    assert "steps/s, consumer idle" in out.stdout


def test_cli_without_gpu_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = _run(["-m", "repro_torch.launch.train", "--steps", "1"])
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr


def test_serve_cli_on_cpu_when_asked():
    out = _run(["-m", "repro_torch.launch.serve", "--device", "cpu",
                "--arch", "qwen2-0.5b", "--batch", "2", "--prompt-len", "16",
                "--gen", "4"])
    assert out.returncode == 0, out.stderr
    assert "prefill(2x16)" in out.stdout and "decode 3 steps" in out.stdout
    assert "ms/step" in out.stdout and "tok/s" in out.stdout
    assert "sample token ids:" in out.stdout


def test_serve_cli_without_gpu_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = _run(["-m", "repro_torch.launch.serve", "--gen", "2"])
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr


def test_cli_rejects_flags_of_later_slices():
    """``--backend isp`` (ROADMAP item 14), ``--storage-engine`` (item 13)
    and ``--mesh 4x1`` (item 16, part 1: the GNN's mesh of 4 shards, as
    ``--devices 4``) run; so does ``--mesh 1x2`` (item 16, part 2a: the
    GNN's ``model`` positions replicate, as the reference's do), with
    the one-shard run's losses."""
    small = ["-m", "repro_torch.launch.train", "--device", "cpu", "--steps",
             "2", "--batch", "8", "--fanouts", "3,2", "--hidden", "16",
             "--log-every", "1"]
    out = _run(small + ["--backend", "isp"])
    assert out.returncode == 0, out.stderr
    assert "backend=isp" in out.stdout and out.stdout.count("loss=") == 2, \
        out.stdout
    out = _run(small + ["--backend", "host", "--graph-store", "disk",
                        "--storage-engine", "mmap"])
    assert out.returncode == 0, out.stderr
    assert "engine=mmap" in out.stdout and "measured-vs-simulated" in \
        out.stdout, out.stdout
    out = _run(small + ["--mesh", "4x1"])
    assert out.returncode == 0, out.stderr
    assert "mesh of 4 shard(s)" in out.stdout and out.stdout.count("loss=") \
        == 2, out.stdout
    one = _run(small)
    assert one.returncode == 0, one.stderr
    out = _run(small + ["--mesh", "1x2"])
    assert out.returncode == 0, out.stderr
    assert "mesh of 1 shard(s)" in out.stdout, out.stdout
    losses = [ln.split("loss=")[1].split()[0]
              for ln in out.stdout.splitlines() if "loss=" in ln]
    assert len(losses) == 2 and losses == [
        ln.split("loss=")[1].split()[0]
        for ln in one.stdout.splitlines() if "loss=" in ln], (out.stdout,
                                                             one.stdout)


def test_isp_server_process_imports_numpy_only(tmp_path):
    """``python -m repro_torch.isp.server`` as the pipeline spawns it: it
    serves a client and exits 0 at SHUTDOWN, having imported neither
    jax, nor ``repro``, nor torch (``-X importtime`` lists every module
    the process imported)."""
    import json

    from repro_torch.core import load_dataset
    from repro_torch.isp.client import IspClient
    from repro_torch.isp.protocol import Command
    from repro_torch.storage import save_graph

    save_graph(load_dataset("reddit"), str(tmp_path / "g"))
    sock = str(tmp_path / "s.sock")
    config = {"transport": "unix", "address": sock,
              "store": {"path": str(tmp_path / "g")}}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.isp.server",
         "--config", json.dumps(config)], env=env,
        stdin=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        client = IspClient("unix", sock, window=2)
        assert client.hello["num_nodes"] == 1024
        client.call(Command.SHUTDOWN)
        client.close()
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode == 0, err
    mods = {line.rsplit("|", 1)[-1].strip()
            for line in err.splitlines() if line.startswith("import time:")}
    assert {"repro_torch.isp.protocol", "repro_torch.storage.store",
            "repro_torch.core.sampler", "numpy"} <= mods
    bad = [m for m in mods if m.split(".")[0] in ("jax", "repro", "torch")]
    assert not bad, bad
