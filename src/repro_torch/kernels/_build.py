"""Build the CUDA kernels under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` into its own shared library (no PyTorch headers, so a build takes
seconds).  Libraries are built at first use into ``csrc/build/`` (listed in
``.gitignore``), all missing ones at once in parallel, and are named by a
digest of the source and the flags, so an edited source is rebuilt.
Nothing here runs when the module is imported.

Every entry point takes ``c_void_p`` for each pointer and for the stream,
launches on that stream and returns ``cudaGetLastError()``; ``check``
raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("neighbor_sample", "feature_gather", "flash_attention",
           "flash_attention_bwd", "decode_attention", "ssd_chunk_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_FUNCS: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the card")


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: the file name
    carries a digest of the source and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is missing, one ``nvcc``
    per source, all started together.  Returns the compiler output of
    each library built (ptxas's register and spill report)."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        logs[n] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(n)
            continue
        for old in BUILD_DIR.glob(f"lib{n}-*.so"):
            old.unlink()
        os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}.cu\n{logs[n]}" for n in failed))
    return logs


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, built and
    loaded at first use, with its ``argtypes`` and ``restype`` set."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        build()
        fn = getattr(ctypes.CDLL(str(lib_path(name))), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FUNCS[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
