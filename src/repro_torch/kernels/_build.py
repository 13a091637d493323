"""Build the CUDA kernels under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` into its own shared library (no PyTorch headers, so a build takes
seconds).  Libraries are built at first use into ``csrc/build/`` (listed in
``.gitignore``), all missing ones at once in parallel, and are named by a
digest of the source, the shared headers and the flags, so an edited
source or header is rebuilt.
Nothing here runs when the module is imported.  One module lock covers
the build and each entry point's first load: threads that launch their
first kernel at the same time (the lanes of the overlapped pipeline)
start one ``nvcc`` per source between them, never two into one
temporary file.

Every entry point takes ``c_void_p`` for each pointer and for the stream,
launches on that stream and returns ``cudaGetLastError()``; ``check``
raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("neighbor_sample", "feature_gather", "flash_attention",
           "flash_attention_bwd", "decode_attention", "ssd_chunk_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_FUNCS: dict[tuple[str, str], object] = {}
_LOCK = threading.RLock()


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
    carries a digest of the source, of every shared header ``csrc/*.cuh``
    and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is missing, one ``nvcc``
    per source, all started together.  Returns the compiler output of
    each library built (ptxas's register and spill report)."""
    with _LOCK:
        return _build_missing(names)


def _build_missing(names) -> dict[str, str]:
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


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_kernel<64>`` from an Itanium-mangled kernel name: the
    length-prefixed identifier that ends in ``_kernel`` (its length is
    the tail of a run of digits) and its integer or bool template
    arguments; the mangled name if there is none."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        start = m.start() + len(m.group(1))
        ident = mangled[start:start + int(m.group(1))]
        if ident.endswith("_kernel"):
            args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[start + len(ident):])
            if args:
                ident += "<" + ", ".join(re.findall(r"L[a-z](\d+)E",
                                                    args.group(1))) + ">"
            return ident
    return mangled


def ptxas_report(logs: dict[str, str]) -> list[dict]:
    """Each kernel's registers and spill bytes from ``build()``'s logs
    (nvcc runs with ``-Xptxas -v``): one dict per kernel with its source,
    name, registers, spill stores and spill loads."""
    out = []
    for src, log in logs.items():
        row = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                row = {"source": src, "kernel": _kernel_name(m.group(1)),
                       "registers": None, "spill_stores": None,
                       "spill_loads": None}
                out.append(row)
                continue
            if row is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                row["spill_stores"], row["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                row["registers"] = int(m.group(1))
    return out


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, built and
    loaded at first use, with its ``argtypes`` and ``restype`` set."""
    fn = _FUNCS.get((name, symbol))
    if fn is not None:
        return fn
    with _LOCK:
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
