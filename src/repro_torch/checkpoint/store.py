"""Atomic, asynchronous checkpoints of a training state, in PyTorch.

The torch counterpart of the reference's ``checkpoint/store.py``, with
its on-disk format, so that each package reads the other's checkpoints:

* one ``step_%08d.npz`` per checkpoint holding the flattened state (nested
  dicts and lists, keys joined with ``/``, written in sorted order) and a
  JSON manifest ``step_%08d.npz.json`` with ``step``, ``keys`` (sorted),
  ``time`` and whatever ``manifest_extra`` the run adds (the GNN's
  ``pipeline_spec``);
* both are written to ``<name>.tmp-<pid>`` and renamed into place, so a
  crash mid-save never leaves a partial checkpoint under a real name;
* tensors are stored as the numpy arrays of their values; a Python int
  (the step counter) as a 0-d int32, as the reference's ``jnp.int32``
  step.  A bfloat16 leaf raises: ``np.savez`` has no bfloat16 and stores
  it as raw ``|V2``, which neither package can read back (both packages'
  training states are float32).

``AsyncSaver.save_async`` copies every leaf to host memory before it
returns (on the calling thread's current stream, after the work queued
there), so the optimizers' in-place updates of the next step cannot tear
the snapshot; the file is then written on a background thread that
touches host memory only.  ``restore`` returns the tree as tensors on
``device`` (the mesh placement of the reference's ``shardings`` is not
part of the port).
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _host_leaf(key: str, x) -> np.ndarray:
    """One leaf as a numpy array that shares no memory with ``x``."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {key!r} is bfloat16, which npz cannot "
                "store; keep training state in float32")
        return x.detach().to("cpu", copy=True).numpy()
    if isinstance(x, (int, np.integer)) and not isinstance(x, bool):
        return np.asarray(x, np.int32)
    return np.array(x)


def _to_host(state) -> dict:
    """The flattened state, every leaf copied to host memory."""
    return {k: _host_leaf(k, v) for k, v in _flatten(state).items()}


def _write(ckpt_dir: str, step: int, flat: dict,
           manifest_extra: dict | None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + f".tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    manifest = {"step": int(step), "keys": sorted(flat),
                "time": time.time(), **(manifest_extra or {})}
    mtmp = path + ".json" + f".tmp-{os.getpid()}"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.rename(tmp, path)                    # atomic publish
    os.rename(mtmp, path + ".json")
    return path


def save(ckpt_dir: str, step: int, state, *,
         manifest_extra: dict | None = None) -> str:
    """Synchronous atomic save of ``state`` (nested dicts of tensors,
    arrays and ints) as checkpoint ``step``.  ``manifest_extra`` entries
    (JSON-serializable) are merged into the manifest.  Returns the
    checkpoint's path."""
    return _write(ckpt_dir, step, _to_host(state), manifest_extra)


class AsyncSaver:
    """Background-thread checkpoint writer with at most one in flight."""

    def __init__(self, ckpt_dir: str, *, manifest_extra: dict | None = None):
        self.ckpt_dir = ckpt_dir
        self.manifest_extra = manifest_extra
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_path: str | None = None

    def save_async(self, step: int, state) -> None:
        """Snapshot ``state`` to host memory now, write it in the
        background."""
        self.wait()
        flat = _to_host(state)

        def run():
            try:
                self.last_path = _write(self.ckpt_dir, step, flat,
                                        self.manifest_extra)
            except BaseException as e:      # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(f[5:-4]) for f in os.listdir(ckpt_dir)
                  if f.startswith("step_") and f.endswith(".npz"))


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _resolve_step(ckpt_dir: str, step: int | None) -> int:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return step


def read_manifest(ckpt_dir: str, step: int | None = None) -> dict:
    """A checkpoint's JSON manifest (the latest step's by default)."""
    step = _resolve_step(ckpt_dir, step)
    with open(os.path.join(ckpt_dir, f"step_{step:08d}.npz.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int | None = None, *, device="cuda",
            like=None):
    """Restore a checkpoint (the latest by default) as nested dicts of
    tensors on ``device``.  ``like``: an optional tree of the same
    structure whose leaves' dtypes the restored leaves are cast to.
    Returns ``(tree, step)``."""
    step = _resolve_step(ckpt_dir, step)
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}.npz")) as z:
        flat = {k: z[k] for k in z.files}
    for k, a in flat.items():
        if a.dtype.kind == "V":
            raise TypeError(f"checkpoint leaf {k!r} has the raw dtype "
                            f"{a.dtype} (a bfloat16 saved by np.savez); "
                            "it cannot be read back")
    dtypes = ({k: v.dtype for k, v in _flatten(like).items()}
              if like is not None else {})
    device = torch.device(device)
    tensors = {}
    for k, a in flat.items():
        t = torch.from_numpy(a)
        tensors[k] = t.to(device=device, dtype=dtypes.get(k, t.dtype))
    return _unflatten(tensors), step


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        for suffix in (".npz", ".npz.json"):
            p = os.path.join(ckpt_dir, f"step_{s:08d}" + suffix)
            if os.path.exists(p):
                os.remove(p)
