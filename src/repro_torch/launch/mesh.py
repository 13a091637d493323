"""Meshes of the port: the GNN's single-controller mesh and the LM's
process mesh.

The mesh ISP backend (``core.isp``) is single-controller, as the
reference's is: a ``Mesh`` is the axis names, the shape and one
``torch.device`` per position on the ``data`` axis, all driven from one
process, and the cross-shard reduction is a sum in that process. On
``cuda``, shard ``s`` lives on card ``s % torch.cuda.device_count()``, so
shards share a card when there are fewer cards than shards (the
counterpart of the reference's placeholder CPU devices); on ``cpu`` every
shard lives on the CPU.

The LM's mesh is a ``torch.distributed`` process group with one process
a mesh position (``make_device_mesh``: a ``DeviceMesh`` whose dims are
named ``("data", "model")``).  Its backend is NCCL when every rank has a
card of its own and gloo when ranks share a card or run on the CPU.
``run_on_mesh`` starts the ranks: under ``torchrun`` it joins the group
that ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` describe; in a process that
already belongs to a group of the mesh's size it uses that group;
otherwise it starts the other ranks itself (``torch.multiprocessing``,
spawned) and runs rank 0 in the calling process, which gets rank 0's
result.  Its ``model`` axis splits the LM's tensor-parallel leaves
(``models.transformer.LM(..., mesh=)``).

The production mesh (``make_production_mesh``) is the reference's target,
(data 16, model 16) on one pod or (pod 2, data 16, model 16) on two, as
a ``DeviceMesh`` over a fake process group: it exists only for the
dry-run (``launch.dryrun``), which traces one rank's step on fake
tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import tempfile

import torch
import torch.distributed as dist

# a collective that waits longer than this raises on every rank (a rank
# that died leaves the others waiting)
TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape[axis]`` is the size of each named axis; ``devices`` holds
    one device per position on the ``data`` axis."""

    axis_names: tuple[str, ...]
    shape: dict
    devices: tuple[torch.device, ...]


def make_mesh(shape, axes, device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` whose ``data`` positions are
    placed on ``device``'s kind of device (see the module docstring).
    The GNN shards its graph on ``data`` only: the positions of the other
    axes (``model``) are replicas, as the reference's GNN leaves them,
    and the single controller computes each ``data`` shard once."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or "data" not in axes:
        raise ValueError(f"mesh shape {shape} over axes {axes}: need one "
                         "size per axis and a 'data' axis")
    sizes = dict(zip(axes, shape))
    if min(shape) < 1:
        raise ValueError(f"mesh {sizes}: every axis needs a size >= 1")
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device")
        devices = tuple(torch.device("cuda", s % count)
                        for s in range(sizes["data"]))
    else:
        devices = (device,) * sizes["data"]
    return Mesh(axis_names=axes, shape=sizes, devices=devices)


def make_host_mesh(device="cuda") -> Mesh:
    """The 1-shard mesh, on ``device`` itself."""
    return Mesh(axis_names=("data", "model"), shape={"data": 1, "model": 1},
                devices=(torch.device(device),))


def mesh_backend(device) -> str:
    """``nccl`` when every rank of this host has a card of its own,
    ``gloo`` when ranks share a card or run on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: on ``cuda`` card ``LOCAL_RANK % count`` (ranks
    share cards when there are fewer cards than ranks), else the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                        % count)


def init_rank(rank: int, world: int, init_method: str, device,
              timeout_s: float = TIMEOUT_S) -> None:
    """Join the process group as ``rank`` of ``world`` (and select this
    rank's card first, so that NCCL and the ``DeviceMesh`` find it;
    ``LOCAL_RANK`` and ``WORLD_SIZE`` are set, by torchrun or
    ``run_on_mesh``)."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        mesh_backend(device), init_method=init_method, world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def make_device_mesh(shape, axes=("data", "model"), device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the default process
    group, whose size must be ``prod(shape)``; ranks fill it in row-major
    order, as the reference's ``make_mesh`` fills its devices."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} over axes {axes}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} "
                         f"ranks, the process group has {world}")
    kind = rank_device(device).type
    return DeviceMesh(kind, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def _threads(device, world: int) -> int:
    """Torch threads a rank takes on the CPU: the cores split evenly, at
    most the threads this process was given."""
    if torch.device(device).type != "cpu":
        return torch.get_num_threads()
    return max(1, min(torch.get_num_threads(),
                      (os.cpu_count() or 1) // world))


def _spawned_rank(rank: int, world: int, init_method: str, shape, axes,
                  device, timeout_s: float, fn, args) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(_threads(device, world))
    init_rank(rank, world, init_method, device, timeout_s)
    try:
        fn(make_device_mesh(shape, axes, device), *args)
    finally:
        dist.destroy_process_group()


def run_on_mesh(shape, axes, device, fn, *args,
                timeout_s: float = TIMEOUT_S):
    """``fn(mesh, *args)`` on every rank of a process mesh of ``shape``
    over ``axes``; returns rank 0's result (see the module docstring for
    how the ranks start).  A rank that fails makes this raise."""
    world = math.prod(int(n) for n in shape)
    if dist.is_initialized():
        return fn(make_device_mesh(shape, axes, device), *args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        init_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                  "env://", device, timeout_s)
        try:
            return fn(make_device_mesh(shape, axes, device), *args)
        finally:
            dist.destroy_process_group()
    import torch.multiprocessing as mp

    saved_env = {k: os.environ.get(k) for k in
                 ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE")}
    saved_threads = torch.get_num_threads()
    with tempfile.TemporaryDirectory(prefix="repro-mesh-") as tmp:
        init = f"file://{tmp}/rendezvous"
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_spawned_rank, daemon=True,
                             args=(r, world, init, shape, axes, device,
                                   timeout_s, fn, args))
                 for r in range(1, world)]
        for p in procs:
            p.start()
        os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(world),
                          LOCAL_WORLD_SIZE=str(world))
        torch.set_num_threads(_threads(device, world))
        try:
            init_rank(0, world, init, device, timeout_s)
            try:
                out = fn(make_device_mesh(shape, axes, device), *args)
            finally:
                dist.destroy_process_group()
        finally:
            torch.set_num_threads(saved_threads)
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            for p in procs:
                p.join(timeout=timeout_s)
                if p.is_alive():
                    p.terminate()
                    p.join()
        failed = [r for r, p in enumerate(procs, 1) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"mesh ranks {failed} exited with "
                               f"{[procs[r - 1].exitcode for r in failed]}")
        return out


# the reference's production meshes: one pod, and two pods on a leading
# "pod" axis that carries only the data-parallel gradient traffic
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(multi_pod: bool = False, device="cuda"):
    """The production mesh for the dry-run, and for nothing else: a
    ``DeviceMesh`` of (16, 16) over ("data", "model"), or of (2, 16, 16)
    over ("pod", "data", "model"), of kind ``device`` ("cuda" or "cpu").

    Its process group is a fake one (PyTorch's ``fake`` backend): this
    process is rank 0 of 256 (512) ranks that do not exist, and a
    collective returns at once without moving or changing anything.  So
    a step traced on fake tensors over it issues the collectives that rank
    0 would, at their shapes, and computes nothing; run for real it would
    be wrong.  The group is started here when this process has none (a
    group that is not a fake one of the mesh's size raises); end it with
    ``torch.distributed.destroy_process_group()``, or use
    ``production_mesh``.  No card is needed: a mesh of kind "cuda" holds
    no device state.  The pod x data group (``sharding.batch_group``) is
    made here, before any fake mode is entered."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.sharding import batch_group

    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    world = math.prod(shape)
    if not dist.is_initialized():
        # importing the module registers the ``fake`` backend
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    elif dist.get_world_size() != world or dist.get_backend() != "fake":
        raise RuntimeError(
            f"make_production_mesh: this process already belongs to a "
            f"{dist.get_backend()} group of {dist.get_world_size()} ranks; "
            f"the production mesh needs a fake group of {world}")
    mesh = DeviceMesh(torch.device(device).type,
                      torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)
    batch_group(mesh)
    return mesh


@contextlib.contextmanager
def production_mesh(multi_pod: bool = False, device="cuda"):
    """``make_production_mesh`` for the body of a ``with``; the fake group
    ends after it when it started here."""
    started = not dist.is_initialized()
    try:
        yield make_production_mesh(multi_pod, device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
