"""The device mesh of the mesh ISP backend (``core.isp``).

The reference's ``launch/mesh.py`` builds a JAX mesh; the mesh ISP
backend is single-controller there, one program driving every shard. The
port keeps that shape: a ``Mesh`` is the axis names, the shape and one
``torch.device`` per position on the ``data`` axis, all driven from one
process, and the cross-shard reduction is a sum in that process
(``core.isp.ISPGraph``). On ``cuda``, shard ``s`` lives on card
``s % torch.cuda.device_count()``, so shards share a card when there are
fewer cards than shards (the counterpart of the reference's placeholder
CPU devices); on ``cpu`` every shard lives on the CPU. The production
mesh and multi-process collectives belong to ROADMAP item 16.
"""

from __future__ import annotations

import dataclasses

import torch


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
    Axes other than ``data`` must have size 1: the port shards nothing
    else yet (ROADMAP item 16)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or "data" not in axes:
        raise ValueError(f"mesh shape {shape} over axes {axes}: need one "
                         "size per axis and a 'data' axis")
    sizes = dict(zip(axes, shape))
    if any(n != 1 for a, n in sizes.items() if a != "data") \
            or sizes["data"] < 1:
        raise ValueError(f"mesh {sizes}: only the 'data' axis may be "
                         "larger than 1 (ROADMAP item 16 shards the rest)")
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
