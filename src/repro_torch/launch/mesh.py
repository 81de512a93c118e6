"""Mesh builders, the port of ``repro.launch.mesh`` (as FUNCTIONS:
importing this module touches no device state).

Single pod: 16 x 16 = 256 devices, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 devices, axes ("pod", "data", "model") —
the "pod" axis is pure data parallelism across pods.

The JAX package builds a mesh from the devices one process sees; the
port runs one process per device (``dist.launch.spawn_ranks``), so a
mesh is built inside a process group, from its ranks: every rank of the
group calls the builder. A world smaller than the mesh raises.
"""
from __future__ import annotations

import math

import torch


def _mesh(shape, axes, device, need_msg: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(need_msg.format(n=n, have=world))
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device,
                 "need {n} devices, have {have} — run one rank a device "
                 "in a process group (dist.launch.spawn_ranks)")


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device=None):
    """A small mesh for tests (requires a process group of >=
    prod(shape) ranks)."""
    return _mesh(shape, axes, device, "need {n} devices for test mesh")
