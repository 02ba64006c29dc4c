"""Device meshes over the current process group.

The port of the JAX package's ``launch/mesh.py``.  Functions, not
module-level constants: importing this module starts nothing.  Both
build an ``init_device_mesh`` over the ranks of the default process group,
which the caller initialises (``torch.distributed.init_process_group``
with its own address, world size and rank), and raise when the world
size is not the mesh's size, as the JAX functions raise when devices are
missing.

Production layout: single-pod ``(16, 16)`` over ``("data", "model")``,
multi-pod ``(2, 16, 16)`` over ``("pod", "data", "model")``; the "pod"
axis carries only data-parallel (or pipeline) traffic, so the
model-parallel traffic stays inside a pod.
"""
from __future__ import annotations

import math
from typing import Tuple


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    n = math.prod(shape)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}; the process "
                           f"group has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    ``(2, 16, 16)`` over ``("pod", "data", "model")`` with
    ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device_type: str = "cuda"):
    """A small mesh over the process group's ranks (tests pass
    ``device_type="cpu"`` on a ``gloo`` group)."""
    return _mesh(tuple(shape), tuple(axes), device_type)
