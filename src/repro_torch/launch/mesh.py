"""Meshes (port of ``repro.launch.mesh``): ``DeviceMesh``es with
the reference's axis names over the ranks of the default process group.

The caller makes the process group (``torch.distributed
.init_process_group``: NCCL for "cuda", gloo for "cpu") and names the
device type; nothing here picks either. Each function raises when the
group's world size is not the mesh's size. ``AbstractMesh`` carries the
axis names and sizes alone, for computing sharding specs without a
process group (``repro_torch.parallel.sharding`` takes either).
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: ``shape`` maps each name to its
    size, in mesh order (the reference's ``mesh.shape``)."""
    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def _make(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"rank")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise ValueError(
            f"need a process group of {n} ranks for mesh "
            f"{dict(zip(axes, shape))}, have none: call "
            f"torch.distributed.init_process_group first (or run under "
            f"torchrun)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"need {n} ranks for mesh {dict(zip(axes, shape))}, have "
            f"{world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str):
    """The deployment mesh: 16 x 16 (data, model), or 2 x 16 x 16 (pod,
    data, model), 'pod' being the slower inter-host axis."""
    if multi_pod:
        return _make((2, 16, 16), ("pod", "data", "model"), device_type)
    return _make((16, 16), ("data", "model"), device_type)


def make_local_mesh(data: int = 1, model: int = 1, *, device_type: str):
    """(data, model) mesh over the group's ranks (tests, one host)."""
    return _make((data, model), ("data", "model"), device_type)


def make_mesh_for_shape(shape: tuple[int, ...], axes: tuple[str, ...], *,
                        device_type: str):
    """Any topology (the elastic restart uses it after a shrink)."""
    return _make(tuple(shape), tuple(axes), device_type)
