"""Meshes, mirroring ``repro.launch.mesh``: axis names and sizes, and how
the members of an axis talk.

A ``Mesh`` has one of three transports:

  * ``"process"``: one member per process of the initialized
    ``torch.distributed`` group (NCCL across cards, gloo on the CPU);
    ``to_device_mesh`` builds its ``DeviceMesh``;
  * ``"local"``: every member on one device, as a leading [n] dim (the
    port's counterpart of the JAX package's forced host devices: NCCL
    refuses two ranks on one GPU);
  * ``None``: abstract, names and sizes only (``make_production_mesh``),
    which the sharding rules read.

The constructors build nothing on a device and start no process.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import resolve_device
from repro_torch.dist import collectives

AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    transport: str | None = None  # "process", "local" or None (abstract)
    device: torch.device | None = None  # a "local" mesh's device

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} for sizes {self.sizes}")
        if self.transport not in ("process", "local", None):
            raise ValueError(f"transport {self.transport!r}")

    @property
    def shape(self) -> dict:
        """axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def axis(self, name: str):
        """The ring axis ``name`` for ``dist.collectives``: a ``LocalAxis`` of
        its size on a "local" mesh, a ``ProcessAxis`` over its process
        group on a "process" one."""
        if name not in self.axis_names:
            raise ValueError(f"no axis {name!r} in {self.axis_names}")
        if self.transport == "local":
            if self.size != self.shape[name]:
                raise ValueError(f"a local ring runs over a 1-D mesh, not {self.shape}")
            return collectives.LocalAxis(self.shape[name], self.device)
        if self.transport == "process":
            group = None if len(self.sizes) == 1 else self.to_device_mesh().get_group(name)
            return collectives.ProcessAxis(group)
        raise ValueError("an abstract mesh has no members")

    def to_device_mesh(self):
        """The ``torch.distributed`` ``DeviceMesh`` of a "process" mesh, on
        each process's current device type."""
        if self.transport != "process":
            raise ValueError(f"a {self.transport or 'abstract'} mesh has no device mesh")
        from torch.distributed.device_mesh import init_device_mesh

        kind = "cuda" if torch.cuda.is_available() else "cpu"
        return init_device_mesh(kind, self.sizes, mesh_dim_names=self.axis_names)


def _members(sizes: tuple[int, ...], axes: tuple[str, ...], device) -> Mesh:
    """A "process" mesh where an initialized group has exactly that many
    processes, else a "local" one on ``device`` (``None`` means "cuda")."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == math.prod(sizes):
        return Mesh(axes, sizes, "process")
    return Mesh(axes, sizes, "local", resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 chips a pod; 2 pods for the multi-pod run (abstract)."""
    if multi_pod:
        return Mesh(AXES, (2, 16, 16))
    return Mesh(AXES[1:], (16, 16))


def make_mesh_like(shape: tuple[int, ...], device=None) -> Mesh:
    """A mesh of any shape, its axes the last of ("pod", "data", "model")."""
    return _members(tuple(shape), AXES[-len(shape):], device)


def make_pod_mesh(n_pods: int, device=None) -> Mesh:
    """A 1-D pod mesh: every member one pod gateway, the grad sync's ring
    (``--grad-sync seqbalance``)."""
    return _members((n_pods,), ("pod",), device)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
