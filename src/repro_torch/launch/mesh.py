"""Meshes, mirroring ``repro.launch.mesh``: axis names and sizes, and how
the members of an axis talk.

A ``Mesh`` has one of three transports:

  * ``"process"``: one member per rank of the initialized
    ``torch.distributed`` group (NCCL across cards, gloo on the CPU, or
    the "fake" group of ``fake_group``, where this process is one rank of
    many and the collectives move nothing); ``to_device_mesh`` builds its
    ``DeviceMesh``;
  * ``"local"``: every member on one device, as a leading [n] dim (the
    port's counterpart of the JAX package's forced host devices: NCCL
    refuses two ranks on one GPU);
  * ``None``: abstract, names and sizes only (``make_production_mesh``),
    which the sharding rules read.

The constructors build nothing on a device and start no process; nothing
is built, and no environment variable set, at import.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import resolve_device
from repro_torch.dist import collectives
from repro_torch.models.common import real_tensors

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
        each process's current device type; built once a group (its
        subgroups are process groups of their own)."""
        if self.transport != "process":
            raise ValueError(f"a {self.transport or 'abstract'} mesh has no device mesh")
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        kind = "cuda" if torch.cuda.is_available() else "cpu"
        key = (self.axis_names, self.sizes, kind, id(dist.group.WORLD))
        if key not in _DEVICE_MESHES:
            with real_tensors():
                _DEVICE_MESHES[key] = init_device_mesh(kind, self.sizes,
                                                       mesh_dim_names=self.axis_names)
        return _DEVICE_MESHES[key]


_DEVICE_MESHES: dict = {}  # (axes, sizes, device type, world group) -> DeviceMesh
_SUBMESHES: dict = {}  # (id of a DeviceMesh, axes) -> (the mesh, its submesh)


def submesh(dm, axes: tuple):
    """``dm[axes]``, built once a DeviceMesh."""
    key = (id(dm), tuple(axes))
    if key not in _SUBMESHES:
        with real_tensors():
            _SUBMESHES[key] = (dm, dm[tuple(axes)])
    return _SUBMESHES[key][1]


def _register_fake_backend() -> None:
    """torch's "fake" backend (``torch.testing._internal.distributed.fake_pg``,
    copied: that module is for torch's own tests), unless it is registered."""
    import torch.distributed as dist

    if "fake" in getattr(dist.Backend, "_plugins", {}):
        return
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        return FakeProcessGroup._create_internal(common_opts.group_rank,
                                                 common_opts.group_size, backend_opts)

    dist.Backend.register_backend("fake", create, extended_api=True, devices=["cpu", "cuda"])


def fake_group(world: int, rank: int = 0) -> None:
    """Make the default ``torch.distributed`` group a "fake" group of
    ``world`` ranks in which this process is rank ``rank``: no other
    process exists, and a collective returns at once with its output's
    shape and garbage in it (the dry run's and one rank's view of a
    production mesh).  A group already up of another kind or size is
    destroyed first."""
    import torch.distributed as dist

    if dist.is_initialized():
        if (dist.get_backend() == "fake" and dist.get_world_size() == world
                and dist.get_rank() == rank):
            return
        dist.destroy_process_group()
    # meshes of an earlier group hold its destroyed subgroups, and the new
    # world group may reuse the old one's id, which keys the cache
    _DEVICE_MESHES.clear()
    _SUBMESHES.clear()
    _register_fake_backend()

    class FakeStore(dist.Store):
        """The key-value store the fake group is initialized with (unused)."""

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


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


def fake_mesh(shape: tuple[int, ...], rank: int = 0) -> Mesh:
    """A "process" mesh of ``shape`` (its axes the last of ("pod", "data",
    "model")) over a fake group of its size, this process its rank
    ``rank`` (``fake_group``)."""
    shape = tuple(shape)
    fake_group(math.prod(shape), rank)
    return Mesh(AXES[-len(shape):], shape, "process")


def fake_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """``make_production_mesh``'s 16 x 16 or 2 x 16 x 16 over a fake group
    of 256 or 512 ranks."""
    return fake_mesh(make_production_mesh(multi_pod=multi_pod).sizes, rank)


def make_mesh_like(shape: tuple[int, ...], device=None) -> Mesh:
    """A mesh of any shape, its axes the last of ("pod", "data", "model")."""
    return _members(tuple(shape), AXES[-len(shape):], device)


def make_pod_mesh(n_pods: int, device=None) -> Mesh:
    """A 1-D pod mesh: every member one pod gateway, the grad sync's ring
    (``--grad-sync seqbalance``)."""
    return _members((n_pods,), ("pod",), device)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
