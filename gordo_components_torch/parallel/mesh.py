"""The 1-D ``models`` mesh the sharded bank places its stacks on.

Counterpart of ``gordo_components_tpu/parallel/mesh.py``. A mesh is an
ordered tuple of ``torch.device``s along one axis, ``models``: a stacked
member axis is split into contiguous blocks, block d on device d
(:func:`shard_blocks`, the counterpart of ``shard_model_axis``). By
default it spans every card (``torch.cuda.device_count()``).

One device may be named several times (``fleet_mesh(devices=[dev] * 4)``):
its shards are then logical, each its own block of the stacks and its own
kernel launches on that device. That is the counterpart of the JAX tests'
virtual devices (``--xla_force_host_platform_device_count=8``): the CPU
tests and the smoke shard one device so. :func:`available_devices` is the
device list a mesh and ``build_app(devices=)`` count; a test patches it to
give the CPU several devices.

A mesh never names a device that is not present: a CUDA index at or above
``torch.cuda.device_count()`` raises, it never lands on the CPU.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from gordo_components_torch.device import resolve_device


def available_devices(kind: str = "cuda") -> List[torch.device]:
    """The devices of ``kind`` present: every card for ``"cuda"`` (none
    without CUDA), one device for ``"cpu"``."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device kind {kind!r} (cuda or cpu)")


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along the ``models`` axis."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _check(dev: torch.device) -> torch.device:
    """``dev`` resolved (CUDA present, full-precision products), with an
    index; a card that is not present raises."""
    dev = resolve_device(dev)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device {dev} is not present ({torch.cuda.device_count()} card(s))")
        dev = torch.device("cuda", index)
    return dev


def fleet_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
               kind: str = "cuda") -> Mesh:
    """A 1-D ``models`` mesh over ``devices`` (default every device of
    ``kind`` that :func:`available_devices` lists), cut to the first
    ``n_devices``. All its devices are of one kind."""
    if devices is None:
        devices = available_devices(kind)
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise RuntimeError(f"no {kind} device to build a mesh over")
    resolved = tuple(_check(torch.device(d)) for d in devices)
    if len({d.type for d in resolved}) != 1:
        raise ValueError(f"a mesh's devices are of one kind, got {[str(d) for d in resolved]}")
    return Mesh(resolved)


def pad_count_to_mesh(count: int, mesh: Mesh) -> int:
    """Smallest multiple of the mesh's ``models`` size >= ``count``."""
    size = mesh.size
    return -(-count // size) * size


def shard_blocks(count: int, mesh: Mesh) -> List[Tuple[int, int]]:
    """The contiguous ``[start, stop)`` block of a stack of ``count``
    members (a multiple of the mesh's size) that each device holds."""
    if count % mesh.size:
        raise ValueError(f"a stack of {count} does not split over {mesh.size} shard(s)")
    size = count // mesh.size
    return [(d * size, (d + 1) * size) for d in range(mesh.size)]
