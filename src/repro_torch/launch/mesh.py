"""The worker mesh -- the port of the reference's ``repro/launch/mesh.py``
for one host.

The reference's DCGD workers are the positions of its mesh's worker axes
(``pod`` x ``data``), one per device, and its CPU tests emulate devices
with ``--xla_force_host_platform_device_count``.  The port's counterpart
is a ``HostMesh``: the sizes of the ``pod``, ``data`` and ``model`` axes
and the device their positions live on.  The ring collectives
(``dist.collectives``) run every position in one process, on that one
device: a hop hands a position's payload to the next position of its
``data`` ring, each ``model`` shard of a leaf runs a ring of its own,
and the ``pod`` stage sums the pods' rings.  ``make_production_mesh``
is the reference's production layout (16 x 16 or 2 x 16 x 16 positions),
on the meta device: the dry-run's mesh (``launch.dryrun``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class HostMesh:
    """The axes ``("pod", "data", "model")`` (``("data", "model")`` when
    ``pod`` is None) of the given sizes, every position on ``device``
    (``None``: wherever the reduced tensors lie)."""

    data: int = 1
    device: Optional[torch.device] = None
    model: int = field(default=1, kw_only=True)
    pod: Optional[int] = field(default=None, kw_only=True)

    def __post_init__(self):
        for name, size in (("data", self.data), ("model", self.model),
                           ("pod", 1 if self.pod is None else self.pod)):
            if size < 1:
                raise ValueError(f"{name} axis size must be >= 1, got {size}")
        if self.device is not None:
            object.__setattr__(self, "device", torch.device(self.device))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The reference's axis names, in mesh order."""
        return (("data", "model") if self.pod is None
                else ("pod", "data", "model"))

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}`` in mesh order (jax's ``Mesh.shape``)."""
        sizes = {"pod": self.pod, "data": self.data, "model": self.model}
        return {a: sizes[a] for a in self.axis_names}

    @property
    def pods(self) -> int:
        """The size of the ``pod`` axis (1 when the mesh has none)."""
        return 1 if self.pod is None else self.pod

    def holds(self, t: torch.Tensor) -> bool:
        """Whether ``t`` lies on the mesh's device (a device without an
        index, such as ``cuda``, holds every device of its type)."""
        d = self.device
        return d is None or (t.device.type == d.type and
                             d.index in (None, t.device.index))


def make_host_mesh(device) -> HostMesh:
    """Whatever this host has: one position per CUDA device, or one on
    the CPU."""
    device = torch.device(device)
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    return HostMesh(data=n, device=device)


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """16 x 16 = 256 positions ("data", "model"); ``multi_pod`` prepends a
    2-way "pod" axis (512 positions).  Every position is on the meta
    device: the dry-run traces shapes and runs nothing."""
    return HostMesh(data=16, device="meta", model=16,
                    pod=2 if multi_pod else None)


def n_workers(mesh: HostMesh) -> int:
    """DCGD worker count = the product of the worker axes, pod x data."""
    return mesh.pods * mesh.data
