"""The worker mesh -- the port of the reference's ``repro/launch/mesh.py``
for one host.

The reference's DCGD workers are the positions of its mesh's ``data``
axis, one per device, and its CPU tests emulate devices with
``--xla_force_host_platform_device_count``.  The port's counterpart is a
``HostMesh``: the size of the ``data`` axis and the device its positions
live on.  The ring collectives (``dist.collectives``) run every position
of that axis in one process, on that one device, and a hop hands a
position's payload to the next position.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class HostMesh:
    """A ``data`` axis of ``data`` positions, all on ``device`` (``None``:
    wherever the reduced tensors lie)."""

    data: int = 1
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.data < 1:
            raise ValueError(f"data axis size must be >= 1, got {self.data}")
        if self.device is not None:
            object.__setattr__(self, "device", torch.device(self.device))

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


def n_workers(mesh: HostMesh) -> int:
    """DCGD worker count = the size of the ``data`` axis (the reference's
    product of data-like axes; a host mesh has no ``pod`` axis)."""
    return mesh.data
