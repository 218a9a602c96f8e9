"""PyTorch/CUDA port of the shifted-compression training system.

Mirrors the module layout of the JAX package ``repro`` so each module
has an obvious counterpart, and imports nothing from it (nor JAX).
Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see ``repro_torch.device``); the hand-written Hopper
kernels live under ``repro_torch.kernels``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
