"""Per-worker encode plumbing and the round's noise source.

The reference derives every random bit of a round from one PRNG key:
``leaf_key`` folds the leaf's global tree position into it and
``worker_keys`` splits that per worker.  Stochastic codecs here take
precomputed uniforms instead (the kernels do), so the port draws them
from one noise source, in a fixed order:

1. the messages: ``uniform(leaf, worker, shape)``, leaf order first (the
   global leaf position in the tree), then worker;
2. then, when the round aggregates through a ring
   (``dist.collectives``), the ring's encodes: ``ring_uniform(leaf, hop,
   shape)``, leaf order first, then hop -- hops ``0 .. n-2`` are the
   reduce-scatter's, hop ``n-1`` is the all-gather's one encode.  Every
   ring position uses the same draw at a given hop: the reference's ring
   key enters its ``shard_map`` replicated.

``GeneratorNoise`` is the default source: a ``torch.Generator`` on the
run's device, seeded from the run seed.  Any object with the same two
methods can stand in for it -- the parity tests replay the uniforms the
reference draws along its own key chain, which is how the port's round
is held bit for bit against the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

import torch

from repro_torch.core.compressors import ShapeDtype


class GeneratorNoise:
    """Uniform draws from a ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def uniform(self, leaf: int, worker: int, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1) for ``worker``'s encode of leaf
        ``leaf``; successive calls continue one stream, so the draws
        depend on the order of the calls, which the round fixes."""
        return torch.rand(shape, generator=self.generator, device=self.device,
                          dtype=torch.float32)

    def ring_uniform(self, leaf: int, hop: int, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1) for ring hop ``hop`` of leaf ``leaf``,
        shared by every ring position; the same stream as ``uniform``."""
        return self.uniform(leaf, hop, shape)


@dataclass(frozen=True)
class LeafNoise:
    """THE per-leaf noise derivation of the wire layer (the port of
    ``leaf_key``): the noise source bound to one leaf's GLOBAL position
    in the tree."""

    source: Any
    leaf: int

    def worker(self, j: int):
        """The ``rand(shape)`` draw function of worker ``j``."""
        return lambda shape: self.source.uniform(self.leaf, j, shape)


def encode_decode_workers(codec, noise: LeafNoise, leaf: torch.Tensor
                          ) -> Tuple[List[Any], torch.Tensor]:
    """One uplink leaf: encode then decode each worker row of a
    worker-stacked ``(W, ...)`` leaf.

    Returns ``(per-worker payloads, decoded (W, ...) messages)``.  The
    reference vmaps the codec over the worker axis; here the workers run
    one after another and write into one stacked output.
    """
    like = ShapeDtype(tuple(leaf.shape[1:]), leaf.dtype, leaf.device)
    out = torch.empty_like(leaf)
    payloads = []
    for j in range(leaf.shape[0]):
        payload, meta = codec.encode(noise.worker(j), leaf[j])
        out[j] = codec.decode(payload, meta, like)
        payloads.append(payload)
    return payloads, out


def encode_meta_free(codec, rand, block: torch.Tensor):
    """Encode for forwarded-payload transports (ring hops): the decoder
    sees ONLY the payload, so a codec that needs side information in
    ``meta`` is rejected."""
    payload, meta = codec.encode(rand, block)
    if meta:
        raise ValueError(
            f"{type(codec).__name__} carries decoder state in meta; "
            "quantized ring stages forward payloads only (meta must be "
            "empty)"
        )
    return payload
