"""Everything a run feeds the program, made from ``--seed``: the initial
parameters, the token batches and the draws the codecs and the wires
consume.  The same functions feed the plain reference, so both sides
see the same inputs.

Every random stream is a ``torch.Generator`` on the run's device,
seeded from a splitmix64 chain over ``(seed, purpose, index ...)``, so
a seed of any size (past 32 bits too) gives the same inputs
on the same device in any order of the calls.
"""

from __future__ import annotations

import zlib
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _word(v) -> int:
    if v is None:
        return _MASK64
    if isinstance(v, str):
        return zlib.crc32(v.encode())
    return int(v) & _MASK64


def mix(*fields) -> int:
    """A 64-bit seed from an address of ints, strings and Nones."""
    h = 0
    for v in fields:
        h = _splitmix64(h ^ _word(v))
    return h


def generator(device, *fields) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(mix(*fields))
    return gen


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def make_params(specs: Sequence[Tuple[str, Tuple[int, ...], object]], seed: int,
                device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The initial parameters of ``specs`` (``(path, shape, init)``, init
    a normal std, ``("full", value)`` or ``("log_linspace", lo, hi)``,
    ``log(linspace(lo, hi, n))`` over the leaf's last axis of n, the
    same in every row): the normal leaves cut from ONE draw of standard
    normals on ``device`` and scaled by their std, each leaf a tensor of
    its own."""
    normal = [(p, s, float(i)) for p, s, i in specs if not isinstance(i, tuple)]
    total = sum(_numel(s) for _, s, _ in normal)
    flat = torch.randn(total, generator=generator(device, seed, "params"),
                       dtype=torch.float32, device=device)
    out, off = {}, 0
    for path, shape, init in specs:
        if isinstance(init, tuple):
            out[path] = _fixed(path, shape, init, dtype, device)
            continue
        n = _numel(shape)
        out[path] = (flat[off:off + n].view(shape) * float(init)).to(dtype)
        off += n
    del flat
    return out


def _fixed(path: str, shape, init: tuple, dtype, device) -> torch.Tensor:
    if init[0] == "full" and len(init) == 2:
        return torch.full(shape, float(init[1]), dtype=dtype, device=device)
    if init[0] == "log_linspace" and len(init) == 3:
        row = torch.log(torch.linspace(float(init[1]), float(init[2]),
                                       shape[-1], dtype=torch.float32,
                                       device=device))
        return row.to(dtype).expand(shape).contiguous()
    raise ValueError(f"{path}: unknown init {init!r}")


def _numel(shape: Iterable[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


# --------------------------------------------------------------------------
# Tokens
# --------------------------------------------------------------------------


def batch(seed: int, step: int, global_batch: int, seq: int, vocab: int,
          device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: uniform token ids in ``[0, vocab)``, int64,
    drawn on ``device``."""
    gen = generator(device, seed, "tokens", step)
    return {"tokens": torch.randint(0, vocab, (global_batch, seq),
                                    generator=gen, device=device)}


# --------------------------------------------------------------------------
# Draws
# --------------------------------------------------------------------------

#: the kinds of draw, one address space each
UNIFORM, RING, SEND = 0, 3, 6


class SeedDraws:
    """The round's uniforms, made by the benchmark: every draw addressed by
    ``(seed, [wire,] round, kind, fields)``, so the same address gives the
    same bits whatever order the program asks in.  It answers what the
    cells' training steps ask of their state's noise source (``uniform``
    for the messages, ``ring_uniform`` for the ring's hops,
    ``stream``/``at_round``/``send_uniform`` for the moe and act wires,
    ``next_round``), and the reference asks it for the same addresses.
    A codec or aggregation that draws otherwise (Rand-K's permutations,
    the pod stage) needs its kind of draw added here."""

    def __init__(self, seed: int, device, wire: Optional[int] = None,
                 round: int = 0):
        self.seed, self.wire, self.round = int(seed), wire, int(round)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)

    def stream(self, name: str) -> "SeedDraws":
        return SeedDraws(self.seed, self.device,
                         zlib.crc32(name.encode()) & 0x7FFFFFFF)

    def at_round(self, r: int) -> "SeedDraws":
        return SeedDraws(self.seed, self.device, self.wire, r)

    def _at(self, kind: int, *fields) -> torch.Generator:
        head = (self.seed,) if self.wire is None else (self.seed, self.wire)
        self.generator.manual_seed(mix(*head, self.round, kind, *fields))
        return self.generator

    def _rand(self, gen, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=gen, device=self.device,
                          dtype=torch.float32)

    def uniform(self, leaf, worker, shape, part=None):
        return self._rand(self._at(UNIFORM, leaf, worker, part), shape)

    def ring_uniform(self, leaf, hop, shape):
        return self._rand(self._at(RING, leaf, hop, None), shape)

    def send_uniform(self, address, shape):
        return self._rand(self._at(SEND, *address), shape)

    def next_round(self) -> None:
        self.round += 1


def draws_seed(seed: int) -> int:
    """The seed of a run's draws (apart from its params' and tokens')."""
    return mix(seed, "draws")
