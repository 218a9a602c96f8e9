"""The q8 kernels' launches in one training step, and each launch's bound.

A step of a cell whose messages use the blockwise int8 codec
(``q8_block``) encodes and decodes every leaf once a worker
(``q8_quantize_2d``, then ``q8_dequant_add_2d`` without an accumulator);
a ring aggregation over n positions adds, per leaf, n x n chunk
quantizes (``q8_quantize_chunk_3d``: n - 1 reduce-scatter hops and the
all-gather's one encode at each position), n x (n - 1) accumulating
dequants and n plain ones.  The layouts follow the codec's tile rule:
rows of 128 lanes, a tile of min(64, rows) rows, rows padded to whole
tiles.

A launch's bound is the larger of its bytes over the card's memory
bandwidth and its f32 operations over the card's f32 rate, each input
byte read once and each output byte written once.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Tuple

from perfbench.counts import peaks

LANE = 128
BLOCK_ROWS = 64

#: kernel names as the profiler shows them -> the wrapper that launches
KERNELS = {"q8_quantize_kernel": "q8_quantize_2d",
           "q8_quantize_chunk_kernel": "q8_quantize_chunk_3d",
           "q8_dequant_add_kernel": "q8_dequant_add_2d"}


def function_name(kernel: str) -> str:
    """A kernel's bare function name, as the profiler may show it with its
    namespace and parameters: ``(anonymous namespace)::f(float4 const*)``
    -> ``f``."""
    head = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    return head.split("::")[-1].strip()


def tile_rows(rows: int, block_rows: int = BLOCK_ROWS) -> Tuple[int, int]:
    """(rows padded to whole tiles, tile rows)."""
    block = min(block_rows, rows)
    return -(-rows // block) * block, block


def message_layout(d: int, block_rows: int = BLOCK_ROWS) -> Tuple[int, int]:
    """(rows_pad, block) of a d-element message."""
    return tile_rows(max(1, -(-d // LANE)), block_rows)


def ring_layout(d: int, n: int, block_rows: int = BLOCK_ROWS) -> Tuple[int, int]:
    """(rows_c, block) of one of the n ring chunks of a d-element leaf."""
    return tile_rows(-(-max(1, -(-d // LANE)) // n), block_rows)


def bound_ms(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / peaks.HBM_BYTES_PER_S, n_ops / peaks.F32_FLOPS_PER_S) * 1e3


def quantize_bound(rows: int, block: int) -> float:
    """x and u read (f32), q (int8) and one f32 scale a tile written;
    abs, max, divide, floor, subtract, compare, add an element."""
    n, nb = rows * LANE, rows // block
    return bound_ms(9 * n + 4 * nb, 7 * n)


def chunk_quantize_bound(rows: int, block: int) -> float:
    """``quantize_bound`` and the chunk id read."""
    n, nb = rows * LANE, rows // block
    return bound_ms(9 * n + 4 * nb + 4, 7 * n)


def dequant_bound(rows: int, block: int, acc: bool) -> float:
    """q and the scales read, f32 out written (one multiply); with an
    accumulator, it read too (one fma)."""
    n, nb = rows * LANE, rows // block
    if acc:
        return bound_ms(9 * n + 4 * nb, 2 * n)
    return bound_ms(5 * n + 4 * nb, n)


def step_launches(leaf_sizes: Iterable[int], workers: int, ring: int,
                  q8_messages: bool) -> List[Tuple[str, float]]:
    """Every q8 launch of one step as ``(wrapper, bound ms)``: ``ring``
    positions of the aggregation (0: no ring)."""
    out = []
    for d in leaf_sizes:
        if q8_messages:
            rows, block = message_layout(d)
            out += [("q8_quantize_2d", quantize_bound(rows, block)),
                    ("q8_dequant_add_2d", dequant_bound(rows, block, False))
                    ] * workers
        if ring:
            rows, block = ring_layout(d, ring)
            n = ring
            out += [("q8_quantize_chunk_3d",
                     chunk_quantize_bound(rows, block))] * (n * n)
            out += [("q8_dequant_add_2d",
                     dequant_bound(rows, block, True))] * (n * (n - 1))
            out += [("q8_dequant_add_2d",
                     dequant_bound(rows, block, False))] * n
    return out


def launch_counts(launches: List[Tuple[str, float]]) -> Dict[str, int]:
    return dict(Counter(name for name, _ in launches))
