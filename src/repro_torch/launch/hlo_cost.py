"""The step's cost pass -- the port of the reference's
``repro/launch/hlo_cost.py``, with the same name and the same output keys.

The reference walks the optimized HLO text of a jitted step and
multiplies through its ``while`` loops.  The port has no HLO: it runs the
step itself, eagerly, on the META device under a ``TorchDispatchMode``
that sees every ATen op the step dispatches, forward and backward, and
charges each as the reference charges its HLO counterpart:

  flops            ``2 * numel(out) * K`` per matmul-family op (``mm``,
                   ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``; what
                   ``einsum`` and ``matmul`` decompose into), as the
                   reference counts a ``dot``; 1 per output element for
                   the elementwise ops the reference charges (add,
                   subtract, multiply, divide, maximum, minimum,
                   compares, select, and/or/xor, negate, abs, floor,
                   ceil, clamp, convert, expm1)
  transcendentals  1 per output element of exp, tanh, log, rsqrt, sqrt,
                   pow, sigmoid, sin, cos (the reference's list)
  bytes            operands + result of every op that moves data (views
                   move none).  Eager PyTorch runs unfused, so this is the
                   port's honest count, and it is LARGER than the
                   reference's, whose fusions keep intermediates out of
                   memory.

Meta tensors hold shapes only: nothing is allocated and nothing is
computed, so a full-size step of a 32B model costs seconds.  A host read
(``.item()``, ``float()``) fails on meta; ``analyze`` lets that error
propagate, and its callers record it.  Where the step calls a hand-written
kernel (WKV6, the q8 codec) its wrapper runs the plain version on meta,
the same arithmetic.

Loops: the port's layer walk is Python, so every layer is counted, and
``while_trips`` / ``unresolved_whiles`` are always empty.  Two loops whose
bodies are identical by construction are traced once and charged their
trip count (``repeated``): the workers of ``dist.worker_grads`` (W
identical forward/backward passes; they take turns on the one card, so
the count covers all of them, where the reference's per-device SPMD
program holds one device's share) and the steps of the WKV6 plain
recurrence; ``repeated_loops`` records each with its trips.

Collectives: the port's collectives are in-process copies and kernel
launches, not ops a dispatch mode can tell apart, so
``collective_bytes_by_kind`` comes from the channel's structural
accounting of one round over the mesh (``round_collective_bytes``), in
the reference's per-device convention: what ONE mesh position's program
moves, under the collective kind the reference's round lowers to.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: matmul-family ops: flops 2 * numel(out) * K, K the last dim of the
#: left operand
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "vdot"}

#: elementwise ops the reference charges 1 flop per output element
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "fmax",
    "fmin", "eq", "ne", "lt", "le", "gt", "ge", "where", "masked_fill",
    "bitwise_and", "bitwise_or", "bitwise_xor", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_not", "neg",
    "abs", "floor", "ceil", "clamp", "clamp_min", "clamp_max", "expm1",
    "sign", "round", "trunc",
}

#: the reference's transcendentals (exponential, tanh, log, rsqrt, sqrt,
#: power, logistic, sine, cosine)
_TRANSCENDENTAL = {"exp", "tanh", "log", "rsqrt", "sqrt", "pow", "sigmoid",
                   "sin", "cos"}

#: ops that move no data (views, aliases, allocation without a write)
_NO_DATA = {
    "view", "_unsafe_view", "reshape", "alias", "t", "transpose",
    "permute", "expand", "slice", "select", "unsqueeze", "squeeze",
    "detach", "as_strided", "unbind", "split", "split_with_sizes",
    "chunk", "narrow", "view_as", "lift_fresh", "diagonal", "unfold",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_reshape_alias", "view_as_real",
    "view_as_complex", "_local_scalar_dense", "resize_",
}

def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _base(name: str) -> str:
    """``aten.add_`` -> ``add``; ``aten.mul.out`` was already split."""
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


class CostMode(TorchDispatchMode):
    """Charges every dispatched ATen op (module docstring); ``mult`` is the
    trip count of the ``repeated`` loops the op runs inside."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.mult = 1
        self.ops: Dict[str, List[float]] = {}
        self.repeated_loops: Dict[str, int] = {}

    def _charge(self, name, func, args, kwargs, out) -> None:
        base = _base(name)
        outs = _tensors(out)
        flops = trans = 0.0
        if base in _MATMUL:
            a = args[1] if base in ("addmm", "baddbmm", "addmv") else args[0]
            k = a.shape[-1]
            flops = 2.0 * sum(o.numel() for o in outs) * k
        elif base in _ELEMENTWISE:
            flops = float(sum(o.numel() for o in outs))
        elif base == "_to_copy":
            src = args[0]
            if outs and outs[0].dtype != src.dtype:   # a convert
                flops = float(outs[0].numel())
        elif base in _TRANSCENDENTAL:
            trans = float(sum(o.numel() for o in outs))
        nb = 0.0
        if base not in _NO_DATA and not getattr(func, "is_view", False):
            nb = float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                       + sum(_nbytes(t) for t in outs))
        m = self.mult
        self.flops += m * flops
        self.transcendentals += m * trans
        self.bytes += m * nb
        row = self.ops.setdefault(name, [0, 0.0, 0.0, 0.0])
        row[0] += m
        row[1] += m * flops
        row[2] += m * nb
        row[3] += m * trans

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._charge(func.overloadpacket.__name__, func, args, kwargs, out)
        return out


#: the passes running (``analyze`` pushes and pops its own), innermost
#: last: how ``repeated`` finds the one to charge
_ACTIVE: List[CostMode] = []


@contextlib.contextmanager
def repeated(n: int, name: str = "loop"):
    """Charge the ops run inside ``n`` times: the body of a loop whose
    ``n`` trips dispatch identical ops (shapes only, on meta), traced
    once.  A no-op when no cost pass is running."""
    if not _ACTIVE:
        yield
        return
    mode = _ACTIVE[-1]
    mode.repeated_loops[name] = int(n)
    mode.mult *= int(n)
    try:
        yield
    finally:
        mode.mult //= int(n)


def tracing(t: torch.Tensor) -> bool:
    """Whether a cost pass is running over the meta tensor ``t``: a loop
    over identical bodies may then trace one body under ``repeated``."""
    return bool(_ACTIVE) and t.device.type == "meta"


def apply_gradient_payload_model(corrected: Dict[str, object], kind: str,
                                 message_bytes: float,
                                 wire_fraction: float) -> Dict[str, object]:
    """Re-charge the GRADIENT-AGGREGATION share of one collective kind at
    the codec's wire fraction, leaving the rest structural (the
    reference's).

    For comm modes whose aggregation is a dense collective while the
    protocol payload is compressed (EF21: an exact mean of DECODED sparse
    messages), only the gradient-message bytes -- one per-device
    param-tree share, ``message_bytes`` -- ride the compressed uplink.
    """
    coll = dict(corrected["collective_bytes_by_kind"])
    total = float(coll.get(kind, 0.0))
    grad = min(float(message_bytes), total)
    coll[kind] = (total - grad) + grad * wire_fraction
    out = dict(corrected)
    out["collective_bytes_by_kind"] = coll
    out["collective_bytes"] = sum(coll.values())
    out["payload_model"] = {
        "kind": kind,
        "gradient_message_bytes": grad,
        "wire_fraction": wire_fraction,
    }
    return out


def _shard_numel(key, leaf, mesh, wspecs) -> int:
    """Elements of one position's share of a worker-stacked leaf: the
    inner dims, divided over ``model`` where ``wspecs`` shard one."""
    from repro_torch.dist.collectives import _model_dim

    d = math.prod(leaf.shape[1:])
    if wspecs is not None and mesh is not None:
        if _model_dim(wspecs[key], mesh, key) is not None:
            d //= mesh.model
    return d


def round_collective_bytes(mode_or_cfg, wtree_like, mesh, *,
                           randk_q: float = 0.05,
                           q8_block_rows: Optional[int] = None,
                           wspecs=None,
                           counts: Optional[Dict[str, int]] = None
                           ) -> Dict[str, float]:
    """``{collective kind: bytes}`` of one aggregation round of the
    worker-stacked tree ``wtree_like`` (``{path: (W, ...) leaf-like}``)
    over ``mesh`` (a ``HostMesh``), in the aggregation format of
    ``mode_or_cfg`` (a comm mode or a ``CompressionConfig``, whose
    ``randk_q`` and ``q8_block_rows`` then apply), as the reference's
    round lowers it on a mesh of as many devices, per device:

      dense          one ``all-reduce`` of each leaf's share, in f32 (the
                     reference's mean reduces in f32 for bf16 leaves too)
      randk_shared   one ``all-gather`` of the W workers' K kept values
                     of each leaf's share, f32 (XLA gathers the payloads
                     and averages them locally)
      q8_ring(_fused)  ``collective-permute`` of each ring hop's payload:
                     2 (n - 1) hops of the int8 chunk and its scales
                     (``Int8Stochastic``: a (1, ceil(d/n)) chunk and one
                     f32 scale; the fused codec: ``ring_chunk_layout``'s
                     (rows, 128) int8 block and one f32 scale a tile);
                     with more than one pod, an ``all-reduce`` of the
                     decoded f32 share (the pod stage's psum)

    A leaf's share is its inner dims divided over ``model`` where
    ``wspecs`` (``dist.sharding.worker_stacked_pspecs``) shard one, else
    the whole leaf.  A mesh with one worker position moves nothing.
    ``counts``, when given, receives the collectives issued by kind: one
    a leaf, and one a payload part (int8 block, scales) a hop.
    """
    from repro_torch.comm.channel import aggregation_mode_of
    from repro_torch.core.compressors import Int8Stochastic, ShapeDtype
    from repro_torch.kernels.q8ring.ops import (
        DEFAULT_BLOCK_ROWS,
        LANE,
        ring_chunk_layout,
    )

    if hasattr(mode_or_cfg, "comm_mode"):
        randk_q = mode_or_cfg.randk_q
        q8_block_rows = mode_or_cfg.q8_block_rows
    mode = aggregation_mode_of(mode_or_cfg)
    n = 1 if mesh is None else mesh.data
    pods = 1 if mesh is None else mesh.pods
    out: Dict[str, float] = {}
    if n * pods == 1:
        return out

    def add(kind, b, n=1):
        out[kind] = out.get(kind, 0.0) + float(b)
        if counts is not None:
            counts[kind] = counts.get(kind, 0) + n

    meta = torch.device("meta")
    for key, leaf in wtree_like.items():
        w = leaf.shape[0]
        if mode == "dense":
            add("all-reduce", 4 * _shard_numel(key, leaf, mesh, wspecs))
        elif mode == "randk_shared":
            d = math.prod(leaf.shape[1:])
            k = max(1, int(round(randk_q * d)))
            add("all-gather",
                4 * w * k * _shard_numel(key, leaf, mesh, wspecs) / d)
        elif mode in ("q8_ring", "q8_ring_fused"):
            d = _shard_numel(key, leaf, mesh, wspecs)
            if n > 1:
                if mode == "q8_ring":
                    c = -(-d // n)
                    payload = Int8Stochastic().payload_like(
                        ShapeDtype((1, c), torch.float32, meta))
                    parts = _tensors(payload)
                    hop = sum(_nbytes(t) for t in parts)
                else:
                    rows_c, block = ring_chunk_layout(
                        d, n, q8_block_rows or DEFAULT_BLOCK_ROWS)
                    parts, hop = 2, rows_c * LANE + 4 * (rows_c // block)
                add("collective-permute", 2 * (n - 1) * hop,
                    2 * (n - 1) * (parts if isinstance(parts, int)
                                   else len(parts)))
            if pods > 1:
                add("all-reduce", 4 * d)
        else:
            raise ValueError(f"no collective accounting for {mode!r}")
    return out


def analyze(fn, *args, collectives: Optional[Dict[str, float]] = None,
            collective_scale: Optional[Dict[str, float]] = None,
            table: Optional[dict] = None, **kwargs) -> Dict[str, object]:
    """Cost of ``fn(*args, **kwargs)`` run on meta tensors (module
    docstring), with the reference's keys.

    ``collectives`` is the round's ``{kind: bytes}``
    (``round_collective_bytes``); ``collective_scale`` applies a payload
    model uniformly to a whole kind (prefer
    ``apply_gradient_payload_model`` when the kind also carries dense
    traffic).  ``table``, when given, receives the per-op rows
    ``{op: {"count", "flops", "bytes", "transcendentals"}}``.
    """
    mode = CostMode()
    _ACTIVE.append(mode)
    try:
        with mode:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    structural = dict(collectives or {})
    coll = dict(structural)
    for kind, scale in (collective_scale or {}).items():
        if kind in coll:
            coll[kind] *= scale
    if table is not None:
        table.update({op: {"count": r[0], "flops": r[1], "bytes": r[2],
                           "transcendentals": r[3]}
                      for op, r in sorted(mode.ops.items())})
    return {
        "flops": mode.flops,
        "bytes": mode.bytes,
        "transcendentals": mode.transcendentals,
        "collective_bytes_by_kind": coll,
        "collective_bytes": sum(coll.values()),
        "collective_bytes_structural": sum(structural.values()),
        "collective_scale": dict(collective_scale or {}),
        "while_trips": {},
        "unresolved_whiles": [],
        "repeated_loops": dict(mode.repeated_loops),
    }
