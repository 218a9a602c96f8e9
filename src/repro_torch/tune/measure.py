"""Calibration: the alpha-beta link model and device compute rates -- the
port of the reference's ``repro/tune/measure.py``.

The tuner's comm predictions run on a classic alpha-beta cost model
(latency + inverse-bandwidth, Hockney): one collective launch over a
payload of B bytes costs ``alpha + B * beta`` per hop.  Rather than
quoting datasheet numbers, ``calibrate_link`` FITS alpha and beta from
timed micro-reduces of the REAL leaf shapes on the REAL mesh: a dense
reduce of the smallest leaf (latency-dominated) and of the whole capped
tree (bandwidth-dominated) give (bytes, seconds) points; more subsets
give an overdetermined least-squares fit.  On a ``HostMesh`` every
position lives on one device, so the numbers characterize that device's
reduction, not a network link: the model's STRUCTURE (rank by payload +
launch count) is what transfers.

``calibrate_rates`` times an f32 matmul (TF32 off, as the port runs)
and a big elementwise pass for the flop/s and memory bytes/s the
compute half of the predictor divides by.  ``LinkModel.nominal()`` /
``DeviceRates.nominal()`` are an NVIDIA H100's published numbers for
paths where nothing is timed.

Every timed call goes through ``time_fn``, which synchronises the
device before each clock read and after each call: PyTorch returns once
a call's kernels are queued, so without it every measured rate on the
card would be a launch rate (the counterpart of the reference's
``block_until_ready``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

#: cap on the worker-stacked bytes any single timed micro-reduce moves —
#: calibration must stay micro (a 151k-vocab embedding stacked over 8
#: workers is not a micro-reduce)
DEFAULT_MEASURE_BYTES_CAP = 64 << 20


@dataclass(frozen=True)
class LinkModel:
    """alpha (s per collective launch/hop) + beta (s per byte per hop)."""

    alpha_s: float
    beta_s_per_byte: float

    @classmethod
    def nominal(cls) -> "LinkModel":
        # NVIDIA H100 SXM: ~10 us a collective launch, NVLink 4 at
        # 450 GB/s a direction (900 GB/s both ways, data sheet)
        return cls(alpha_s=1e-5, beta_s_per_byte=1.0 / 450e9)


@dataclass(frozen=True)
class DeviceRates:
    flops_per_s: float
    hbm_bytes_per_s: float

    @classmethod
    def nominal(cls) -> "DeviceRates":
        # NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, HBM3 at
        # 3.35 TB/s
        return cls(flops_per_s=989e12, hbm_bytes_per_s=3.35e12)


def _sync() -> None:
    """Wait for every queued kernel (a no-op before CUDA is in use)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Median wall-clock seconds of ``fn(*args)``, the device synchronised
    before each clock read and after each call (module docstring).

    ``warmup`` calls absorb first-call costs (kernel builds, allocator
    growth); the median over ``iters`` resists scheduler jitter.
    """
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(max(1, iters)):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _inner_bytes(leaf) -> int:
    """Per-worker message bytes of one worker-stacked leaf."""
    return math.prod(leaf.shape[1:]) * leaf.dtype.itemsize


def _device_of(mesh, device):
    """``device`` when given, else the mesh's device, else the CUDA
    device."""
    if device is None and mesh is not None and mesh.device is not None:
        return mesh.device
    return resolve_device(device)


def synth_wtree(seed: int, wtree_like, *, device=None) -> dict:
    """Concrete normal data matching a worker-stacked shape tree
    (``{path: anything with .shape and .dtype}``), drawn leaf by leaf
    from one generator seeded with ``seed``, on ``device`` (default: the
    CUDA device)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {k: torch.randn(tuple(leaf.shape), generator=gen, device=dev,
                           dtype=torch.float32).to(leaf.dtype)
            for k, leaf in wtree_like.items()}


def measure_subtree(wtree_like, cap_bytes: int = DEFAULT_MEASURE_BYTES_CAP):
    """The leaves a micro-reduce may move: reverse-layer order (the
    bucketer's walk) until the WORKER-STACKED byte cap — real shapes,
    bounded cost.  Always keeps at least one leaf."""
    picked, total = [], 0
    for leaf in reversed(list(wtree_like.values())):
        b = _inner_bytes(leaf) * leaf.shape[0]
        if picked and total + b > cap_bytes:
            break
        picked.append(leaf)
        total += b
    return {f"leaf{i:03d}": l for i, l in enumerate(picked)}


def calibrate_link(mesh, wtree_like, *, iters: int = 3,
                   cap_bytes: int = DEFAULT_MEASURE_BYTES_CAP,
                   seed: int = 7) -> LinkModel:
    """Fit the alpha-beta link model from timed dense micro-reduces of
    the real leaf shapes over ``mesh`` (a ``HostMesh``; see module
    docstring).

    Subsets: the single smallest leaf, the measure subtree, and (when
    distinct) the single largest leaf within the cap — up to three
    (bytes, seconds) points, least-squares fit, slope clamped >= 0.
    """
    from repro_torch.comm.channel import make_channel
    from repro_torch.comm.wire import AddressedNoise

    dev = _device_of(mesh, None)
    sub = measure_subtree(wtree_like, cap_bytes)
    leaves = sorted(sub.values(), key=_inner_bytes)
    subsets = [{"s": leaves[0]}]
    if len(leaves) > 1:
        subsets.append({"l": leaves[-1]})
    if len(sub) > 1:
        subsets.append(sub)

    ch = make_channel("dense", mesh)
    noise = AddressedNoise(seed, dev)
    points = []
    for subset in subsets:
        tree = synth_wtree(seed, subset, device=dev)
        t = time_fn(ch.reduce_mean, noise, tree, iters=iters)
        # per-worker message bytes: the alpha-beta payload unit
        points.append((float(sum(_inner_bytes(l) for l in subset.values())),
                       t))
    return fit_alpha_beta(points)


def fit_alpha_beta(points: Sequence[tuple]) -> LinkModel:
    """Least-squares ``t = alpha + bytes * beta`` over (bytes, seconds)
    points; beta clamped >= 0 (timing noise on small subsets can invert
    the slope) and alpha >= 0."""
    xs = np.array([p[0] for p in points], dtype=np.float64)
    ts = np.array([p[1] for p in points], dtype=np.float64)
    if len(points) < 2 or float(xs.max() - xs.min()) == 0.0:
        return LinkModel(alpha_s=float(ts.mean()), beta_s_per_byte=0.0)
    a = np.stack([np.ones_like(xs), xs], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(a, ts, rcond=None)
    beta = max(float(beta), 0.0)
    alpha = max(float(alpha), 0.0)
    return LinkModel(alpha_s=alpha, beta_s_per_byte=beta)


@dataclass(frozen=True)
class OverlapMeasurement:
    """A MEASURED compute/comm overlap: the fraction of comm time hidden
    under concurrent compute, derived from three timed phases (compute
    alone, comm alone, both issued together).  ``source`` distinguishes
    this from the nominal ``OVERLAP_HIDE`` constant in records/plans."""

    hide_fraction: float
    compute_s: float
    comm_s: float
    overlapped_s: float
    source: str = "measured"


def measure_overlap_hide(mesh, wtree_like, *, mode: str = "dense",
                         bucket_bytes: int = 1 << 16,
                         cap_bytes: int = DEFAULT_MEASURE_BYTES_CAP,
                         iters: int = 3, n_compute: int = 384,
                         seed: int = 11) -> OverlapMeasurement:
    """Measure the overlap hide fraction on THIS mesh with the REAL
    overlap runtime, replacing the nominal ``OVERLAP_HIDE`` constant.

    Times three phases over the capped measure subtree, using the same
    ``AsyncChannel.reduce_start``/``finish`` handles the trainer
    schedules (an obs ``StampRecorder`` is attached, so the probe reads
    the exact call windows the runtime stamps):

      1. compute alone (a chained f32 matmul standing in for backward
         work),
      2. the bucketed reduction alone (start + finish, drained),
      3. both: ``reduce_start`` issued FIRST, compute next, ``finish``
         last — the trainer's interleave.

    ``hide = (t_compute + t_comm - t_both) / t_comm`` clamped to [0, 1]:
    1 means comm fully disappeared under compute, 0 means full
    serialization.  On a CUDA device the buckets reduce on the
    channel's side stream, so the card can run them beside the matmuls;
    on the CPU nothing runs beside anything and the answer is ~0.
    ``mode="dense"`` by default: the probe measures SCHEDULING, not
    codec cost.
    """
    from repro_torch.comm.overlap import AsyncChannel
    from repro_torch.comm.wire import AddressedNoise
    from repro_torch.obs.trace import StampRecorder

    dev = _device_of(mesh, None)
    sub = measure_subtree(wtree_like, cap_bytes)
    tree = synth_wtree(seed, sub, device=dev)
    noise = AddressedNoise(seed, dev)
    ch = AsyncChannel(mode=mode, mesh=mesh, bucket_bytes=bucket_bytes,
                      obs=StampRecorder())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    a = torch.randn((n_compute, n_compute), generator=gen, device=dev,
                    dtype=torch.float32)

    def compute(x):
        return (x @ x) @ x

    def comm_only():
        return ch.finish(ch.reduce_start(noise, tree))

    def both():
        inflight = ch.reduce_start(noise, tree)
        out = compute(a)
        return out, ch.finish(inflight)

    t_compute = time_fn(compute, a, iters=iters)
    t_comm = time_fn(comm_only, iters=iters)
    t_both = time_fn(both, iters=iters)
    denom = max(t_comm, 1e-12)
    hide = (t_compute + t_comm - t_both) / denom
    return OverlapMeasurement(
        hide_fraction=float(min(1.0, max(0.0, hide))),
        compute_s=float(t_compute),
        comm_s=float(t_comm),
        overlapped_s=float(t_both),
    )


@dataclass(frozen=True)
class OmegaMeasurement:
    """A MEASURED compressor variance: ``omega_hat`` realized on synthetic
    traffic with the real leaf shapes, plus the global NMSE (defined for
    biased codecs too).  ``source`` distinguishes this from the analytic
    ``codec.omega(d)`` certificate in plans/records."""

    omega_hat: float
    nmse: float
    n_leaves: int
    d_total: int
    source: str = "measured"


def measure_omega(codec, wtree_like, *, mesh=None,
                  cap_bytes: int = DEFAULT_MEASURE_BYTES_CAP,
                  iters: int = 3, seed: int = 13,
                  device=None) -> OmegaMeasurement:
    """Measure ``omega_hat = E||Q(v)-v||^2 / ||v||^2`` on THIS codec over
    the real (capped) leaf shapes, replacing the analytic estimate the
    EF-BV ``eta``/``nu`` derivation otherwise trusts.

    Draws ``iters`` independent normal trees (the synthetic stand-in for
    gradient traffic) and averages the ``obs.quality`` distortion pass
    through the codec's real encode path (on the card, the q8 codec's
    kernels); the d-weighting matches the tuner's analytic mean so
    measured and analytic are directly comparable.
    """
    from repro_torch.comm.wire import AddressedNoise
    from repro_torch.obs.quality import tree_distortion

    dev = _device_of(mesh, device)
    sub = measure_subtree(wtree_like, cap_bytes)
    d_total = sum(max(1, math.prod(l.shape[1:])) for l in sub.values())
    omega_acc = 0.0
    nmse_acc = 0.0
    n = max(1, iters)
    for i in range(n):
        tree = synth_wtree(seed + i, sub, device=dev)
        out = tree_distortion(codec, AddressedNoise(seed, dev, round=1000 + i),
                              tree)
        omega_acc += float(out["omega_hat"])
        nmse_acc += float(out["nmse"])
    return OmegaMeasurement(
        omega_hat=omega_acc / n,
        nmse=nmse_acc / n,
        n_leaves=len(sub),
        d_total=int(d_total),
    )


def calibrate_rates(*, n: int = 512, iters: int = 3,
                    device=None) -> DeviceRates:
    """Device compute/memory rates from a timed f32 matmul (TF32 off for
    the call) and a timed elementwise pass (modest sizes — calibration
    must not dwarf the search it serves)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    a = torch.randn((n, n), generator=gen, device=dev, dtype=torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t_mm = time_fn(torch.matmul, a, a, iters=iters)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    flops = 2.0 * n**3 / max(t_mm, 1e-9)

    big = torch.randn((4 << 20,), generator=gen, device=dev,
                      dtype=torch.float32)
    t_add = time_fn(torch.add, big, 1.0, iters=iters)
    bps = 2.0 * big.numel() * 4 / max(t_add, 1e-9)  # read + write
    return DeviceRates(flops_per_s=float(flops), hbm_bytes_per_s=float(bps))
