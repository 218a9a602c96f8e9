"""Simulation runs: run a method of the framework on a convex
``Problem`` and record its (relative error, cumulative bits) trace, the
port of the reference's ``repro/core/simulate.py``.

The iterate is a one-leaf tree keyed ``X`` (``"x"``): the method sees
``{"x": (W, d)}`` worker gradients and ``{"x": (d,)}`` params.  The loop
is a Python loop (the reference's is one ``lax.scan``); each step's
error and bit count are written into tensors on the problem's device
and read back once, at the end, so the loop never waits for the device.
On the CPU the loop flushes subnormal floats to zero, as XLA's CPU
runtime does for the reference (a converged run's messages are
subnormal, and x86 computes with those two orders of magnitude
slower), and runs on one intra-op thread: a step is a few thousand
flops, and the thread pool's hand-offs cost more than they save (30x
more on a loaded host).
Communication runs through the method's channel (the parameter server
``SimChannel`` by default); the bits are the structural ``wire_bits`` of
the encoded payloads.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.algorithms import DCGDShift
from repro_torch.core.iterate_comp import GDCI, VRGDCI
from repro_torch.data.problems import Problem

#: the key of the convex iterate's one-leaf tree
X = "x"


@dataclass
class Trace:
    """Trajectory of one run."""
    name: str
    rel_err: np.ndarray   # ||x^k - x*||^2 / ||x^0 - x*||^2, per step
    bits: np.ndarray      # cumulative uplink bits, per step

    def bits_to_tol(self, tol: float) -> float:
        """Communicated bits needed to first reach rel_err <= tol."""
        idx = np.argmax(self.rel_err <= tol)
        if self.rel_err[idx] > tol:
            return float("inf")
        return float(self.bits[idx])

    def steps_to_tol(self, tol: float) -> float:
        idx = np.argmax(self.rel_err <= tol)
        if self.rel_err[idx] > tol:
            return float("inf")
        return float(idx)


def default_x0(problem: Problem, seed: int = 0) -> torch.Tensor:
    """sqrt(10) * N(0, I) from a ``torch.Generator`` seeded ``100 +
    seed`` on the problem's device.  Not the reference's draw (that is
    ``jax.random.normal``): pass ``x0`` to start where the reference
    does."""
    dev = problem.x_star.device
    gen = torch.Generator(device=dev).manual_seed(100 + seed)
    return torch.randn(problem.d, generator=gen, device=dev) * math.sqrt(10.0)


@contextlib.contextmanager
def _cpu_loop(device: torch.device):
    """On the CPU: subnormals flushed to zero and one intra-op thread for
    the block, then the settings found restored (the flush probed: a
    subnormal times one is zero under it)."""
    if device.type != "cpu":
        yield
        return
    flushed = (torch.tensor(1e-39) * torch.tensor(1.0)).item() == 0.0
    threads = torch.get_num_threads()
    torch.set_flush_denormal(True)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_flush_denormal(flushed)
        torch.set_num_threads(threads)


def _run(problem, x0, seed, steps, update):
    """The loop shared by both runners: ``update(x, wgrads) -> (x,
    cumulative bits)`` per step; returns the (rel_err, bits) arrays."""
    x = (default_x0(problem, seed) if x0 is None else x0).to(
        device=problem.x_star.device, dtype=problem.x_star.dtype)
    denom = torch.sum((x - problem.x_star) ** 2)
    errs = torch.empty(steps, dtype=x.dtype, device=x.device)
    bits = torch.empty(steps, dtype=torch.float32, device=x.device)
    with _cpu_loop(x.device):
        for k in range(steps):
            x, cum = update(x, {X: problem.worker_grads(x)})
            torch.div(torch.sum((x - problem.x_star) ** 2), denom,
                      out=errs[k])
            bits[k] = cum
    return errs.cpu().numpy(), bits.cpu().numpy()


def run_dcgd_shift(
    problem: Problem,
    method: DCGDShift,
    gamma: float,
    steps: int,
    *,
    x0: Optional[torch.Tensor] = None,
    seed: int = 0,
    use_star: bool = False,
    name: str = "dcgd-shift",
    noise: Any = None,
) -> Trace:
    """Run Algorithm 1 on ``problem`` with learning rate ``gamma``;
    ``noise`` replaces the default ``GeneratorNoise(seed)`` source."""
    star = {X: problem.star_grads()} if use_star else None
    x_like = problem.x_star if x0 is None else x0
    wlike = {X: problem.worker_grads(x_like.to(problem.x_star.dtype))}
    state = [method.init(wlike, seed=seed, star=star, noise=noise)]

    def update(x, wg):
        g, state[0] = method.estimate(state[0], wg)
        return torch.add(x, g[X], alpha=-gamma), state[0].bits

    errs, bits = _run(problem, x0, seed, steps, update)
    return Trace(name, errs, bits)


def run_gdci(
    problem: Problem,
    method: GDCI | VRGDCI,
    steps: int,
    *,
    x0: Optional[torch.Tensor] = None,
    seed: int = 0,
    name: str = "gdci",
    noise: Any = None,
) -> Trace:
    """Run GDCI or VR-GDCI (Algorithm 2) on ``problem``."""
    params = {X: problem.x_star}
    if isinstance(method, VRGDCI):
        state = [method.init_state(params, problem.n_workers, seed=seed,
                                   noise=noise)]
    else:
        state = [method.init(params, seed=seed, noise=noise)]

    def update(x, wg):
        p = {X: x.clone()}           # VR-GDCI mixes the params in place
        p, state[0] = method.update(p, state[0], wg)
        return p[X], state[0].bits

    errs, bits = _run(problem, x0, seed, steps, update)
    return Trace(name, errs, bits)
