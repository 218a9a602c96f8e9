"""Convex distributed problems of the paper's experiments (Section 4), the
port of the reference's ``repro/data/problems.py``.

Ridge regression is the paper's setup: ``make_regression``-style data
(m=100, d=80), lambda = 1/m, split evenly among n=10 workers.  Logistic
regression stands in for the w2a LibSVM experiment (Appendix C):
synthetic data, lambda set so that cond(f) ~ 100.

The data, ``x_star``, ``L``, ``L_max`` and ``mu`` are computed by the
reference's own numpy code, so they are bitwise the reference's; ``L_max``
is taken from the worker slices cast to the problem's dtype, as the
reference takes it from its f32 arrays.  The tensors live on the run's
device in ``dtype`` (f32 by default; f64 is the reference's
``jax_enable_x64``), and the oracles take and return tensors there:
``worker_grads(x)`` maps x (d,) to the (W, d) per-worker gradients.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@dataclass
class Problem:
    name: str
    d: int
    n_workers: int
    worker_grads: Callable  # x (d,) -> (W, d) stacked per-worker gradients
    full_grad: Callable     # x (d,) -> (d,)
    loss: Callable          # x (d,) -> scalar
    x_star: torch.Tensor
    L: float
    L_max: float
    mu: float

    @property
    def kappa(self) -> float:
        return self.L / self.mu

    def star_grads(self) -> torch.Tensor:
        """grad_i(x*) for all i -- the DCGD-STAR oracle."""
        return self.worker_grads(self.x_star)


def _make_regression(m: int, d: int, seed: int, noise: float = 10.0):
    """sklearn.datasets.make_regression equivalent (default params):
    standard normal A, dense ground-truth coefficients in [0,100],
    additive Gaussian noise of scale ``noise``."""
    rng = np.random.RandomState(seed)
    a = rng.randn(m, d)
    coef = rng.uniform(0.0, 100.0, size=d)
    y = a @ coef
    if noise > 0:
        y = y + rng.normal(scale=noise, size=m)
    return a.astype(np.float64), y.astype(np.float64)


def _on(a_np, dtype, dev):
    return torch.from_numpy(np.ascontiguousarray(a_np.astype(_NP_DTYPE[dtype]))
                            ).to(dev)


def make_ridge(
    m: int = 100, d: int = 80, n_workers: int = 10,
    lam: float | None = None, seed: int = 0, noise: float = 0.0,
    device=None, dtype: torch.dtype = torch.float32,
) -> Problem:
    """f(x) = (1/2)||Ax-y||^2 + (lam/2)||x||^2, rows split evenly so that
    f = (1/n) sum f_i with f_i = (n/2)||A_i x - y_i||^2 + (lam/2)||x||^2."""
    assert m % n_workers == 0
    dev = resolve_device(device)
    lam = 1.0 / m if lam is None else lam
    a_np, y_np = _make_regression(m, d, seed, noise)
    x_star_np = np.linalg.solve(a_np.T @ a_np + lam * np.eye(d), a_np.T @ y_np)

    rows = m // n_workers
    n = n_workers
    a_w_np = a_np.astype(_NP_DTYPE[dtype]).reshape(n_workers, rows, d)
    a = _on(a_np, dtype, dev)
    y = _on(y_np, dtype, dev)
    a_w = a.reshape(n_workers, rows, d)
    y_w = y.reshape(n_workers, rows)
    n_a_wt = (n * a_w).transpose(1, 2)     # n * A_i^T, (W, d, rows)

    def worker_grads(x):
        r = torch.matmul(a_w, x) - y_w                      # (W, rows)
        return torch.add(torch.matmul(n_a_wt, r.unsqueeze(-1)).squeeze(-1),
                         x, alpha=lam)

    def full_grad(x):
        return a.T @ (a @ x - y) + lam * x

    def loss(x):
        r = a @ x - y
        return 0.5 * torch.sum(r**2) + 0.5 * lam * torch.sum(x**2)

    evals = np.linalg.eigvalsh(a_np.T @ a_np)
    l_is = [
        n * np.linalg.eigvalsh(a_w_np[i].T @ a_w_np[i])[-1] + lam
        for i in range(n_workers)
    ]
    return Problem(
        name="ridge",
        d=d,
        n_workers=n_workers,
        worker_grads=worker_grads,
        full_grad=full_grad,
        loss=loss,
        x_star=_on(x_star_np, dtype, dev),
        L=float(evals[-1] + lam),
        L_max=float(max(l_is)),
        mu=float(evals[0] + lam),
    )


def make_logreg(
    m: int = 300, d: int = 60, n_workers: int = 10,
    kappa_target: float = 100.0, seed: int = 1,
    device=None, dtype: torch.dtype = torch.float32,
) -> Problem:
    """l2-regularized logistic regression on synthetic data; lam chosen so
    that cond(f) ~= kappa_target (the paper's Appendix C protocol).  x*
    found by damped Newton to ||grad||^2 <= 1e-28."""
    assert m % n_workers == 0
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    a_np = rng.randn(m, d) / np.sqrt(d)
    w_true = rng.randn(d)
    logits = a_np @ w_true
    b_np = np.where(rng.rand(m) < 1.0 / (1.0 + np.exp(-logits)), 1.0, -1.0)

    # L_logistic = lmax(A^T A)/(4m); pick lam so (L_log + lam)/lam = kappa.
    l_data = float(np.linalg.eigvalsh(a_np.T @ a_np)[-1]) / (4.0 * m)
    lam = l_data / (kappa_target - 1.0)

    rows = m // n_workers
    a_w_np = a_np.astype(_NP_DTYPE[dtype]).reshape(n_workers, rows, d)
    a = _on(a_np, dtype, dev)
    b = _on(b_np, dtype, dev)
    a_w = a.reshape(n_workers, rows, d)
    b_w = b.reshape(n_workers, rows)

    def _grad(ai, bi, x):
        # batched over a leading worker axis when ai is (W, rows, d)
        z = torch.matmul(ai, x) * bi
        s = torch.sigmoid(-z)  # = 1 - sigma(z)
        g = torch.matmul(ai.transpose(-1, -2), (s * bi).unsqueeze(-1))
        return -g.squeeze(-1) / ai.shape[-2] + lam * x

    def worker_grads(x):
        return _grad(a_w, b_w, x)

    def full_grad(x):
        return _grad(a, b, x)

    def loss(x):
        z = (a @ x) * b
        return torch.mean(torch.log1p(torch.exp(-z))) + 0.5 * lam * torch.sum(
            x**2)

    # High-precision optimum by damped Newton (numpy, float64).
    x = np.zeros(d)
    for _ in range(200):
        z = (a_np @ x) * b_np
        s = 1.0 / (1.0 + np.exp(z))  # sigma(-z)
        g = -(a_np.T @ (s * b_np)) / m + lam * x
        if g @ g < 1e-28:
            break
        w = s * (1.0 - s)
        hess = (a_np.T * w) @ a_np / m + lam * np.eye(d)
        x = x - np.linalg.solve(hess, g)

    l_i = [
        float(np.linalg.eigvalsh(a_w_np[i].T @ a_w_np[i])[-1])
        / (4.0 * rows) + lam
        for i in range(n_workers)
    ]
    return Problem(
        name="logreg",
        d=d,
        n_workers=n_workers,
        worker_grads=worker_grads,
        full_grad=full_grad,
        loss=loss,
        x_star=_on(x, dtype, dev),
        L=l_data + lam,
        L_max=float(max(l_i)),
        mu=lam,
    )
