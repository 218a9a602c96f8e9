"""Per-worker gradients -- "worker i computes grad f_i" (Alg. 1 l.5).

Worker i owns rows ``[i*B/W, (i+1)*B/W)`` of the global batch.  The
reference vmaps the loss gradient over the worker axis; here the
workers run one forward/backward pass each and write into preallocated
``(W, *param.shape)`` gradient buffers, whose mean over axis 0 is the
full-batch gradient.  Each worker's forward and backward pass is a span
(``grads/forward``, ``grads/backward``; ``repro_torch.spans``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.spans import span


def split_batch(batch: Dict[str, torch.Tensor], w: int):
    """Reshape every leaf's leading batch dim ``B`` to ``(W, B/W, ...)``;
    worker i's shard is exactly ``leaf[i*B/W:(i+1)*B/W]``."""
    out = {}
    for k, a in batch.items():
        b = a.shape[0]
        if b % w:
            raise ValueError(f"batch dim {b} not divisible by {w} workers "
                             f"(leaf {k!r} shape {tuple(a.shape)})")
        out[k] = a.reshape(w, b // w, *a.shape[1:])
    return out


def per_worker_grads(loss_fn: Callable, params: Dict[str, torch.Tensor],
                     wbatch: Dict[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Any]:
    """Stacked per-worker gradients of ``loss_fn(params, batch_i)``.

    ``loss_fn`` returns ``(loss, metrics)``.  Returns ``(wgrads, loss,
    metrics)``: ``wgrads`` leaves shaped ``(W, *param.shape)``, ``loss``
    the mean worker loss, ``metrics`` averaged over workers.  ``params``
    are not modified and need not require grad.
    """
    w = next(iter(wbatch.values())).shape[0]
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    wgrads = {k: torch.empty((w, *p.shape), dtype=p.dtype, device=p.device)
              for k, p in params.items()}
    losses, metrics = [], []
    # under the step's cost pass (meta tensors, ``launch.hlo_cost``) the
    # workers' passes are identical: one is traced and charged w times
    from repro_torch.launch import hlo_cost

    traced = hlo_cost.tracing(next(iter(wgrads.values())))
    loop = (hlo_cost.repeated(w, "workers") if traced
            else contextlib.nullcontext())
    with loop:
        for j in range(1 if traced else w):
            with torch.enable_grad():
                with span("grads/forward"):
                    loss, aux = loss_fn(leaves,
                                        {k: v[j] for k, v in wbatch.items()})
                with span("grads/backward"):
                    grads = torch.autograd.grad(loss, list(leaves.values()))
            for buf, g in zip(wgrads.values(), grads):
                buf[j].copy_(g)
            del grads
            losses.append(loss.detach())
            metrics.append({k: v.detach() for k, v in aux.items()})
    if traced:
        losses, metrics = losses * w, metrics * w
    loss = torch.stack(losses).mean()
    mean_metrics = {k: torch.stack([m[k] for m in metrics]).mean()
                    for k in metrics[0]}
    return wgrads, loss, mean_metrics
