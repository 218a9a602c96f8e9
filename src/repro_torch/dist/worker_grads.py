"""Per-worker gradients -- "worker i computes grad f_i" (Alg. 1 l.5).

Worker i owns rows ``[i*B/W, (i+1)*B/W)`` of the global batch.  The
reference vmaps the loss gradient over the worker axis; here the
workers run one forward/backward pass each and write into preallocated
``(W, *param.shape)`` gradient buffers, whose mean over axis 0 is the
full-batch gradient.  Each worker's forward and backward pass is a span
(``grads/forward``, ``grads/backward``; ``repro_torch.spans``).

On a CUDA device one worker's pass is issued once and replayed as a
CUDA graph, once a worker (``per_worker_grads``): a step is some 10^4
small launches, and issuing them one by one costs the host more than
the device's work.
"""

from __future__ import annotations

import contextlib
import weakref
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


class _Graphed:
    """One ``loss_fn``'s worker pass as a CUDA graph: the key of the
    inputs it is recorded for, the memory pool of its first call
    (``_warm``), and once recorded the graph, its static batch (one
    worker's), its outputs ``(rows, loss, metrics)`` (``rows``: row 0 of
    each leaf's ``wgrads``) and the ``(W, *param.shape)`` buffers
    ``wgrads``."""

    __slots__ = ("key", "pool", "graph", "static", "out", "wgrads")

    def __init__(self, key):
        self.key, self.pool, self.graph = key, None, None
        self.static = self.out = self.wgrads = None


#: ``loss_fn`` -> its ``_Graphed``; an entry goes with its ``loss_fn``
_GRAPHS: "weakref.WeakKeyDictionary[Callable, _Graphed]" = \
    weakref.WeakKeyDictionary()
#: device index -> the side stream the passes' first calls and captures
#: run on (one a device: cuBLAS keeps a workspace for each stream it sees)
_SIDE: Dict[int, Any] = {}


def _graphable(params, wbatch) -> bool:
    """The passes can be replayed: the params on a CUDA device, no cost
    pass running, and a batch of tensors alone (a wired or fused-VJP
    batch carries per-round draws, which a graph would freeze)."""
    from repro_torch.launch import hlo_cost

    p = next(iter(params.values()))
    return (p.is_cuda and not hlo_cost.tracing(p)
            and all(isinstance(v, torch.Tensor) for v in wbatch.values()))


def _key(params, wbatch) -> tuple:
    """What a graph is recorded for: the params' addresses, shapes and
    dtypes (they are updated in place, so their addresses hold), the
    batch's shapes and dtypes (it is copied into the static batch)."""
    return (tuple((k, p.data_ptr(), tuple(p.shape), p.dtype)
                  for k, p in params.items()),
            tuple((k, tuple(v.shape), v.dtype) for k, v in wbatch.items()))


class _Pool:
    """A CUDA graph memory pool for one graph's passes, held until this
    object goes (the graph holds it too), the device's side stream, and
    the bytes the passes' first call reserved in the pool.

    The passes' first call runs on the side stream with every allocation
    on the device taken from the pool, and the capture runs on the same
    stream and pool: the caching allocator reuses a freed block only on
    the stream that allocated it, so recording the passes allocates none
    of the memory the first call freed again."""

    def __init__(self, device: torch.device):
        self.index = (device.index if device.index is not None
                      else torch.cuda.current_device())
        if self.index not in _SIDE:
            _SIDE[self.index] = torch.cuda.Stream(self.index)
        self.stream = _SIDE[self.index]
        self.id = torch.cuda.graph_pool_handle()
        self.bytes = 0

    @contextlib.contextmanager
    def side(self):
        """The block on the side stream, ordered after and before the
        current stream's work."""
        main = torch.cuda.current_stream(self.index)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            yield
        main.wait_stream(self.stream)


def _warm(run: Callable, device: torch.device):
    """``run()`` eagerly on the side stream, every allocation on ``device``
    (from any thread: the backward runs on the autograd engine's) from a
    new pool; returns ``(pool, run's outputs)``.  The pool stays
    referenced until the returned object goes."""
    # while memory is routed to a pool, an allocation that finds the
    # device full cannot release the blocks the allocator caches for other
    # memory: release them first (torch.cuda.graph does so to capture)
    torch.cuda.empty_cache()
    pool = _Pool(device)
    before = torch.cuda.memory_reserved(pool.index)
    with pool.side():
        # paired as ``torch.cuda.use_mem_pool`` pairs them (torch 2.11):
        # the begin takes a use of the pool, ``_cuda_releasePool`` gives
        # it back, and the pool's blocks are freed once no graph holds it
        torch._C._cuda_beginAllocateToPool(pool.index, pool.id)
        weakref.finalize(pool, torch._C._cuda_releasePool, pool.index,
                         pool.id)
        try:
            out = run()
        finally:
            torch._C._cuda_endAllocateToPool(pool.index, pool.id)
    pool.bytes = torch.cuda.memory_reserved(pool.index) - before
    return pool, out


def _capture(run: Callable, pool: _Pool):
    """Record ``run()`` as one CUDA graph on ``pool``'s stream and memory
    (this launches nothing); returns ``(graph, run's outputs)``, which the
    graph's replays overwrite."""
    graph = torch.cuda.CUDAGraph()
    # as in ``_warm``, unless the device has free all that the first call
    # took: the capture reuses the pool's blocks and needs little more
    if torch.cuda.mem_get_info(pool.index)[0] < pool.bytes:
        torch.cuda.empty_cache()
    with pool.side():
        graph.capture_begin(pool=pool.id)
        try:
            out = run()
        finally:
            graph.capture_end()
    return graph, out


def per_worker_grads(loss_fn: Callable, params: Dict[str, torch.Tensor],
                     wbatch: Dict[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, Any]:
    """Stacked per-worker gradients of ``loss_fn(params, batch_i)``.

    ``loss_fn`` returns ``(loss, metrics)``.  Returns ``(wgrads, loss,
    metrics)``: ``wgrads`` leaves shaped ``(W, *param.shape)``, ``loss``
    the mean worker loss, ``metrics`` averaged over workers.  ``params``
    are not modified and need not require grad.

    Where the inputs allow it (``_graphable``) a worker's pass is a CUDA
    graph: the first call with a key (``_key``) runs eagerly (in the
    graph's memory pool, ``_warm``), the second records one worker's
    pass, and it and every later call replay it once a worker, each
    worker's batch copied into the graph's static batch (spans
    ``grads/capture``, ``grads/replay``).  Recording one pass, not W,
    keeps the recording and the graph's instantiation W times cheaper.
    The returned ``wgrads`` are then the graph's buffers: the next call
    overwrites them, so nothing may keep them past the step (the step's
    round reads them and keeps copies).  ``loss`` and ``metrics`` are
    fresh tensors on every call.
    """
    if not _graphable(params, wbatch):
        return _passes(loss_fn, params, wbatch)
    key = _key(params, wbatch)
    entry = _GRAPHS.get(loss_fn)
    if entry is None or entry.key != key:
        entry = _GRAPHS[loss_fn] = _Graphed(key)  # any older graph goes
        entry.pool, out = _warm(lambda: _passes(loss_fn, params, wbatch),
                                next(iter(params.values())).device)
        return out
    w = next(iter(wbatch.values())).shape[0]
    if entry.graph is None:
        with span("grads/capture"):
            static = entry.static = {k: v[:1].clone()
                                     for k, v in wbatch.items()}
            held = {}

            def run():      # one worker's pass, into row 0 of the buffers
                held.update((k, torch.empty((w, *p.shape), dtype=p.dtype,
                                            device=p.device))
                            for k, p in params.items())
                return _passes(loss_fn, params, static,
                               {k: g[:1] for k, g in held.items()})

            entry.graph, entry.out = _capture(run, entry.pool)
            entry.wgrads = dict(held)   # the buffers the recorded run made
    with span("grads/replay"):
        _, loss, metrics = entry.out
        losses, worker_metrics = [None] * w, [None] * w
        # the workers last to first: a replay writes row 0, copied on
        for j in reversed(range(w)):
            for k, v in entry.static.items():
                v.copy_(wbatch[k][j:j + 1])
            entry.graph.replay()
            if j:
                for g in entry.wgrads.values():
                    g[j].copy_(g[0])
            losses[j] = loss.clone()
            worker_metrics[j] = {k: v.clone() for k, v in metrics.items()}
        return (dict(entry.wgrads),) + _means(losses, worker_metrics)


def _passes(loss_fn, params, wbatch, wgrads=None):
    """The W workers' passes, one after another, into ``wgrads`` (new
    buffers if None) (``per_worker_grads``)."""
    w = next(iter(wbatch.values())).shape[0]
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    if wgrads is None:
        wgrads = {k: torch.empty((w, *p.shape), dtype=p.dtype,
                                 device=p.device) for k, p in params.items()}
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
    return (wgrads,) + _means(losses, metrics)


def _means(losses, metrics):
    """The workers' mean loss and mean metrics."""
    return (torch.stack(losses).mean(),
            {k: torch.stack([m[k] for m in metrics]).mean()
             for k in metrics[0]})
