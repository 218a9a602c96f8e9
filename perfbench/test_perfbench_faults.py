"""A run with its timed path broken underneath comes out not correct.
The look for a card is skipped (the CPU, smoke sizes); everything else
is the harness's own run with the smoke limits (``smoke.LIMITS``, which
sound runs meet: ``test_perfbench_reference.py``), the program patched
where the fault lies:

* a step that returns its state unchanged (AdamW moves nothing);
* half of the batch left out, the mean taken over the rest (the second
  half of the workers' gradients replaced by the first half's);
* the exchange between positions left out (each mean is one worker's
  message, in the dense mean and in the ring);
* a token altered where it is produced (one token of the step's batch,
  as the workers receive it)."""

import pytest

from perfbench import harness
from perfbench.smoke import CELLS, smoke_cell


def still(orig):
    def update(self, grads, state, params):
        state.step += 1
        return params, state
    return update


def half_batch(orig):
    def grads(loss_fn, params, wbatch):
        w = wbatch["tokens"].shape[0]
        g, loss, metrics = orig(loss_fn, params, wbatch)
        for v in g.values():
            v[w // 2:] = v[:w - w // 2]
        return g, loss, metrics
    return grads


def own_row(cls, rows):
    return cls(value=rows[0].clone())


def own_ring(noise, tree, mesh, **kw):
    return {k: x[0].clone() for k, x in tree.items()}


def token(orig):
    def split(batch, w):
        out = orig(batch, w)
        out["tokens"][0, 0, 1] ^= 1        # another id below an even vocab
        return out
    return split


def _patch(monkeypatch, fault):
    from repro_torch.dist import collectives
    from repro_torch.launch import train
    from repro_torch.optim import optimizers

    if fault == "state unchanged":
        monkeypatch.setattr(optimizers.adamw, "update",
                            still(optimizers.adamw.update))
    elif fault == "half the batch":
        monkeypatch.setattr(train, "per_worker_grads",
                            half_batch(train.per_worker_grads))
    elif fault == "no exchange":
        monkeypatch.setattr(collectives.WorkerMean, "of_rows",
                            classmethod(own_row))
        monkeypatch.setattr(collectives, "q8_ring_tree_mean", own_ring)
    elif fault == "token altered":
        monkeypatch.setattr(train, "split_batch", token(train.split_batch))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state unchanged", "half the batch",
                                   "no exchange", "token altered"])
def test_fault_is_not_correct(monkeypatch, name, fault):
    cell = smoke_cell(name)
    _patch(monkeypatch, fault)
    out = harness.run_cell(cell, 2**31 + 7, 0.05, False, device="cpu")
    assert not out["correct"], out["checks"]
