"""Continuous-batching serving engine -- the port of the reference's
``repro/serving/engine.py``.

Slot-based scheduling over ``models.model.decode_step``: a fixed batch
of B cache slots advances on a SHARED decode clock; requests are
admitted into free slots as others finish, their prompts fed token by
token (prefill as decode), then generated greedily until EOS or their
limit.  Per-slot correctness comes from two mechanisms:

  * attention caches carry PER-ROW validity (``kpos`` is (B, C) a
    layer): admitting a request invalidates its slot's cache entries,
    so the previous occupant's keys can never leak into the new one;
  * a request admitted at clock t lives at absolute positions t, t+1,
    ...; RoPE is relative, so its generation is position-coherent.

Recurrent state (RWKV-6) slots are zeroed on admit.  The clock is a
host int and the reset is done in place on the device: a tick reads
back only the next tokens (B ints), which the host needs to schedule.

The engine owns the weights it serves: it keeps a copy of what it is
given (``update_params``), so a trainer stepping its own params in
place never changes what the engine serves.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def _own(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of ``params`` that no one else holds."""
    return {k: v.detach().clone() for k, v in params.items()}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    fed: int = 0          # prompt tokens already fed

    @property
    def free(self) -> bool:
        return self.request is None


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 cache_len: int = 256):
        if cfg.is_encoder_decoder:
            raise ValueError("enc-dec serving needs per-request encoder "
                             "outputs; use launch.serve directly")
        self.cfg = cfg
        self.params = _own(params)
        self.device = next(iter(self.params.values())).device
        self.b = max_batch
        self.cache_len = cache_len
        self.state = M.make_decode_state(cfg, max_batch, cache_len,
                                         self.device)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.queue: deque[Request] = deque()
        self.clock = 0

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def update_params(self, params) -> None:
        """Swap the served weights BETWEEN decode ticks (the serving
        fleet's delta-application point): the engine keeps its own copy."""
        self.params = _own(params)

    def idle(self) -> bool:
        """No queued requests and every slot free."""
        return all(s.free for s in self.slots) and not self.queue

    def step_tick(self) -> List[Request]:
        """One admission pass + one shared-clock decode tick; returns the
        requests finished this tick (empty when idle -- the clock does
        not advance on an empty engine)."""
        self._admit()
        if self.idle():
            return []
        return self._tick()

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Drive until queue and slots drain; returns finished requests."""
        finished: List[Request] = []
        for _ in range(max_ticks):
            self._admit()
            if self.idle():
                break
            finished.extend(self._tick())
        return finished

    # -- internals -----------------------------------------------------------

    def _reset_slot_state(self, b: int) -> None:
        """Invalidate slot b's cache and state, in place on the device:
        its ``kpos`` to -1, its rows of k/v and of recurrent state to 0."""
        for name, leaf in self.state.items():
            if name.endswith("/kpos"):             # (L, B, C)
                leaf[:, b, :] = -1
            elif leaf.dim() >= 2 and leaf.shape[1] == self.b:
                leaf[:, b] = 0

    def _admit(self) -> None:
        for b, slot in enumerate(self.slots):
            if slot.free and self.queue:
                slot.request = self.queue.popleft()
                slot.fed = 0
                self._reset_slot_state(b)

    def _tick(self) -> List[Request]:
        """One shared-clock decode step for all slots."""
        toks = [0] * self.b
        for b, slot in enumerate(self.slots):
            r = slot.request
            if r is None:
                continue
            toks[b] = (r.prompt[slot.fed] if slot.fed < len(r.prompt)
                       else r.output[-1])
        tok = torch.tensor(toks, dtype=torch.int64)[:, None].to(self.device)
        logits, self.state = M.decode_step(self.params, self.cfg, tok,
                                           self.state, self.clock)
        nxt = logits[:, -1].argmax(dim=-1).tolist()
        self.clock += 1

        finished = []
        for b, slot in enumerate(self.slots):
            r = slot.request
            if r is None:
                continue
            if slot.fed < len(r.prompt):
                slot.fed += 1
                if slot.fed < len(r.prompt):
                    continue
                # prompt complete: this tick's logits give the first token
            r.output.append(int(nxt[b]))
            if (len(r.output) >= r.max_new_tokens
                    or (r.eos_id is not None and r.output[-1] == r.eos_id)):
                r.done = True
                finished.append(r)
                slot.request = None
        return finished
