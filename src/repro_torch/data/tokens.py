"""Deterministic synthetic token streams for LM training.

The port of the reference's ``repro/data/tokens.py`` text path: the
same Markov-ish stream ``x_{t+1} = (31 * x_t + n_t) mod V`` with a
uniform start token and noise ``n_t`` in [0, 97), drawn from a
``torch.Generator`` seeded from ``(seed, step)`` -- so every batch is a
pure function of its step.  The draws are torch's: for the same seed the
tokens differ from the reference's (the parity tests feed both sides
one numpy batch instead).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class TokenStream:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int, device="cpu") -> Dict[str, torch.Tensor]:
        gen = torch.Generator().manual_seed(self.seed * 1_000_003 + step)
        return synth_batch(gen, self.cfg, self.seq_len, self.global_batch,
                           device=device)


def synth_batch(gen: torch.Generator, cfg: ModelConfig, seq_len: int,
                batch: int, device="cpu") -> Dict[str, torch.Tensor]:
    """One batch ``{"tokens": (batch, seq_len) int64}``, drawn on the CPU
    from ``gen`` and moved to ``device``."""
    if cfg.modality != "text" or cfg.is_encoder_decoder:
        raise NotImplementedError(
            "modality frontends come with their architectures: ROADMAP "
            "queue 1, item 9"
        )
    v = cfg.vocab_size
    x = torch.randint(0, v, (batch,), generator=gen)
    noise = torch.randint(0, 97, (batch, seq_len), generator=gen)
    toks = torch.empty((batch, seq_len), dtype=torch.int64)
    for t in range(seq_len):
        x = (x * 31 + noise[:, t]) % v
        toks[:, t] = x
    return {"tokens": toks.to(device)}
