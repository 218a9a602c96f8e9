"""Deterministic synthetic token streams for LM training.

The port of the reference's ``repro/data/tokens.py`` (text, the
vision-prefix stub and the audio frames stub): the same Markov-ish stream ``x_{t+1} = (31 * x_t + n_t) mod V`` with a
uniform start token and noise ``n_t`` in [0, 97), drawn from a
``torch.Generator`` seeded from ``(seed, step)`` -- so every batch is a
pure function of its step.  The draws are torch's: for the same seed the
tokens differ from the reference's (the parity tests feed both sides
one numpy batch instead).  ``make_batch_specs`` gives a TRAIN batch's
shapes as meta tensors, the dry-run's inputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig


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
    """One batch ``{"tokens": (batch, text_len) int64}``, drawn on the CPU
    from ``gen`` and moved to ``device``.  For the ``vision_prefix``
    modality the batch holds ``prefix`` too, the stub of the projected
    patch embeddings, (batch, num_prefix_tokens, d_model) f32 normals
    times 0.02, and the text fills the rest of the sequence: ``text_len
    = max(2, seq_len - num_prefix_tokens)``.  For an encoder-decoder it
    holds ``frames`` too, the stub of the audio frontend's frame
    embeddings, (batch, seq_len, d_model) f32 normals times 0.02, drawn
    after the tokens."""
    v = cfg.vocab_size
    text_len = seq_len
    if cfg.modality == "vision_prefix":
        text_len = max(2, seq_len - cfg.num_prefix_tokens)
    x = torch.randint(0, v, (batch,), generator=gen)
    noise = torch.randint(0, 97, (batch, text_len), generator=gen)
    toks = torch.empty((batch, text_len), dtype=torch.int64)
    for t in range(text_len):
        x = (x * 31 + noise[:, t]) % v
        toks[:, t] = x
    out = {"tokens": toks.to(device)}
    if cfg.modality == "vision_prefix":
        out["prefix"] = (torch.randn(
            (batch, cfg.num_prefix_tokens, cfg.d_model), generator=gen,
            dtype=torch.float32) * 0.02).to(device)
    if cfg.is_encoder_decoder:
        out["frames"] = (torch.randn(
            (batch, seq_len, cfg.d_model), generator=gen,
            dtype=torch.float32) * 0.02).to(device)
    return out


def make_batch_specs(cfg: ModelConfig,
                     shape: InputShape) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of a TRAIN batch of
    ``shape`` -- the dry-run path (no allocation; the reference's
    ``ShapeDtypeStruct`` specs, the tokens in the port's int64).  Decode
    specs live in ``launch.serve``."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    text = max(2, s - cfg.num_prefix_tokens) \
        if cfg.modality == "vision_prefix" else s
    specs = {"tokens": torch.empty((b, text), dtype=torch.int64,
                                   device=meta)}
    if cfg.modality == "vision_prefix":
        specs["prefix"] = torch.empty(
            (b, cfg.num_prefix_tokens, cfg.d_model), dtype=torch.float32,
            device=meta)
    if cfg.is_encoder_decoder:
        specs["frames"] = torch.empty((b, s, cfg.d_model),
                                      dtype=torch.float32, device=meta)
    return specs
