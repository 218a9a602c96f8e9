"""The plain reference of a cell's first training steps, from the inputs
the benchmark makes (``perfbench.inputs``): the same initial parameters,
token batches and draws as the measured run.

``readings`` runs ``steps`` steps of a model family
(``reference/<model_type>.py``: W workers' forward and backward passes,
one DIANA round, AdamW) and returns what the comparison reads:
each step's loss (the workers' mean), each leaf's norm of the first
step's ``g_bar`` (what AdamW received), each leaf's norm of the change
of the parameters over the steps, and the wire bits counted.  It
imports nothing of the measured program.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

import numpy as np
import torch

from perfbench import inputs
from perfbench.reference import round as RR
from perfbench.reference.common import Wires


@contextmanager
def matmul_precision(tf32: bool):
    """f32 products (TF32 off), or TF32 products (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64)))
            for k, v in tree.items()}


def readings(family, config: dict, traffic: dict, seed: int, device,
             steps: int = 3, tf32: bool = False) -> dict:
    m = family.model_of(config)
    specs = family.param_specs(m)
    w, b, s = traffic["workers"], traffic["batch"], traffic["seq"]
    opt = traffic["optimizer"]
    draws = inputs.SeedDraws(inputs.draws_seed(seed), device)
    wired = traffic.get("moe_wire", "none") != "none" or \
        traffic.get("act_wire", "none") != "none"
    params = inputs.make_params(specs, seed, device)
    h = {k: torch.zeros((w, *p.shape), device=device)
         for k, p in params.items()}
    h_bar = {k: torch.zeros_like(p) for k, p in params.items()}
    mom = {k: torch.zeros_like(p) for k, p in params.items()}
    var = {k: torch.zeros_like(p) for k, p in params.items()}
    out = {"loss": [], "bits": 0.0}
    bits = np.float32(0)
    with matmul_precision(tf32):
        for step in range(steps):
            tokens = inputs.batch(seed, step, b, s, m.vocab, device)["tokens"]
            grads = {k: torch.empty((w, *p.shape), device=device)
                     for k, p in params.items()}
            losses = []
            for j in range(w):
                leaves = {k: p.detach().requires_grad_(True)
                          for k, p in params.items()}
                wires = (Wires(draws, j, traffic["moe_wire"] != "none",
                               traffic["act_wire"] != "none")
                         if wired else None)
                loss, _ = family.loss(leaves, m,
                                      tokens[j * b // w:(j + 1) * b // w], wires)
                gs = torch.autograd.grad(loss, list(leaves.values()))
                for k, g in zip(leaves, gs):
                    grads[k][j] = g
                losses.append(float(loss.detach()))
                del gs, leaves, loss
            out["loss"].append(float(np.mean(np.float32(losses))))
            with torch.no_grad():
                g_bar, step_bits = RR.diana_round(
                    grads, h, h_bar, draws, codec=traffic["compressor"],
                    aggregation=("dense" if traffic["comm_mode"] == "dense"
                                 else "q8_ring"),
                    alpha=traffic["shift_alpha"])
                del grads
                if step == 0:
                    out["grad1"] = leaf_norms(g_bar)
                lr = RR.learning_rate(step + 1, opt["lr"], opt["warmup_steps"],
                                      opt["total_steps"])
                RR.adamw(params, g_bar, mom, var, step + 1, lr=lr,
                         beta1=opt["beta1"], beta2=opt["beta2"],
                         eps=opt["eps"], weight_decay=opt["weight_decay"])
                del g_bar
            bits = np.float32(bits + step_bits)
            draws.next_round()
    del h, h_bar, mom, var
    start = inputs.make_params(specs, seed, device)
    out["change"] = leaf_norms({k: params[k] - start[k] for k in params})
    out["bits"] = float(bits)
    return out
