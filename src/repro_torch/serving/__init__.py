"""Serving: slot-based continuous batching over ``models.model``'s
decode step (``engine``), and the trainer -> fleet shifted model-delta
stream (``delta``: the publisher; ``fleet``: the subscribers) -- the
port of the reference's ``repro/serving``."""

from repro_torch.serving.delta import (
    DeltaMsg,
    DeltaPublisher,
    apply_msg,
    dense_tree_bits,
    tree_rel_err,
)
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.fleet import (
    Replica,
    ServingFleet,
    TrainerFleetBridge,
    run_fleet_demo,
)

__all__ = [
    "DeltaMsg",
    "DeltaPublisher",
    "Engine",
    "Replica",
    "Request",
    "ServingFleet",
    "TrainerFleetBridge",
    "apply_msg",
    "dense_tree_bits",
    "run_fleet_demo",
    "tree_rel_err",
]
