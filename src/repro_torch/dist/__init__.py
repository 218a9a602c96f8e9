"""Per-worker gradients (``worker_grads``) and collectives (``collectives``)."""
