"""Per-worker gradients (``worker_grads``), collectives (``collectives``)
and the partition specs of the mesh (``sharding``)."""
