"""Per-device replicas of the port's engine (``replicas.ReplicaPool``).
The JAX package's tensor-parallel mesh specs are not ported."""
