"""Sharding rules and shard placement (port of ``repro.sharding``).

  rules.py  -- logical -> physical axis resolution (``spec``) under the
               thread's current mesh; ``constrain`` / ``named_sharding``
               / ``NamedSharding`` over DTensor on a process mesh; the
               retrieval mesh's round-robin shard placement
               (``place_shards``, ``data_axis_devices``).
  params.py -- the parameter and optimizer-state spec trees of every
               arch (training on a mesh).
  spmd.py   -- collectives with autograd over a process mesh's axes, for
               code that runs on each rank's local shards.
"""

from repro_torch.sharding.rules import (NamedSharding, PartitionSpec,
                                        constrain, current_mesh,
                                        data_axis_devices, named_sharding,
                                        place_shards, set_mesh, spec)

__all__ = ["NamedSharding", "PartitionSpec", "constrain", "current_mesh",
           "data_axis_devices", "named_sharding", "place_shards",
           "set_mesh", "spec"]
