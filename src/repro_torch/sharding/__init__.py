"""Sharding rules and shard placement (port of ``repro.sharding``).

  rules.py -- logical -> physical axis resolution (``spec``) under the
              thread's current mesh, and the retrieval mesh's round-robin
              shard placement (``place_shards``, ``data_axis_devices``).

The parameter shardings of training on a mesh (``params.py``) are not
ported: ROADMAP.md queue 1.
"""

from repro_torch.sharding.rules import (PartitionSpec, current_mesh,
                                        data_axis_devices, place_shards,
                                        set_mesh, spec)

__all__ = ["PartitionSpec", "current_mesh", "data_axis_devices",
           "place_shards", "set_mesh", "spec"]
