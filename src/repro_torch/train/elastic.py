"""Elastic scaling: move a checkpoint onto a different mesh (port of
``repro.train.elastic``).

A checkpoint saved on a mesh of N ranks restores onto a mesh of M ranks
(M != N): arrays are loaded whole on the host and placed under the *new*
shardings derived from the same sharding rules.  This is the standard
elastic-rescale path (grow after capacity arrives, shrink around failed
nodes) -- the mesh shape is a runtime choice, never baked into the
checkpoint, which holds whole arrays (``checkpoint.save`` gathers).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.tree import tree_map


def reshard_restore(ckpt_dir: str, template: Any,
                    sharding_fn: Callable[[Any], Any],
                    step: Optional[int] = None) -> tuple[Any, int]:
    """Restore ``template``-shaped state with shardings from
    ``sharding_fn(template)`` -- a tree of ``rules.NamedSharding`` on the
    *new* mesh (None for a leaf restored unplaced)."""
    shardings = sharding_fn(template)
    return ckpt_lib.restore(ckpt_dir, template, step=step,
                            shardings=shardings)


def replicate_shardings(template: Any, mesh) -> Any:
    """All-replicated shardings (the trivially correct fallback)."""
    from repro_torch.sharding.rules import NamedSharding, PartitionSpec
    rep = NamedSharding(mesh, PartitionSpec())
    return tree_map(lambda _: rep, template)
