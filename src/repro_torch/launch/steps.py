"""Step programs per (architecture x shape cell) (port of the recsys
serving part of ``repro.launch.steps``).

``build_cell(arch_id, cell_name, smoke, device)`` returns a ``CellProgram``
with the cell's config and input specs, ``init_params(generator)`` (the
model, on the generator's device) and ``step(model, inputs)``;
``init_inputs(program, generator)`` draws a batch of inputs in the
reference's ranges.  Only the serving cells are ported (``serve_p99``,
``serve_bulk``); training and candidate retrieval are ``ROADMAP.md``
queue 1, "Recsys, the rest".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import get_config, input_specs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import recsys as recsys_lib


@dataclasses.dataclass
class CellProgram:
    arch_id: str
    cell_name: str
    config: Any
    device: torch.device
    input_specs: Dict[str, Any]

    def init_params(self, generator: torch.Generator) -> recsys_lib.RecsysModel:
        """Fresh weights from ``generator``, which must be on the
        program's device."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, program on "
                             f"{self.device}")
        return recsys_lib.init_recsys_params(self.config, generator)

    def step(self, model: recsys_lib.RecsysModel,
             inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return recsys_lib.serve_scores(model, inputs)


def build_cell(arch_id: str, cell_name: str, smoke: bool = False,
               device: DeviceLike = None) -> CellProgram:
    return CellProgram(arch_id=arch_id, cell_name=cell_name,
                       config=get_config(arch_id, smoke),
                       device=resolve_device(device),
                       input_specs=input_specs(arch_id, cell_name, smoke))


def init_inputs(program: CellProgram,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One batch of random inputs, drawn on the generator's device in the
    reference's ranges: ``field_ids`` in [0, vocab), ``set_ids`` in
    [0, 2^s), ``set_counts`` in [1, set_nnz)."""
    cfg = program.config
    ranges = {"field_ids": (0, cfg.vocab), "set_ids": (0, 1 << cfg.minhash_s),
              "set_counts": (1, cfg.set_nnz)}
    return {name: torch.randint(*ranges[name], spec.shape, dtype=spec.dtype,
                                generator=generator, device=generator.device)
            for name, spec in program.input_specs.items()}
