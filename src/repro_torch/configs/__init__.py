"""Architecture configs the port serves (port of ``repro.configs``): so
far Wide & Deep."""

from repro_torch.configs.base import (ArchSpec, InputSpec, ShapeCell,
                                      get_arch, get_cell, get_config,
                                      input_specs)

__all__ = ["ArchSpec", "InputSpec", "ShapeCell", "get_arch", "get_cell",
           "get_config", "input_specs"]
