"""Architecture configs the port serves and trains (port of
``repro.configs``): the recsys family -- Wide & Deep, AutoInt, DIN and
MIND."""

from repro_torch.configs.base import (ArchSpec, InputSpec, ShapeCell,
                                      cells_for, get_arch, get_cell,
                                      get_config, input_specs)

__all__ = ["ArchSpec", "InputSpec", "ShapeCell", "cells_for", "get_arch",
           "get_cell", "get_config", "input_specs"]
