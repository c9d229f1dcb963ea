"""Architecture configs the port serves and trains (port of
``repro.configs``): the recsys family -- Wide & Deep, AutoInt, DIN and
MIND --, the LM family -- deepseek-7b, yi-34b, mistral-large-123b,
llama4-scout-17b-a16e and deepseek-v3-671b -- and the GNN family,
GatedGCN."""

from repro_torch.configs.base import (ArchSpec, InputSpec, ShapeCell,
                                      all_archs, cells_for, config_for_cell,
                                      get_arch, get_cell, input_specs,
                                      is_skipped)

__all__ = ["ArchSpec", "InputSpec", "ShapeCell", "all_archs", "cells_for",
           "config_for_cell", "get_arch", "get_cell", "input_specs",
           "is_skipped"]
