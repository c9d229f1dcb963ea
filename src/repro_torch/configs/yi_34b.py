"""yi-34b: dense llama-arch GQA LM [arXiv:2403.04652].

60L, d_model=7168, 56 heads, GQA kv=8, d_ff=20480, vocab=64000.
"""

import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    arch_id="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv=8,
    d_ff=20480, vocab=64000, head_dim=128, rope_theta=5_000_000.0,
    param_dtype=torch.bfloat16, microbatch=4)

SMOKE = TransformerConfig(
    arch_id="yi-34b-smoke", n_layers=2, d_model=56, n_heads=4, n_kv=2,
    d_ff=112, vocab=512, head_dim=16, param_dtype=torch.float32, remat=False,
    ce_chunk=32, attn_blk=32)

register(ArchSpec(
    arch_id="yi-34b", family="lm", config=CONFIG, smoke=SMOKE,
    source="arXiv:2403.04652; hf",
    skip_cells={"long_500k": "pure full-attention arch (no sub-quadratic "
                             "path); skip per assignment rules"}))
