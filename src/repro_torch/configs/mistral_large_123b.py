"""mistral-large-123b: dense GQA LM
[hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L, d_model=12288, 96 heads, GQA kv=8, d_ff=28672, vocab=32768.
"""

import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    arch_id="mistral-large-123b", n_layers=88, d_model=12288, n_heads=96,
    n_kv=8, d_ff=28672, vocab=32768, head_dim=128, rope_theta=1_000_000.0,
    param_dtype=torch.bfloat16, microbatch=8)

SMOKE = TransformerConfig(
    arch_id="mistral-large-123b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv=2, d_ff=160, vocab=512, head_dim=16, param_dtype=torch.float32,
    remat=False, ce_chunk=32, attn_blk=32)

register(ArchSpec(
    arch_id="mistral-large-123b", family="lm", config=CONFIG, smoke=SMOKE,
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
    skip_cells={"long_500k": "pure full-attention arch (no sub-quadratic "
                             "path); skip per assignment rules"}))
