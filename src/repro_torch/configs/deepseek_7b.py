"""deepseek-7b: dense llama-arch LM [arXiv:2401.02954].

30L, d_model=4096, 32 heads (MHA: kv=32), d_ff=11008, vocab=102400.
Pure full attention -> long_500k skipped.
"""

import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    arch_id="deepseek-7b", n_layers=30, d_model=4096, n_heads=32, n_kv=32,
    d_ff=11008, vocab=102400, head_dim=128, rope_theta=10000.0,
    param_dtype=torch.bfloat16, microbatch=2)

SMOKE = TransformerConfig(
    arch_id="deepseek-7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, vocab=512, head_dim=16, param_dtype=torch.float32, remat=False,
    ce_chunk=32, attn_blk=32)

register(ArchSpec(
    arch_id="deepseek-7b", family="lm", config=CONFIG, smoke=SMOKE,
    source="arXiv:2401.02954; hf",
    skip_cells={"long_500k": "pure full-attention arch (no sub-quadratic "
                             "path); skip per assignment rules"}))
