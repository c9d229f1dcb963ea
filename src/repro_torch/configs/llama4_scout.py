"""llama4-scout-17b-a16e: MoE LM with chunked-local attention
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L, d_model=5120, 40 heads, GQA kv=8, vocab=202048.  MoE: 16 experts
top-1 (d_ff=8192) + 1 shared expert.  iRoPE: chunked local attention
(window 8192) with every 4th layer global -> sub-quadratic prefill, so
``long_500k`` runs for this arch.  Early-fusion multimodality is a
frontend stub (the text backbone is modeled).
"""

import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    arch_id="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv=8, d_ff=8192, vocab=202048, head_dim=128, rope_theta=500000.0,
    local_window=8192, global_every=4,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192, n_shared=1,
                  capacity_factor=1.25, router="sigmoid"),
    param_dtype=torch.bfloat16, microbatch=4)

SMOKE = TransformerConfig(
    arch_id="llama4-scout-smoke", n_layers=4, d_model=64, n_heads=4, n_kv=2,
    d_ff=64, vocab=512, head_dim=16, local_window=16, global_every=4,
    moe=MoEConfig(n_experts=4, top_k=1, d_ff=64, n_shared=1,
                  router="sigmoid"),
    param_dtype=torch.float32, remat=False, ce_chunk=32, attn_blk=16)

register(ArchSpec(
    arch_id="llama4-scout-17b-a16e", family="lm", config=CONFIG, smoke=SMOKE,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified"))
