"""deepseek-v3-671b: MLA + MoE LM [arXiv:2412.19437].

61L, d_model=7168, 128 heads (MLA), vocab=129280.  MoE: 256 routed experts
(d_ff=2048) top-8 + 1 shared expert; first 3 layers dense (d_ff=18432).
MLA: q_lora=1536, kv_lora=512, nope=128, rope=64, v=128.
MTP (multi-token prediction) is a training-objective add-on in the paper;
the backbone modeled here is the deployed architecture.
"""

import torch

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    arch_id="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
    n_kv=128, d_ff=2048, vocab=129280, head_dim=128, attention="mla",
    rope_theta=10000.0, n_dense_layers=3, d_ff_dense=18432,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1,
                  capacity_factor=1.25, router="sigmoid"),
    q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128,
    param_dtype=torch.bfloat16, microbatch=8)

SMOKE = TransformerConfig(
    arch_id="deepseek-v3-671b-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv=4, d_ff=32, vocab=512, head_dim=16, attention="mla",
    n_dense_layers=1, d_ff_dense=128,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                  router="sigmoid"),
    q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_head=16,
    param_dtype=torch.float32, remat=False, ce_chunk=32, attn_blk=32)

register(ArchSpec(
    arch_id="deepseek-v3-671b", family="lm", config=CONFIG, smoke=SMOKE,
    source="arXiv:2412.19437; hf",
    skip_cells={"long_500k": "MLA is full softmax attention over all keys "
                             "(quadratic prefill); skip per assignment "
                             "rules"}))
