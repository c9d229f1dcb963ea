"""autoint: self-attention feature interaction [arXiv:1810.11921].

39 sparse fields, embed_dim=16, 3 attention layers x 2 heads, d_attn=32.
Carries the paper's minhash frontend (set-valued feature -> k b-bit
signatures -> signature embedding-bag) as the 40th field.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    arch_id="autoint", interaction="self-attn", n_fields=39,
    vocab=1_000_000, embed_dim=16, n_attn_layers=3, n_attn_heads=2,
    d_attn=32, use_minhash_frontend=True, minhash_k=64, minhash_b=8,
    minhash_s=24, set_nnz=128)

SMOKE = RecsysConfig(
    arch_id="autoint-smoke", interaction="self-attn", n_fields=6,
    vocab=1000, embed_dim=8, n_attn_layers=2, n_attn_heads=2, d_attn=8,
    use_minhash_frontend=True, minhash_k=16, minhash_b=4, minhash_s=16,
    set_nnz=32)

register(ArchSpec(arch_id="autoint", family="recsys", config=CONFIG,
                  smoke=SMOKE, source="arXiv:1810.11921; paper"))
