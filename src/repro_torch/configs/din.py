"""din: Deep Interest Network (target attention) [arXiv:1706.06978].

embed_dim=18, behavior seq_len=100, attention MLP 80-40, head MLP 200-80.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    arch_id="din", interaction="target-attn", n_fields=0, vocab=0,
    embed_dim=18, seq_len=100, attn_mlp_dims=(80, 40), mlp_dims=(200, 80),
    item_vocab=1_000_000)

SMOKE = RecsysConfig(
    arch_id="din-smoke", interaction="target-attn", n_fields=0, vocab=0,
    embed_dim=8, seq_len=12, attn_mlp_dims=(16, 8), mlp_dims=(16, 8),
    item_vocab=1000)

register(ArchSpec(arch_id="din", family="recsys", config=CONFIG,
                  smoke=SMOKE, source="arXiv:1706.06978; paper"))
