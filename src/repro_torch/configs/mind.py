"""mind: Multi-Interest Network with Dynamic routing [arXiv:1904.08030].

embed_dim=64, 4 interest capsules, 3 routing iterations.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    arch_id="mind", interaction="multi-interest", n_fields=0, vocab=0,
    embed_dim=64, seq_len=100, n_interests=4, capsule_iters=3,
    item_vocab=1_000_000)

SMOKE = RecsysConfig(
    arch_id="mind-smoke", interaction="multi-interest", n_fields=0, vocab=0,
    embed_dim=16, seq_len=12, n_interests=2, capsule_iters=2,
    item_vocab=1000)

register(ArchSpec(arch_id="mind", family="recsys", config=CONFIG,
                  smoke=SMOKE, source="arXiv:1904.08030; unverified"))
