"""wide-deep: Wide & Deep [arXiv:1606.07792].

40 sparse fields, embed_dim=32, deep MLP 1024-512-256.  Carries the
minhash frontend as an extra deep input (the paper's technique applied to
the wide&deep user-behavior set).
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    arch_id="wide-deep", interaction="concat", n_fields=40, vocab=1_000_000,
    embed_dim=32, mlp_dims=(1024, 512, 256), use_minhash_frontend=True,
    minhash_k=64, minhash_b=8, minhash_s=24, set_nnz=128)

SMOKE = RecsysConfig(
    arch_id="wide-deep-smoke", interaction="concat", n_fields=6, vocab=1000,
    embed_dim=8, mlp_dims=(32, 16), use_minhash_frontend=True, minhash_k=16,
    minhash_b=4, minhash_s=16, set_nnz=32)

register(ArchSpec(arch_id="wide-deep", family="recsys", config=CONFIG,
                  smoke=SMOKE, source="arXiv:1606.07792; paper"))
