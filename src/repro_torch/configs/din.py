"""din [arXiv:1706.06978; paper]
embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80 interaction=target-attn."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, register
from repro_torch.models.recsys import DINConfig
from repro_torch.optim import OptimizerConfig

def make_config():
    return DINConfig(name="din", vocab=1_000_000)

def make_smoke_config():
    return DINConfig(name="din-smoke", vocab=1000, seq_len=12,
                     attn_mlp=(16, 8), mlp=(24, 12))

SPEC = register(ArchSpec(
    arch_id="din", family="recsys", source="arXiv:1706.06978",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=dict(RECSYS_SHAPES),
    optimizer=OptimizerConfig(name="adamw", lr=1e-3)))
