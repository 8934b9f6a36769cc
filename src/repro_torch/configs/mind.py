"""mind [arXiv:1904.08030; unverified]
embed_dim=64 n_interests=4 capsule_iters=3 interaction=multi-interest."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, register
from repro_torch.models.recsys import MINDConfig
from repro_torch.optim import OptimizerConfig

def make_config():
    return MINDConfig(name="mind", vocab=1_000_000)

def make_smoke_config():
    return MINDConfig(name="mind-smoke", vocab=1000, seq_len=12, d_embed=16)

SPEC = register(ArchSpec(
    arch_id="mind", family="recsys", source="arXiv:1904.08030",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=dict(RECSYS_SHAPES),
    optimizer=OptimizerConfig(name="adamw", lr=1e-3)))
