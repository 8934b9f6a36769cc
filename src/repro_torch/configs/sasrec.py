"""sasrec [arXiv:1808.09781; paper]
embed_dim=50 n_blocks=2 n_heads=1 seq_len=50 interaction=self-attn-seq."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, register
from repro_torch.models.recsys import SASRecConfig
from repro_torch.optim import OptimizerConfig

def make_config():
    return SASRecConfig(name="sasrec", vocab=1_000_000)

def make_smoke_config():
    return SASRecConfig(name="sasrec-smoke", vocab=1000, seq_len=12,
                        d_embed=16)

SPEC = register(ArchSpec(
    arch_id="sasrec", family="recsys", source="arXiv:1808.09781",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=dict(RECSYS_SHAPES),
    optimizer=OptimizerConfig(name="adamw", lr=1e-3)))
