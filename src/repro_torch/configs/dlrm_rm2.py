"""dlrm-rm2 [arXiv:1906.00091; paper]
n_dense=13 n_sparse=26 embed_dim=64 bot=13-512-256-64 top=512-512-256-1
interaction=dot; 26 x 1M-row tables, row-sharded over `model`."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, register
from repro_torch.models.recsys import DLRMConfig
from repro_torch.optim import OptimizerConfig

def make_config():
    return DLRMConfig(name="dlrm-rm2", vocab=1_000_000)

def make_smoke_config():
    return DLRMConfig(name="dlrm-smoke", vocab=1000,
                      bot_mlp=(32, 16, 8), top_mlp=(32, 16, 1), d_embed=8)

SPEC = register(ArchSpec(
    arch_id="dlrm-rm2", family="recsys", source="arXiv:1906.00091",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=dict(RECSYS_SHAPES),
    optimizer=OptimizerConfig(name="adamw", lr=1e-3)))
