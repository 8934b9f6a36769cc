"""gin-tu [arXiv:1810.00826; paper]
GIN: n_layers=5 d_hidden=64 aggregator=sum eps=learnable.
d_feat / n_classes come from each shape cell (cora-, reddit-, products-,
TU-molecule-sized); see base.GNN_SHAPES."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES, register
from repro_torch.models.gnn import GINConfig
from repro_torch.optim import OptimizerConfig

def make_config():
    return GINConfig(name="gin-tu", n_layers=5, d_hidden=64,
                     learnable_eps=True)

def make_smoke_config():
    return GINConfig(name="gin-smoke", n_layers=2, d_hidden=16,
                     learnable_eps=True)

SPEC = register(ArchSpec(
    arch_id="gin-tu", family="gnn", source="arXiv:1810.00826",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=dict(GNN_SHAPES),
    optimizer=OptimizerConfig(name="adamw", lr=1e-3),
    notes="paper technique inapplicable to GNNs (DESIGN 4.2); "
          "implemented without it per assignment rules."))
