"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8."""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig
from repro_torch.optim import OptimizerConfig

def make_config():
    return TransformerConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv=8, d_head=64, d_ff=512, vocab=49155, moe_experts=32,
        moe_top_k=8, rope_theta=10_000.0,
        activation_dtype="bfloat16")

def make_smoke_config():
    return TransformerConfig(
        name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_head=16, d_ff=32, vocab=128, moe_experts=4, moe_top_k=2,
        loss_chunk=16)

SPEC = register(ArchSpec(
    arch_id="granite-moe-1b-a400m", family="lm",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(long_ctx_ok=False),
    optimizer=OptimizerConfig(name="adamw", lr=3e-4),
    notes="32-expert top-8 MoE; EP over `model` via shard_map island."))
