"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 +
dense residual. bf16 params + Adafactor so state fits one pod (DESIGN 6)."""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig
from repro_torch.optim import OptimizerConfig

def make_config():
    return TransformerConfig(
        name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv=8,
        d_head=128, d_ff=4864, vocab=32000, moe_experts=128, moe_top_k=2,
        moe_dense_residual=True, rope_theta=10_000.0, param_dtype="bfloat16",
        activation_dtype="bfloat16")

def make_smoke_config():
    return TransformerConfig(
        name="arctic-smoke", n_layers=2, d_model=64, n_heads=8, n_kv=2,
        d_head=8, d_ff=48, vocab=128, moe_experts=8, moe_top_k=2,
        moe_dense_residual=True, loss_chunk=16)

SPEC = register(ArchSpec(
    arch_id="arctic-480b", family="lm",
    source="hf:Snowflake/snowflake-arctic-base",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(long_ctx_ok=False),
    optimizer=OptimizerConfig(name="adafactor", lr=1e-4),
    notes="dense-MoE hybrid: parallel dense FFN residual + 128e top-2 EP."))
