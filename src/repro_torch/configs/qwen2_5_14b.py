"""qwen2.5-14b [hf:Qwen/Qwen2.5-14B; hf]
48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias."""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig
from repro_torch.optim import OptimizerConfig

def make_config():
    return TransformerConfig(
        name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40, n_kv=8,
        d_head=128, d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1e6,
        activation_dtype="bfloat16")

def make_smoke_config():
    return TransformerConfig(
        name="qwen-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=256, qkv_bias=True, loss_chunk=16)

SPEC = register(ArchSpec(
    arch_id="qwen2.5-14b", family="lm", source="hf:Qwen/Qwen2.5-14B",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(long_ctx_ok=False),
    optimizer=OptimizerConfig(name="adamw", lr=3e-4)))
