"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407; hf]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, 128k ctx,
head_dim=128 (q-proj 5120->4096), rope_theta=1e6. Full attention."""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig
from repro_torch.optim import OptimizerConfig

def make_config():
    return TransformerConfig(
        name="mistral-nemo-12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv=8, d_head=128, d_ff=14336, vocab=131072, rope_theta=1e6,
        activation_dtype="bfloat16")

def make_smoke_config():
    return TransformerConfig(
        name="nemo-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=256, rope_theta=1e6, loss_chunk=16)

SPEC = register(ArchSpec(
    arch_id="mistral-nemo-12b", family="lm",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(long_ctx_ok=False),
    optimizer=OptimizerConfig(name="adamw", lr=3e-4)))
