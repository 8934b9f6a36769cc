"""h2o-danube-1.8b [arXiv:2401.16818; hf]
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000; llama+mistral mix
with sliding-window attention (window 4096) => sub-quadratic, so this is
the ONE assigned LM arch that runs long_500k (DESIGN 4.1)."""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig
from repro_torch.optim import OptimizerConfig

def make_config():
    return TransformerConfig(
        name="h2o-danube-1.8b", n_layers=24, d_model=2560, n_heads=32,
        n_kv=8, d_head=80, d_ff=6912, vocab=32000, window=4096,
        activation_dtype="bfloat16")

def make_smoke_config():
    return TransformerConfig(
        name="danube-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_head=16, d_ff=128, vocab=128, window=16, loss_chunk=16)

SPEC = register(ArchSpec(
    arch_id="h2o-danube-1.8b", family="lm", source="arXiv:2401.16818",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(long_ctx_ok=True),
    optimizer=OptimizerConfig(name="adamw", lr=3e-4),
    notes="SWA: ring-buffer KV cache of window size at decode."))
