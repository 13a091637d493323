"""mistral-nemo-12b — dense GQA kv=8, 128k ctx, head_dim=128
[hf:mistralai/Mistral-Nemo-Base-2407]."""
from repro_torch.models.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    rope_theta=1e6,
    subquadratic=False,
))
