"""hymba-1.5b — hybrid: parallel attention + mamba heads per layer
[arXiv:2411.13676].  d_inner=3200, ssm headdim=64 -> 50 SSM heads;
25 attention heads (GQA kv=5).  Meta-tokens omitted (noted simplification,
DESIGN.md §4).  Runs long_500k (hybrid; attn KV seq-sharded)."""
from repro_torch.models.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_heads=50, ssm_head_dim=64, d_conv=4, expand=2,
    ssm_chunk=256, rope_theta=1e4,
    subquadratic=True,
))
