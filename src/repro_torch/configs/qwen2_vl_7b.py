"""qwen2-vl-7b — VLM backbone with M-RoPE [arXiv:2409.12191].  The vision
frontend is a STUB per the assignment: input_specs() supplies precomputed
patch embeddings; this config is the transformer backbone only."""
from repro_torch.models.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
    embeds_input=True,
    subquadratic=False,
))
