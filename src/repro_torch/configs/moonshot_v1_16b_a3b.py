"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — MoE 64 experts top-6, sigmoid
routing, true expert parallelism (64e over the 16-way model axis)
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, moe_d_ff=1408, vocab_size=163840,
    num_experts=64, experts_per_token=6, routing="sigmoid",
    rope_theta=5e4,
    subquadratic=False,
))
