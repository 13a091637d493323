"""mamba2-370m — attention-free SSM (SSD), 48L d_model=1024 state=128
[arXiv:2405.21060].  d_inner=2048, headdim=64 -> 32 SSM heads.  Runs
long_500k (O(1)-state decode).  The paper's sampling technique is
inapplicable to the attention-free core (DESIGN.md §4)."""
from repro_torch.models.registry import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_heads=32, ssm_head_dim=64, d_conv=4, expand=2,
    ssm_chunk=256, tie_embeddings=True,
    subquadratic=True,
))
