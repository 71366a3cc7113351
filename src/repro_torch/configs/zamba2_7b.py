"""zamba2-7b — Mamba2 backbone + one weight-shared attention block every 6
mamba layers (81 = 11×(1+6) + 4 tail mamba).  [arXiv:2411.15242]
Same values as ``repro.configs.zamba2_7b``."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_state=64, ssm_expand=2, shared_attn_every=6,
)

REDUCED = ModelConfig(
    name="zamba2-7b-smoke", family="hybrid",
    num_layers=9, d_model=128, num_heads=2, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32,
    ssm_state=16, ssm_expand=2, shared_attn_every=3,
)
