"""qwen3-moe-30b-a3b — 128-expert top-8 MoE, 3B active params.
[hf:Qwen/Qwen3-30B-A3B]  Same values as ``repro.configs.qwen3_moe_30b_a3b``."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=0, vocab_size=151936, head_dim=128,
    num_experts=128, experts_per_token=8, moe_d_ff=768,
    rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=0, vocab_size=512, head_dim=16,
    num_experts=8, experts_per_token=2, moe_d_ff=32,
    moe_capacity_factor=8.0,           # no token drops at smoke scale
)
