"""granite-moe-3b-a800m — 40-expert top-8 MoE (padded to 48 experts so a
16-way model axis divides them; the pads get −1e30 router logits and zero
weights).  [hf:ibm-granite/granite-3.0-3b-a800m-base: d_model 1536, 32
layers, 24 heads, 8 kv heads, 40 experts, top 8, expert d_ff 512]  Same
values as ``repro.configs.granite_moe_3b_a800m``, whose docstring cites
the 1b-a400m card instead."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=0, vocab_size=49155, head_dim=64,
    num_experts=40, experts_per_token=8, moe_d_ff=512,
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=0, vocab_size=512, head_dim=16,
    num_experts=5, experts_per_token=2, moe_d_ff=32,
    moe_capacity_factor=8.0,           # no token drops at smoke scale
)
