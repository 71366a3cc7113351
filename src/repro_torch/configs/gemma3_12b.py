"""gemma3-12b — 5:1 local:global attention (1 024-token window on the
local layers), 128k context, 256k vocabulary, head_dim 256.
[hf:google/gemma-3-12b-pt]  Same values as ``repro.configs.gemma3_12b``."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    d_ff=15360, vocab_size=262144, head_dim=256,
    local_global_ratio=5, window_size=1024,
    rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="gemma3-12b-smoke", family="dense",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    local_global_ratio=5, window_size=8,
)
