"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]  Same values as ``repro.configs.h2o_danube_1_8b``."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80,
    window_size=4096,                      # mistral-style SWA
    rope_theta=10_000.0,
)

REDUCED = ModelConfig(
    name="h2o-danube-1.8b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16, window_size=16,
)
