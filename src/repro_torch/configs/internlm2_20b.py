"""internlm2-20b — dense GQA transformer.  [arXiv:2403.17297; hf]
Same values as ``repro.configs.internlm2_20b``."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544, head_dim=128,
    rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="internlm2-20b-smoke", family="dense",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=16,
)
