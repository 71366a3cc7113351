"""xlstm-1.3b — xLSTM[7:1]: 7 mLSTM blocks per 1 sLSTM block, 48 blocks.
[arXiv:2405.04517]  Same values as ``repro.configs.xlstm_1_3b``."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=64,
    slstm_every=8, ssm_expand=2,
)

REDUCED = ModelConfig(
    name="xlstm-1.3b-smoke", family="ssm",
    num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
    d_ff=0, vocab_size=512, head_dim=16,
    slstm_every=2, ssm_expand=2,
)
