"""smollm-360m — llama-architecture small model (15 heads, GQA kv=5).
[hf:HuggingFaceTB/SmolLM-360M]  Same values as ``repro.configs.smollm_360m``;
like the reference, and unlike the Hugging Face model, it uses
``norm_eps`` 1e-6 and scales the embedding by sqrt(d_model)."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
)

REDUCED = ModelConfig(
    name="smollm-360m-smoke", family="dense",
    num_layers=2, d_model=60, num_heads=3, num_kv_heads=1,
    d_ff=128, vocab_size=512, head_dim=20,
)
