"""llava-next-mistral-7b — mistral-7b text backbone consuming anyres patch
embeddings; the vision tower is a stub (callers pass precomputed patch
embeddings).  [hf:llava-hf/llava-v1.6-mistral-7b-hf]  Same values as
``repro.configs.llava_next_mistral_7b``."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    num_image_tokens=2880,                 # anyres: 5 tiles × 576 patches
    rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="llava-next-mistral-7b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16, num_image_tokens=8,
)
