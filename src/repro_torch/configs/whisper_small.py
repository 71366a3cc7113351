"""whisper-small — encoder-decoder audio transformer; the conv/mel front
end is a stub (the encoder takes frame embeddings).
[arXiv:2212.04356]  Same values as ``repro.configs.whisper_small``."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    encoder_layers=12, encoder_frames=1500, act="gelu",
)

REDUCED = ModelConfig(
    name="whisper-small-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    encoder_layers=2, encoder_frames=32, act="gelu",
)
