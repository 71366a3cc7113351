"""2s-AGCN — the paper's own model (Shi et al.): 10 TCN-GCN blocks on NTU
RGB+D skeletons, with the RFC-HyPGCN hybrid-pruning knobs exposed.
Same values as ``repro.configs.agcn_2s``."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="agcn-2s", family="gcn", num_layers=10,
    gcn_joints=25, gcn_frames=300, gcn_persons=2, gcn_in_channels=3,
    gcn_num_classes=60,
    gcn_channels=(64, 64, 64, 64, 128, 128, 128, 256, 256, 256),
    gcn_strides=(1, 1, 1, 1, 2, 1, 1, 2, 1, 1),
    gcn_kv=3, gcn_tkernel=9,
    # the paper's final accelerating target: Drop-1 + cav-70-1 + input skip 2
    cavity_pattern="cav-70-1", input_skip=2, gcn_stream_pool=0,
    prune_channel_fracs=(1.0, 0.6, 0.6, 0.55, 0.5, 0.5, 0.45, 0.4, 0.35, 0.3),
    # 3.5M parameters: replicated, the model axis carries batch
    sharding="dp_only",
)

REDUCED = ModelConfig(
    name="agcn-2s-smoke", family="gcn", num_layers=4,
    gcn_joints=25, gcn_frames=32, gcn_persons=1, gcn_in_channels=3,
    gcn_num_classes=10,
    gcn_channels=(8, 8, 16, 16), gcn_strides=(1, 1, 2, 1),
    gcn_kv=3, gcn_tkernel=9,
    cavity_pattern="cav-70-1", input_skip=2,
    gcn_stream_pool=0,          # streaming-clip parity
)
