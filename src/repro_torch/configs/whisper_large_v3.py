"""whisper-large-v3 [audio]: enc-dec, conv/mel frontend stubbed to frame
embeddings (input_specs feeds [B, 1500, d_model]).  32 enc + 32 dec layers.
[arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51866, mlp_kind="gelu",
    is_encoder_decoder=True, n_encoder_layers=32, encoder_frames=1500,
)

REDUCED = CONFIG.replace(n_layers=2, n_encoder_layers=2, d_model=64,
                         n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
                         encoder_frames=24)
