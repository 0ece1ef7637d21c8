"""qwen3-32b [dense]: qk_norm, GQA kv=8, head_dim 128.  [hf:Qwen/Qwen3]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab=151936, head_dim=128, qk_norm=True, mlp_kind="gated_silu",
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab=256)
