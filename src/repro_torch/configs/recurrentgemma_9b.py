"""recurrentgemma-9b [hybrid]: RG-LRU + local attention (window 2048) at
2:1, MQA kv=1, MLP after every mixer.  38 layers = 12x(R,R,A) + (R,R).
[arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab=256000, head_dim=256, mlp_kind="gated_gelu",
    local_window=2048, rglru_width=4096,
)

REDUCED = CONFIG.replace(n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
                         head_dim=16, d_ff=128, vocab=256, local_window=8,
                         rglru_width=64)
