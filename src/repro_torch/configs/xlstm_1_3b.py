"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks at 7:1, no separate FFN (d_ff=0).
[arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0,
)

REDUCED = CONFIG.replace(n_layers=8, d_model=64, n_heads=2, vocab=256)
