"""gemma2-2b [dense]: local(4096)/global alternating attention, logit
softcap 30 / attn softcap 50, GQA kv=4, head_dim 256.  [arXiv:2408.00118]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab=256000, head_dim=256, mlp_kind="gated_gelu",
    local_global_alternate=True, local_window=4096,
    logit_softcap=30.0, attn_softcap=50.0,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab=256, local_window=8)
