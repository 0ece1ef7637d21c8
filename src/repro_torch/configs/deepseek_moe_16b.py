"""deepseek-moe-16b [moe]: fine-grained MoE — 2 shared + 64 routed experts,
top-6, expert width 1408.  [arXiv:2401.06066]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, mlp_kind="gated_silu",
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=32, vocab=256,
                         moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=32))
