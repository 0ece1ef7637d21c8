"""granite-moe-3b-a800m [moe]: 40 routed experts top-8, expert width 512
(assignment spec; the hf granite-3.0-3b-a800m twin ships 40 experts top-8).
[hf:ibm-granite/granite-3.0-3b-a800m-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, mlp_kind="gated_silu",
    moe=MoEConfig(n_experts=40, top_k=8, n_shared=0, d_expert=512),
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=32, vocab=256,
                         moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_expert=32))
