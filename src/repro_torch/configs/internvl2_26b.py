"""internvl2-26b [vlm]: InternViT frontend stubbed to 256 patch embeddings
prepended to the text sequence; InternLM2-20B-style backbone.
[arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92553, mlp_kind="gated_silu", n_vision_tokens=256,
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=256, n_vision_tokens=8)
