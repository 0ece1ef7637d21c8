"""Model / run configuration dataclasses.

One ``ModelConfig`` covers the whole assigned-architecture pool; per-arch
files in this package instantiate it with the published numbers.  A config
is STATIC (hashable) so it can parameterize jitted programs.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

LayerKind = Literal["attn", "mlstm", "slstm", "rglru"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0  # routed experts
    top_k: int = 0
    n_shared: int = 0  # shared (always-on) experts
    d_expert: int = 0  # per-expert FFN width
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 32000
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention variants
    qk_norm: bool = False  # qwen3
    logit_softcap: float = 0.0  # gemma2 (30.0 final / 50.0 attn)
    attn_softcap: float = 0.0
    local_window: int = 0  # sliding-window size where used
    local_global_alternate: bool = False  # gemma2: even layers local
    rope_theta: float = 10000.0

    # --- MLP variants
    mlp_kind: str = "gated_silu"  # gated_silu | gated_gelu | squared_relu
    moe: MoEConfig = MoEConfig()

    # --- recurrent variants
    layer_pattern: tuple[str, ...] = ()  # superblock, e.g. ("rglru","rglru","attn")
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333
    rglru_width: int = 0  # 0 -> d_model
    conv1d_width: int = 4  # temporal conv in recurrent blocks

    # --- encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_frames: int = 1500  # stub audio frontend sequence length

    # --- multimodal stub (internvl)
    n_vision_tokens: int = 0  # patch embeddings prepended by the stub

    # --- numerics / training
    q_chunk: int = 1024  # q-block size for chunked long-seq attention
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "none"  # none | dots | full  (per-superblock policy)
    tie_embeddings: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern(self) -> tuple[str, ...]:
        """The repeating superblock of layer kinds."""
        if self.layer_pattern:
            return self.layer_pattern
        return ("attn",)

    def superblocks(self) -> tuple[int, tuple[str, ...]]:
        """(n_repeats, pattern); n_layers must be divisible by len(pattern)
        except for an optional trailing partial block handled by the stack."""
        p = self.pattern
        return self.n_layers // len(p), p

    @property
    def trailing(self) -> tuple[str, ...]:
        p = self.pattern
        r = self.n_layers % len(p)
        return p[:r]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (arch x input-shape) cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)
