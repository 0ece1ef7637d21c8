"""Architecture registry + per-cell input specs, mirroring
``repro.configs.registry``: ``input_specs`` gives ``(shape, torch.dtype)``
where the JAX package gives ``jax.ShapeDtypeStruct``."""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCell

ARCH_MODULES = {
    "whisper-large-v3": "whisper_large_v3",
    "xlstm-1.3b": "xlstm_1_3b",
    "gemma2-2b": "gemma2_2b",
    "granite-3-8b": "granite_3_8b",
    "qwen3-32b": "qwen3_32b",
    "nemotron-4-15b": "nemotron_4_15b",
    "internvl2-26b": "internvl2_26b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "recurrentgemma-9b": "recurrentgemma_9b",
}
ARCHS = tuple(ARCH_MODULES)

# long_500k needs sub-quadratic attention over the whole context; only the
# SSM/hybrid archs hold O(1)/O(window) state (DESIGN.md §4).
LONG_CONTEXT_ARCHS = ("xlstm-1.3b", "recurrentgemma-9b")


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.REDUCED if reduced else mod.CONFIG


def get_shape(name: str) -> ShapeCell:
    (cell,) = [s for s in SHAPES if s.name == name]
    return cell


def cell_is_supported(arch: str, shape: ShapeCell) -> tuple[bool, str]:
    if shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "full-attention arch: 500k-context decode is quadratic-regime (skipped per assignment)"
    return True, ""


def list_cells(include_skipped: bool = False):
    """All (arch, shape) cells; skipped ones annotated."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            ok, why = cell_is_supported(arch, shape)
            if ok or include_skipped:
                out.append((arch, shape, ok, why))
    return out


def input_specs(cfg: ModelConfig, shape: ShapeCell, *, batch_override: int | None = None):
    """``{name: (shape, torch.dtype)}`` for every model input of this cell.

    train/prefill: {tokens, labels?} (+frames / vision_embeds stubs).
    decode: {tokens[B,1]}; the KV cache comes from ``model.init_cache``.
    """
    B = batch_override or shape.global_batch
    S = shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((B, 1), torch.int32)}
    batch = {"tokens": ((B, S), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = ((B, S), torch.int32)
    if cfg.is_encoder_decoder:
        batch["frames"] = ((B, cfg.encoder_frames, cfg.d_model), torch.float32)
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = ((B, cfg.n_vision_tokens, cfg.d_model), torch.float32)
    return batch
