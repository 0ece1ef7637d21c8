"""Dense MLP channel mixers: gated (SiLU/GELU) and squared-ReLU variants."""
from __future__ import annotations

import torch

from repro_torch.models import common


class MLPParams(common.ParamModule):
    """ln [D]; wi [D, F] (up / sole projection); wg [D, F] (gate; [D, 0]
    when ungated); wo [F, D]."""

    FIELDS = ("ln", "wi", "wg", "wo")


def shapes(cfg, d_ff: int | None = None) -> dict:
    """field -> ``common.Field``."""
    D = cfg.d_model
    F = cfg.d_ff if d_ff is None else d_ff
    gated = cfg.mlp_kind.startswith("gated")
    return {"ln": common.norm((D,)), "wi": common.dense((D, F), D),
            "wg": common.dense((D, F if gated else 0), D), "wo": common.dense((F, D), F)}


def apply(p: MLPParams, x: torch.Tensor, cfg) -> torch.Tensor:
    h = common.rms_norm(x, p.ln)
    act = common.act_fn(cfg.mlp_kind)
    up = common.matmul(h, p.wi)
    if p.wg.shape[-1]:
        up = act(common.matmul(h, p.wg)) * up
    else:
        up = act(up)
    return x + common.matmul(up, p.wo)
