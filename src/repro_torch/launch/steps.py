"""Step builders: train_step / prefill_step / serve_step for any
architecture, mirroring ``repro.launch.steps``.

The train step is the JAX package's single-device one ("xla" grad sync):
the loss and its gradients (autograd over ``model.loss_fn``, the plain
attention and ``cfg.remat``), then ``optimizer.update`` on the float32
masters in place.  The multi-device steps (a mesh, the "seqbalance" grad
sync through the ring all-reduce) wait in ROADMAP.md's queue 1 item 2 and
raise.
"""
from __future__ import annotations

import torch

from repro_torch.models import model
from repro_torch.train import optimizer as opt_mod

QUEUE_ITEM_2 = ("waits in ROADMAP.md's queue 1 item 2 (the ring all-reduce, "
                "dist/sharding.py and launch/mesh.py)")


def make_train_step(cfg, opt_cfg: opt_mod.AdamWConfig, mesh=None, grad_sync: str = "xla",
                    plan=None):
    """``train_step(state, batch) -> (state, {"loss", "nll", "grad_norm",
    "lr"})`` on one device; ``state`` is ``init_state``'s, its masters and
    moments updated in place.  ``plan`` (the grad sync's PathPlan) is
    unused on one device, as in the JAX package."""
    if mesh is not None or grad_sync != "xla":
        raise NotImplementedError(f"a mesh or grad_sync={grad_sync!r} {QUEUE_ITEM_2}")

    def train_step(state, batch):
        params = state["params"]
        for p in params.parameters():
            p.grad = None
        loss, metrics = model.loss_fn(params, cfg, batch)
        loss.backward()
        params, opt, om = opt_mod.update(None, state["opt"], params, opt_cfg)
        for p in params.parameters():
            p.grad = None
        return {"params": params, "opt": opt}, {"loss": loss.detach(),
                                                "nll": metrics["nll"].detach(), **om}

    return train_step


def make_prefill_step(cfg, max_len: int):
    def prefill_step(params, batch):
        return model.prefill(params, cfg, batch, max_len)

    return prefill_step


def make_serve_step(cfg):
    """One decode step: greedy next token against the KV cache."""

    def serve_step(params, tokens, cache):
        logits, cache = model.decode_step(params, cfg, tokens, cache)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step


def init_state(cfg, seed: int = 0, device=None) -> dict:
    """{"params": float32 masters from ``model.init_params`` (``device``:
    ``None`` means ``"cuda"``), "opt": zero moments}."""
    params = model.init_params(cfg, seed, device=device, trainable=True)
    return {"params": params, "opt": opt_mod.init(params)}
