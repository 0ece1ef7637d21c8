"""Layer-stack machinery: heterogeneous superblocks, one loop over layers.

Every architecture is a *program*: an optional prelude, a repeating
superblock (run ``n_super`` times) and an optional trailing partial block.
A superblock is a tuple of Units (attn / cross / mlp / moe / mlstm /
slstm / rglru).  Where the JAX package stacks each unit's params on a
leading [n_super] axis and scans, the port keeps one ``nn.ModuleList`` of
unit params per superblock and loops; caches are a list over superblocks
of a tuple over units, so gemma2's local/global alternation and its
caches map one to one onto the JAX package's.

Every unit is ported.  In training (mode "train" with autograd
recording) ``cfg.remat`` recomputes each superblock in the backward pass,
as the JAX package's per-superblock ``jax.checkpoint``: "full" keeps only
the superblock's input, "dots" also keeps the outputs of its products
(``checkpoint_dots``); serving never recomputes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.models import attention, common, mlp, moe, recurrent


@dataclasses.dataclass(frozen=True)
class Unit:
    kind: str  # attn | cross | mlp | moe | mlstm | slstm | rglru
    window: int = 0
    causal: bool = True


def block_program(cfg):
    """(prelude, superblock, n_super, trailing) of Units for the decoder
    stack (the encoder stack, if any, is uniform and built separately)."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        if cfg.local_global_alternate:
            sb = (
                Unit("attn", window=cfg.local_window),
                Unit("mlp"),
                Unit("attn"),
                Unit("mlp"),
            )
            if cfg.n_layers % 2:
                raise ValueError(f"local/global alternation needs an even n_layers, "
                                 f"not {cfg.n_layers}")
            return (), sb, cfg.n_layers // 2, ()
        return (), (Unit("attn"), Unit("mlp")), cfg.n_layers, ()
    if fam == "moe":
        return (), (Unit("attn"), Unit("moe")), cfg.n_layers, ()
    if fam == "ssm":  # xLSTM 7:1
        sb = tuple(Unit("mlstm") for _ in range(7)) + (Unit("slstm"),)
        if cfg.n_layers % 8:
            raise ValueError(f"xLSTM's 7:1 superblock needs n_layers % 8 == 0, "
                             f"not {cfg.n_layers}")
        return (), sb, cfg.n_layers // 8, ()
    if fam == "hybrid":  # RecurrentGemma (R, R, A) + MLP after each mixer
        sb = (
            Unit("rglru"), Unit("mlp"),
            Unit("rglru"), Unit("mlp"),
            Unit("attn", window=cfg.local_window), Unit("mlp"),
        )
        n = cfg.n_layers // 3
        rem = cfg.n_layers % 3
        trailing = (Unit("rglru"), Unit("mlp")) * rem
        return (), sb, n, trailing
    if fam == "audio":  # whisper decoder
        return (), (Unit("attn"), Unit("cross", causal=False), Unit("mlp")), cfg.n_layers, ()
    raise ValueError(fam)


def encoder_program(cfg):
    return (Unit("attn", causal=False), Unit("mlp")), cfg.n_encoder_layers


# --------------------------------------------------------------- dispatch
# kind -> (params class, field table)
_UNITS = {
    "attn": (attention.AttnParams, attention.shapes),
    "cross": (attention.AttnParams, attention.shapes),
    "mlp": (mlp.MLPParams, mlp.shapes),
    "moe": (moe.MoEParams, moe.shapes),
    "mlstm": (recurrent.MLSTMParams, recurrent.mlstm_shapes),
    "slstm": (recurrent.SLSTMParams, recurrent.slstm_shapes),
    "rglru": (recurrent.RGLRUParams, recurrent.rglru_shapes),
}


def _unit(kind: str):
    if kind not in _UNITS:
        raise ValueError(kind)
    return _UNITS[kind]


def unit_shapes(cfg, u: Unit) -> dict:
    """field -> ``common.Field`` (shape, init kind, fan-in, float32 or the
    compute dtype): the one table that ``unit_init``, ``unit_params`` and
    ``weights`` read."""
    return _unit(u.kind)[1](cfg)


def unit_params(cfg, u: Unit, tensors: dict, dtype, device=None,
                master=None) -> common.ParamModule:
    """A unit's params module from its tensors by field name (trainable
    masters in ``master``: ``common.ParamModule``)."""
    return _unit(u.kind)[0](unit_shapes(cfg, u), dtype=dtype, device=device, master=master,
                            **tensors)


def unit_init(cfg, u: Unit, generator: torch.Generator, dtype,
              master=None) -> common.ParamModule:
    """Each field by its init kind (``common.init_field``), as the JAX
    package initializes it (from another random stream)."""
    return unit_params(cfg, u, {name: common.init_field(f, generator, master or dtype)
                                for name, f in unit_shapes(cfg, u).items()}, dtype,
                       master=master)


def unit_cache_init(cfg, u: Unit, batch, max_len, dtype, device=None):
    if u.kind == "attn":
        size = min(max_len, u.window * 2) if u.window else max_len
        return attention.init_cache(cfg, batch, size, dtype, device)
    if u.kind == "cross":
        K, hd = cfg.n_kv_heads, cfg.hd
        S = cfg.encoder_frames
        return (torch.zeros((batch, K, S, hd), dtype=dtype, device=device),
                torch.zeros((batch, K, S, hd), dtype=dtype, device=device))
    if u.kind == "mlstm":
        return recurrent.mlstm_cache_init(cfg, batch, dtype, device)
    if u.kind == "slstm":
        return recurrent.slstm_cache_init(cfg, batch, dtype, device)
    if u.kind == "rglru":
        return recurrent.rglru_cache_init(cfg, batch, dtype, device)
    return ()  # mlp/moe: stateless


_RECURRENT = {"mlstm": recurrent.mlstm_apply, "slstm": recurrent.slstm_apply,
              "rglru": recurrent.rglru_apply}
# units whose prefill lays the stream out itself: a sharded prefill may
# keep the stream split over the sequence from one such unit to the next
# (``recurrent._sequence_split``); every other unit takes it as the rows
SEQUENCE_UNITS = ("mlstm", "slstm")


def unit_apply(u: Unit, p, x, cfg, mode: str, cache, ctx: dict[str, Any]):
    """Returns (x, new_cache, aux): aux is the moe unit's load-balance plus
    z-loss in "train" mode, else 0.0.  In prefill, ``ctx["plain_attention"]``
    asks for the plain attention of ``attention.apply_prefill``.  For the
    checks, a moe unit appends its ``moe.Routing`` to ``ctx["moe_routes"]``
    and takes its experts from the iterator ``ctx["moe_experts"]`` where
    the caller puts them there."""
    if u.kind == "attn":
        if mode == "train":
            x = attention.apply_full(p, x, cfg, window=u.window, is_causal=u.causal)
            return x, (), 0.0
        if mode == "prefill":
            x, cache = attention.apply_prefill(p, x, cfg, cache, window=u.window,
                                               plain=ctx.get("plain_attention", False))
            return x, cache, 0.0
        x, cache = attention.apply_decode(p, x, cfg, cache, window=u.window)
        return x, cache, 0.0
    if u.kind == "cross":
        if mode in ("train", "prefill"):
            kv = attention.encode_kv(p, ctx["enc_out"], cfg)
            x = attention.apply_full(p, x, cfg, is_causal=False, kv_override=kv)
            return x, (kv if mode == "prefill" else ()), 0.0
        x = attention.apply_full(p, x, cfg, is_causal=False, kv_override=cache)
        return x, cache, 0.0
    if u.kind == "mlp":
        return mlp.apply(p, x, cfg), (), 0.0
    if u.kind == "moe":
        experts = ctx.get("moe_experts")
        x, a = moe.apply(p, x, cfg, with_aux=mode == "train", routes=ctx.get("moe_routes"),
                         experts=None if experts is None else next(experts))
        return x, (), (a["lb_loss"] + a["z_loss"] if a else 0.0)
    if u.kind in _RECURRENT:
        x, cache = _RECURRENT[u.kind](p, x, cfg, cache, decode=mode == "decode")
        return x, (() if mode == "train" else cache), 0.0
    raise ValueError(u.kind)


# ------------------------------------------------------------------ stacks
def init_stack(cfg, units: tuple[Unit, ...], n: int, generator, dtype,
               master=None) -> nn.ModuleList:
    """Per-superblock params: a ModuleList of n ModuleLists over units."""
    return nn.ModuleList(nn.ModuleList(unit_init(cfg, u, generator, dtype, master)
                                       for u in units) for _ in range(n))


def stack_cache_init(cfg, units, n, batch, max_len, dtype, device=None) -> list:
    return [tuple(unit_cache_init(cfg, u, batch, max_len, dtype, device) for u in units)
            for _ in range(n)]


def apply_units(params, x, cfg, units, mode, cache=None, ctx=None):
    """One pass over ``units`` (a superblock, the prelude or the trailing
    block) with their params and caches; returns (x, new caches, the sum
    of the units' aux)."""
    ctx = ctx or {}
    new_caches, aux = [], 0.0
    for j, u in enumerate(units):
        c = cache[j] if cache is not None else None
        if not (mode == "prefill" and u.kind in SEQUENCE_UNITS):
            x = common.batch_layout(x)
        x, nc, a = unit_apply(u, params[j], x, cfg, mode, c, ctx)
        new_caches.append(nc)
        aux = aux + a
    return x, tuple(new_caches), aux


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the products' outputs, recompute the rest."""
    if op in _DOTS:
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, mode: str):
    """``checkpoint.checkpoint``'s keywords for ``cfg.remat`` where autograd
    records a training pass, else ``None`` (no recomputation)."""
    if mode != "train" or cfg.remat == "none" or not torch.is_grad_enabled():
        return None
    if cfg.remat == "full":
        return {"use_reentrant": False}
    if cfg.remat == "dots":
        return {"use_reentrant": False, "context_fn": functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _save_dots)}
    raise ValueError(f"remat {cfg.remat!r} is not one of none, dots, full")


def apply_block(params, x, cfg, units, mode: str, cache=None, ctx=None):
    """``apply_units``, recomputed in the backward pass under ``cfg.remat``
    (``_remat``): a superblock, or the trailing block (recurrentgemma-9b's
    two RG-LRU and two MLP units after its superblocks, whose activations
    would otherwise be held whole at the loss).  Returns (x, new caches,
    aux)."""
    remat = _remat(cfg, mode)
    if remat is None or not units:
        return apply_units(params, x, cfg, units, mode, cache, ctx)
    return checkpoint.checkpoint(apply_units, params, x, cfg, units, mode, cache, ctx, **remat)


def apply_stack(params, x, cfg, units, n, mode: str, cache=None, ctx=None):
    """The superblock n times, in order, each recomputed in the backward
    pass under ``cfg.remat`` (``apply_block``).  Returns (x, new caches,
    aux)."""
    new_cache, aux = [], 0.0
    for i in range(n):
        c = cache[i] if cache is not None else None
        x, nc, a = apply_block(params[i], x, cfg, units, mode, c, ctx)
        new_cache.append(nc)
        aux = aux + a
    return x, new_cache, aux
