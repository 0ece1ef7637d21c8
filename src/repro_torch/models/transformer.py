"""Layer-stack machinery: heterogeneous superblocks, one loop over layers.

Every architecture is a *program*: an optional prelude, a repeating
superblock (run ``n_super`` times) and an optional trailing partial block.
A superblock is a tuple of Units (attn / cross / mlp / moe / mlstm /
slstm / rglru).  Where the JAX package stacks each unit's params on a
leading [n_super] axis and scans, the port keeps one ``nn.ModuleList`` of
unit params per superblock and loops; caches are a list over superblocks
of a tuple over units, so gemma2's local/global alternation and its
caches map one to one onto the JAX package's.

Ported units: attn, cross, mlp.  The moe and recurrent units raise
``NotImplementedError`` (ROADMAP.md, queue 1); ``remat`` is for training
and is left out.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.models import attention, common, mlp

NOT_PORTED = ("moe", "mlstm", "slstm", "rglru")


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


def _not_ported(kind: str):
    raise NotImplementedError(
        f"the {kind!r} unit is not ported to PyTorch yet (ROADMAP.md, queue 1: the moe, "
        "ssm and hybrid families follow the dense, vlm and audio ones)")


# --------------------------------------------------------------- dispatch
def unit_shapes(cfg, u: Unit) -> dict:
    """field -> (shape, fan_in) of a unit's params; fan_in None for a norm."""
    if u.kind in ("attn", "cross"):
        return attention.shapes(cfg)
    if u.kind == "mlp":
        return mlp.shapes(cfg)
    if u.kind in NOT_PORTED:
        _not_ported(u.kind)
    raise ValueError(u.kind)


def unit_params(cfg, u: Unit, tensors: dict, dtype, device=None) -> common.ParamModule:
    """A unit's params module from its tensors by field name."""
    unit_shapes(cfg, u)  # raises for a unit that is not ported
    cls = attention.AttnParams if u.kind in ("attn", "cross") else mlp.MLPParams
    return cls(dtype=dtype, device=device, **tensors)


def unit_init(cfg, u: Unit, generator: torch.Generator, dtype) -> common.ParamModule:
    """Norm scales zero, matrices ``common.dense_init``, as the JAX package
    initializes them (from another random stream)."""
    tensors = {}
    for name, (shape, fan_in) in unit_shapes(cfg, u).items():
        if fan_in is None:
            tensors[name] = torch.zeros(shape, dtype=torch.float32, device=generator.device)
        else:
            tensors[name] = common.dense_init(shape, generator, fan_in, dtype)
    return unit_params(cfg, u, tensors, dtype)


def unit_cache_init(cfg, u: Unit, batch, max_len, dtype, device=None):
    if u.kind == "attn":
        size = min(max_len, u.window * 2) if u.window else max_len
        return attention.init_cache(cfg, batch, size, dtype, device)
    if u.kind == "cross":
        K, hd = cfg.n_kv_heads, cfg.hd
        S = cfg.encoder_frames
        return (torch.zeros((batch, K, S, hd), dtype=dtype, device=device),
                torch.zeros((batch, K, S, hd), dtype=dtype, device=device))
    if u.kind in NOT_PORTED:
        _not_ported(u.kind)
    return ()  # mlp: stateless


def unit_apply(u: Unit, p, x, cfg, mode: str, cache, ctx: dict[str, Any]):
    """Returns (x, new_cache).  In prefill, ``ctx["plain_attention"]`` asks
    for the plain attention of ``attention.apply_prefill``."""
    if u.kind == "attn":
        if mode == "train":
            x = attention.apply_full(p, x, cfg, window=u.window, is_causal=u.causal)
            return x, ()
        if mode == "prefill":
            return attention.apply_prefill(p, x, cfg, cache, window=u.window,
                                           plain=ctx.get("plain_attention", False))
        return attention.apply_decode(p, x, cfg, cache, window=u.window)
    if u.kind == "cross":
        if mode in ("train", "prefill"):
            kv = attention.encode_kv(p, ctx["enc_out"], cfg)
            x = attention.apply_full(p, x, cfg, is_causal=False, kv_override=kv)
            return x, (kv if mode == "prefill" else ())
        x = attention.apply_full(p, x, cfg, is_causal=False, kv_override=cache)
        return x, cache
    if u.kind == "mlp":
        return mlp.apply(p, x, cfg), ()
    if u.kind in NOT_PORTED:
        _not_ported(u.kind)
    raise ValueError(u.kind)


# ------------------------------------------------------------------ stacks
def init_stack(cfg, units: tuple[Unit, ...], n: int, generator, dtype) -> nn.ModuleList:
    """Per-superblock params: a ModuleList of n ModuleLists over units."""
    return nn.ModuleList(nn.ModuleList(unit_init(cfg, u, generator, dtype) for u in units)
                         for _ in range(n))


def stack_cache_init(cfg, units, n, batch, max_len, dtype, device=None) -> list:
    return [tuple(unit_cache_init(cfg, u, batch, max_len, dtype, device) for u in units)
            for _ in range(n)]


def apply_units(params, x, cfg, units, mode, cache=None, ctx=None):
    """One pass over ``units`` (a superblock, the prelude or the trailing
    block) with their params and caches; returns (x, new caches)."""
    ctx = ctx or {}
    new_caches = []
    for j, u in enumerate(units):
        c = cache[j] if cache is not None else None
        x, nc = unit_apply(u, params[j], x, cfg, mode, c, ctx)
        new_caches.append(nc)
    return x, tuple(new_caches)


def apply_stack(params, x, cfg, units, n, mode: str, cache=None, ctx=None):
    """The superblock n times, in order.  Returns (x, new caches)."""
    new_cache = []
    for i in range(n):
        x, nc = apply_units(params[i], x, cfg, units, mode,
                            cache[i] if cache is not None else None, ctx)
        new_cache.append(nc)
    return x, new_cache
