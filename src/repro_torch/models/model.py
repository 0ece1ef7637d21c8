"""Public model API: init / loss / prefill / decode, mirroring
``repro.models.model`` for every architecture of the repository.

Params are a ``Params`` module (``nn.Module``) whose attributes carry the
JAX package's keys; the config is static.  The per-arch structure lives in
``transformer.block_program``.  For serving the matrices are held frozen
in the compute dtype ``cfg.dtype`` (the JAX package keeps float32 masters
and casts at each use, which gives the same values) and the norm scales
in float32.  For training (``trainable=True``) every tensor is a float32
master (``cfg.param_dtype``) that takes a gradient, cast at each use as
the JAX package casts its masters (``common.ParamModule``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, transformer


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Params(nn.Module):
    """embed [V, D], final_norm [D]; prelude, trailing: ModuleLists over
    units; main (and encoder): ModuleLists over superblocks of ModuleLists
    over units; enc_norm [D] with an encoder; lm_head [D, V] without tied
    embeddings."""

    def __init__(self, cfg: ModelConfig, embed, final_norm, prelude, main, trailing,
                 encoder=None, enc_norm=None, lm_head=None, master=None):
        super().__init__()

        def param(t, dtype):
            """Frozen in ``dtype``, or a trainable master in ``master`` (a
            copy of its own: the optimizer writes it in place)."""
            if master is None:
                return nn.Parameter(t.to(dtype), requires_grad=False)
            return nn.Parameter(t.to(master, copy=True), requires_grad=True)

        self.cfg = cfg
        dt = _dtype(cfg)
        self.embed = param(embed, dt)
        self.final_norm = param(final_norm, torch.float32)
        self.prelude, self.main, self.trailing = prelude, main, trailing
        self.encoder = encoder
        self.enc_norm = None if enc_norm is None else param(enc_norm, torch.float32)
        self.lm_head = None if lm_head is None else param(lm_head, dt)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                trainable: bool = False) -> Params:
    """Random params drawn on ``device`` (``None`` means ``"cuda"``) from a
    ``torch.Generator`` seeded with ``seed``, each field by its init kind
    (``common.init_field``: matrices ``common.dense_init``, norm scales
    zero), as ``repro.models.model.init_params`` (another random stream,
    so not its values; ``weights`` carries those across); ``trainable``:
    float32 masters that take a gradient."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = _dtype(cfg)
    master = common.master_dtype(cfg, trainable)
    prelude, sb, n_super, trailing = transformer.block_program(cfg)

    def zeros():
        return torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev)

    def units(us):
        return nn.ModuleList(transformer.unit_init(cfg, u, g, dt, master) for u in us)

    def matrix(shape):
        return common.dense_init(shape, g, cfg.d_model, master or dt)

    kw = {}
    if cfg.is_encoder_decoder:
        eu, en = transformer.encoder_program(cfg)
        kw["encoder"] = transformer.init_stack(cfg, eu, en, g, dt, master)
        kw["enc_norm"] = zeros()
    if not cfg.tie_embeddings:
        kw["lm_head"] = matrix((cfg.d_model, cfg.vocab))
    return Params(cfg, matrix((cfg.vocab, cfg.d_model)), zeros(), units(prelude),
                  transformer.init_stack(cfg, sb, n_super, g, dt, master), units(trailing),
                  master=master, **kw)


# ------------------------------------------------------------------ inputs
def embed_tokens(params: Params, cfg, tokens):
    dt = _dtype(cfg)
    # gathered from the master, then cast: the gradient sums in float32
    if common.is_dtensor(tokens):  # DTensor's rule for the embedding (and its backward)
        x = F.embedding(tokens.long(), common.fsdp_gathered(params.embed))
        x = common.fenced(common.batch_layout(x))  # its gradient too: the rule's backward
    else:
        x = params.embed[tokens.long()]
    x = x.to(dt)
    # the scale rounded to the compute dtype first, as the JAX package does
    return x * torch.tensor(cfg.d_model**0.5, dtype=dt, device=x.device)


def _encoder_forward(params: Params, cfg, frames, ctx):
    """Whisper-style encoder over stub frame embeddings [B, F, D]."""
    eu, en = transformer.encoder_program(cfg)
    x = frames.to(_dtype(cfg))
    x, _, _ = transformer.apply_stack(params.encoder, x, cfg, eu, en, "train", ctx=ctx)
    return common.rms_norm(x, params.enc_norm)


def _decoder_input(params: Params, cfg, batch):
    """Token embeddings, with modality stubs spliced in, plus ctx."""
    x = embed_tokens(params, cfg, batch["tokens"])
    ctx = {}
    if cfg.n_vision_tokens:  # VLM stub: patch embeddings replace the prefix
        vis = batch["vision_embeds"].to(x.dtype)
        nv = cfg.n_vision_tokens
        x = torch.cat([vis[:, :nv], x[:, nv:]], dim=1)
    if cfg.is_encoder_decoder:
        ctx["enc_out"] = _encoder_forward(params, cfg, batch["frames"], ctx)
    return x, ctx


def _run_decoder(params: Params, cfg, x, mode, cache=None, ctx=None):
    prelude, sb, n_super, trailing = transformer.block_program(cfg)
    c_pre = cache["prelude"] if cache is not None else None
    c_main = cache["main"] if cache is not None else None
    c_trail = cache["trailing"] if cache is not None else None
    x, nc_pre, a0 = transformer.apply_units(params.prelude, x, cfg, prelude, mode, c_pre,
                                            ctx)
    x, nc_main, a1 = transformer.apply_stack(params.main, x, cfg, sb, n_super, mode, c_main,
                                             ctx)
    x, nc_trail, a2 = transformer.apply_block(params.trailing, x, cfg, trailing, mode,
                                              c_trail, ctx)
    return x, {"prelude": nc_pre, "main": nc_main, "trailing": nc_trail}, a0 + a1 + a2


def logits_fn(params: Params, cfg, x):
    head = params.embed.t() if cfg.tie_embeddings else params.lm_head
    x = common.batch_layout(x)  # a sharded step's logits then split the vocab over "model"
    return common.softcap(x @ common.fsdp_gathered(head.to(x.dtype)), cfg.logit_softcap)


def _routing_ctx(ctx: dict, routes, experts) -> dict:
    """The moe units' side channel of ``transformer.unit_apply``: each
    appends its dispatch (``moe.Routing``) to the list ``routes`` and, given
    ``experts`` (a list, one [T, k] tensor a moe unit, as another pass's
    ``routes``' ``gate_idx``), sends its tokens to those experts in layer
    order instead of its own top-k.  For the checks only."""
    if routes is not None:
        ctx["moe_routes"] = routes
    if experts is not None:
        ctx["moe_experts"] = iter(experts)
    return ctx


# ------------------------------------------------------------------ train
def forward_train(params: Params, cfg, batch, *, routes=None, experts=None):
    """(logits [B, S, V], aux): aux is the sum of the moe units'
    load-balance and z-losses (0 without them).  Differentiable: with
    trainable params autograd records it, and self-attention takes the
    plain attention (``attention.apply_full``), recomputed per superblock
    under ``cfg.remat``.  ``routes``, ``experts``: ``_routing_ctx``."""
    x, ctx = _decoder_input(params, cfg, batch)
    _routing_ctx(ctx, routes, experts)
    x, _, aux = _run_decoder(params, cfg, x, "train", ctx=ctx)
    x = common.rms_norm(x, params.final_norm)
    return logits_fn(params, cfg, x), torch.as_tensor(aux, dtype=torch.float32,
                                                      device=x.device)


class _VocabParallelNLL(torch.autograd.Function):
    """logsumexp - the gold logit of DTensor logits [B, S, V] (float32)
    whose vocab may be sharded, for DTensor labels [B, S], with no shard of
    the vocab gathered (the vocab-parallel cross entropy): each device's
    max, sum of exponentials and gold logit over its vocab shard, each
    reduced over the mesh dims that shard the vocab, and in the backward
    softmax - one-hot on each shard.  DTensor's own rules would gather the
    whole vocab of the logits' gradient on every device."""

    @staticmethod
    def forward(ctx, logits, labels):
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Replicate

        mesh, last = logits.device_mesh, logits.dim() - 1
        vocab = [d for d, p in enumerate(logits.placements) if p.is_shard(last)]
        rows = [Replicate() if d in vocab else p for d, p in enumerate(logits.placements)]
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        lg = logits.to_local()
        lab = labels.redistribute(mesh, rows).to_local()
        # this device's first vocab id (the shards may be uneven: 51,866 on 16)
        with common.real_tensors():
            v0 = compute_local_shape_and_global_offset(logits.shape, mesh,
                                                       logits.placements)[1][-1]
        Vl = lg.shape[-1]

        def reduce(t, op):
            for d in vocab:
                t = funcol.all_reduce(t, op, mesh.get_group(d))
            return t

        m = reduce(lg.amax(-1), "max")
        lse = torch.log(reduce(torch.exp(lg - m[..., None]).sum(-1), "sum")) + m
        idx = lab - v0
        inside = (idx >= 0) & (idx < Vl)
        idx = idx.clamp(0, Vl - 1)
        gold = reduce(torch.where(inside, lg.gather(-1, idx[..., None])[..., 0], 0.0), "sum")
        ctx.save_for_backward(lg, lse, idx, inside)
        ctx.layout = (mesh, logits.placements, rows, logits.shape, logits.stride())
        return DTensor.from_local(lse - gold, mesh, rows, run_check=False, shape=labels.shape,
                                  stride=labels.stride())

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        lg, lse, idx, inside = ctx.saved_tensors
        mesh, placements, rows, shape, stride = ctx.layout
        g = grad.redistribute(mesh, rows).to_local()
        p = torch.exp(lg - lse[..., None])
        p.scatter_add_(-1, idx[..., None], -inside[..., None].to(p.dtype))
        return DTensor.from_local(p * g[..., None], mesh, placements, run_check=False,
                                  shape=shape, stride=stride), None


def loss_fn(params: Params, cfg, batch):
    logits, aux = forward_train(params, cfg, batch)
    labels = batch["labels"].long()
    mask = (labels >= 0).to(torch.float32)
    lab = torch.clamp(labels, min=0)
    logits = logits.to(torch.float32)
    if common.is_dtensor(logits):
        from torch.distributed.tensor import Shard

        # a partial sum over a mesh dim reduced onto the vocab's shards
        part = [Shard(logits.dim() - 1) if p.is_partial() else p for p in logits.placements]
        logits = logits.redistribute(logits.device_mesh, part)
        nll = _VocabParallelNLL.apply(logits, lab) * mask
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        nll = (lse - gold) * mask
    ntok = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / ntok + aux
    return loss, {"nll": nll.sum() / ntok, "aux": aux, "ntok": ntok}


# ------------------------------------------------------------------ serve
def init_cache(params: Params, cfg, batch_size: int, max_len: int):
    prelude, sb, n_super, trailing = transformer.block_program(cfg)
    dt, dev = _dtype(cfg), params.device
    return {
        "prelude": tuple(transformer.unit_cache_init(cfg, u, batch_size, max_len, dt, dev)
                         for u in prelude),
        "main": transformer.stack_cache_init(cfg, sb, n_super, batch_size, max_len, dt, dev),
        "trailing": tuple(transformer.unit_cache_init(cfg, u, batch_size, max_len, dt, dev)
                          for u in trailing),
    }


def prefill(params: Params, cfg, batch, max_len: int, *, plain_attention: bool = False,
            routes=None, experts=None, cache=None):
    """Process the prompt; returns (last-position logits [B, V], cache).
    ``plain_attention`` runs the decoder's self-attention through the plain
    version of the attention kernel on the card (a reference to hold the
    kernel against); ``routes``, ``experts``: ``_routing_ctx``; ``cache``:
    the cache to fill (``init_cache``'s, or a sharded one), else a new
    one."""
    x, ctx = _decoder_input(params, cfg, batch)
    ctx["plain_attention"] = plain_attention
    _routing_ctx(ctx, routes, experts)
    if cache is None:
        cache = init_cache(params, cfg, x.shape[0], max_len)
    x, cache, _ = _run_decoder(params, cfg, x, "prefill", cache=cache, ctx=ctx)
    x = common.rms_norm(common.batch_layout(x)[:, -1:], params.final_norm)
    return logits_fn(params, cfg, x)[:, 0], cache


def decode_step(params: Params, cfg, tokens, cache, *, routes=None, experts=None):
    """One decode step.  tokens: [B, 1] -> (logits [B, V], new cache); the
    attention caches are written in place.  ``routes``, ``experts``:
    ``_routing_ctx``."""
    x = embed_tokens(params, cfg, tokens)
    x, cache, _ = _run_decoder(params, cfg, x, "decode", cache=cache,
                               ctx=_routing_ctx({}, routes, experts))
    x = common.rms_norm(x, params.final_norm)
    return logits_fn(params, cfg, x)[:, 0], cache
