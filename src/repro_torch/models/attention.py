"""GQA attention with RoPE, optional qk-norm / softcap / sliding window,
full-sequence (train/prefill) and single-step (decode) paths.

The caches, and the keys and values that the plain attention takes, are
head-major, [B, K, S, hd] (the JAX package's [B, S, K, hd] with the
sequence and head axes swapped): decode then reads each head's keys and
values as one block, where the JAX layout would have every step copy the
whole cache into that order for the products.

Causal (and the whisper encoder's non-causal) self-attention over the
full sequence goes through ``kernels.ops.flash_attention``: the
hand-written kernel on CUDA tensors, its plain version on CPU tensors.
``apply_prefill(plain=True)`` asks for the plain version on the card
too; nothing switches to it by itself.  Decode (one query against the
ring cache) and cross-attention stay plain einsums, as in the JAX
package.

Training is the exception: the kernel has no backward (nor has the JAX
package's), so where autograd records (``apply_full`` in a training
pass), self-attention is the JAX package's ``_sdpa``, or ``_sdpa_chunked``
over query chunks above ``Q_CHUNK`` tokens, exactly where the JAX
package's ``apply_full`` takes them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import flash_attention as fa, ops
from repro_torch.models import common


class AttnParams(common.ParamModule):
    """ln [D]; wq [D, H, hd]; wk, wv [D, K, hd]; wo [H, hd, D]; q_norm,
    k_norm [hd] (qwen3's qk-norm; unused elsewhere)."""

    FIELDS = ("ln", "wq", "wk", "wv", "wo", "q_norm", "k_norm")


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, K, S_cache, hd]
    v: torch.Tensor  # [B, K, S_cache, hd]
    pos: int  # next write position (== #valid entries)


def shapes(cfg) -> dict:
    """field -> ``common.Field``."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dense = common.dense
    return {"ln": common.norm((D,)), "wq": dense((D, H, hd), D), "wk": dense((D, K, hd), D),
            "wv": dense((D, K, hd), D), "wo": dense((H, hd, D), H * hd),
            "q_norm": common.norm((hd,)), "k_norm": common.norm((hd,))}


def _proj(x, w):
    """x [B, S, D] @ w [D, H, hd] -> [B, S, H, hd]."""
    y = common.matmul(x, common.merge_ready(w, 1, -1).reshape(w.shape[0], -1))
    return common.fenced(common.split_ready(y, -1, w.shape[1]).unflatten(-1, w.shape[1:]))


def _out(x, out, wo):
    """The residual plus out [B, S, H, hd] @ wo [H, hd, D]."""
    wo2 = common.merge_ready(wo, 0, 1).reshape(-1, wo.shape[-1])
    return x + common.matmul(common.fenced(common.merge_ready(out, -2, -1).flatten(-2)), wo2)


def _qkv(p: AttnParams, x, positions, cfg):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qk_norm:
        q = common.rms_norm(q, p.q_norm)
        k = common.rms_norm(k, p.k_norm)
    # contiguous [B, S, H, hd], as the kernel's TMA reads them
    q = common.rope(q, positions, cfg.rope_theta).contiguous()
    k = common.rope(k, positions, cfg.rope_theta).contiguous()
    return q, k, v.contiguous()


def _sdpa(q, k, v, mask, cfg):
    """q: [B,Sq,H,hd]; k/v: [B,K,Skv,hd] (head-major); mask: [B or 1, Sq,
    Skv] bool.  The JAX package's ``_sdpa``: scores in q's dtype, then
    float32; the softmax weights rounded to q's dtype for the product."""
    B, Sq, H, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    ready, merged = common.split_ready, common.merge_ready  # DTensor layouts (no-ops else)
    qh = merged(ready(q, 2, K).reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4), 2, 3)
    scores = ready(qh.reshape(B, K, G * Sq, hd) @ k.transpose(-1, -2), 2, G)
    scores = scores.view(B, K, G, Sq, Skv).to(torch.float32) * (hd**-0.5)
    scores = common.softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, fa.NEG_INF)
    w = merged(torch.softmax(scores, dim=-1).to(q.dtype), 2, 3)
    out = ready(w.view(B, K, G * Sq, Skv) @ v, 2, G).view(B, K, G, Sq, hd)
    return merged(out.permute(0, 3, 1, 2, 4), 2, 3).reshape(B, Sq, H, hd)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous (a DTensor's view of
    a local gradient needs one)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _cache_aligned(q, k, mask):
    """(q's, k's and v's, the mask's placements) for one query row against a
    cache k [B, K, S, hd] that DTensor holds split over its batch or its KV
    heads (or replicated) on each mesh dim: the cache's own placements, q
    and the mask laid out to match (the batch as the cache's, the query
    heads as its KV heads: head h reads KV head h // G, so a contiguous
    share of the KV heads is one of the query heads).  Else (a query of
    more than one row, or a cache split over its positions or head dim,
    whose softmax would need a combine across devices) ``None``."""
    from torch.distributed.tensor import Replicate, Shard

    kp = list(k.placements)
    if q.shape[1] != 1 or any(not (p.is_replicate() or p.is_shard(0) or p.is_shard(1))
                              for p in kp):
        return None
    qp = [Shard(2) if p.is_shard(1) else p for p in kp]
    mp = [Shard(0) if p.is_shard(0) and mask.shape[0] == q.shape[0] else Replicate()
          for p in kp]
    return qp, kp, mp


def _attend(q, k, v, mask, cfg):
    """``_sdpa``; on DTensors, ``_sdpa`` on each device's block (``local_map``,
    the inputs laid out first).  Decode (one query row against the cache)
    attends where the cache lies (``_cache_aligned``): the cache stays,
    and the query and the mask move to it.  Else the batch over the
    mesh's data-parallel dims; over "model" the heads where both the query
    and the KV heads split over it, else the query rows where they split
    (k and v whole, the mask's rows as the queries'), else nothing.  So the
    score matrix is never held whole on a device where the heads do not
    split (gemma2-2b's 8 and 4 heads on 16), and no reshape of ``_sdpa``
    splits a DTensor.  The rules choose by divisibility and by the
    cache's placements alone."""
    if not common.is_dtensor(q):
        return _sdpa(q, k, v, mask, cfg)
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    B, Sq, H = q.shape[:3]
    K = k.shape[1]
    dp, qp, kp, mp = 1, [], [], []
    for name, n in zip(mesh.mesh_dim_names, mesh.shape):
        if name == "model" and H % n == 0 and K % n == 0:
            qp.append(Shard(2)), kp.append(Shard(1)), mp.append(Replicate())
        elif name == "model" and Sq % n == 0:
            qp.append(Shard(1)), kp.append(Replicate()), mp.append(Shard(1))
        elif name != "model" and B % (dp * n) == 0:
            dp *= n
            qp.append(Shard(0)), kp.append(Shard(0))
            mp.append(Shard(0) if mask.shape[0] == B else Replicate())
        else:
            qp.append(Replicate()), kp.append(Replicate()), mp.append(Replicate())
    if common.is_dtensor(k):
        qp, kp, mp = _cache_aligned(q, k, mask) or (qp, kp, mp)
    if common.is_dtensor(mask):
        mask = mask.redistribute(mesh, mp)
    else:
        mask = distribute_tensor(mask, mesh, mp, **common.no_source())
    q, k, v = q.redistribute(mesh, qp), k.redistribute(mesh, kp), v.redistribute(mesh, kp)
    def block(q, k, v, mask):  # contiguous out and gradients: DTensor views the shards
        q, k, v = (_ContiguousGrad.apply(t) for t in (q, k, v))
        return _sdpa(q, k, v, mask, cfg).contiguous()

    # k's and v's gradient: a partial sum over a dim that splits the
    # queries and not the keys (each device's queries read all of them)
    gp = [Partial() if a.is_shard() and b.is_replicate() else b for a, b in zip(qp, kp)]
    fn = local_map(block, out_placements=qp, in_placements=(qp, kp, kp, mp),
                   in_grad_placements=(qp, gp, gp, mp))
    # the rows gathered back: the output projection's product would merge a
    # split sequence with the batch
    return common.batch_layout(fn(q, k, v, mask))


def _self_attention(q, k, v, cfg, window: int, causal: bool, plain: bool = False):
    """Self-attention over the whole sequence: the flash kernel (its plain
    version on CPU tensors, or where ``plain``).  As in the JAX package a
    window applies to causal attention only."""
    kw = dict(causal=causal, window=window if causal else 0, softcap=cfg.attn_softcap)
    if plain:
        return fa.flash_attention_torch(q, k, v, **kw)
    if common.is_dtensor(q):
        q, k, v = _flash_layout(q, k, v)
    return ops.flash_attention(q, k, v, **kw)


def _flash_layout(q, k, v):
    """DTensor q, k, v laid out for the flash op's rule
    (``ops.register_flash_sharding``): the batch over the mesh's
    data-parallel dims, the heads over "model" where both the query and the
    KV heads split over it (not gemma2-2b's 8 and 4 on 16), else replicated
    there."""
    from torch.distributed.tensor import Replicate, Shard

    ops.register_flash_sharding()
    mesh = q.device_mesh
    B, H, K = q.shape[0], q.shape[2], k.shape[2]
    dp, out = 1, []
    for name, n in zip(mesh.mesh_dim_names, mesh.shape):
        if name == "model":
            out.append(Shard(2) if H % n == 0 and K % n == 0 else Replicate())
        elif B % (dp * n) == 0:
            dp *= n
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return tuple(t.redistribute(mesh, out) for t in (q, k, v))


def causal_mask(Sq: int, window: int = 0, device=None) -> torch.Tensor:
    i = torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Sq, device=device)[None, :]
    m = j <= i
    if window:
        m &= (i - j) < window
    return m[None]  # [1, Sq, Sq]


def full_mask(Sq: int, Skv: int, device=None) -> torch.Tensor:
    return torch.ones((1, Sq, Skv), dtype=torch.bool, device=device)


Q_CHUNK = 1024  # q-chunked attention above this sequence length (training)


def _sdpa_chunked(q, k, v, cfg, window: int):
    """Causal attention over query chunks of ``cfg.q_chunk`` tokens, each
    against every key under its rows' mask, so the [S, S] score tensor
    never materializes: ``attention.py:100-121`` of the JAX package (its
    ``lax.scan`` a loop here).  q [B, S, H, hd]; k, v head-major."""
    B, S, H, hd = q.shape
    C = min(cfg.q_chunk or Q_CHUNK, S)
    if S % C:
        raise ValueError(f"{S} tokens do not split into query chunks of {C}")
    j = torch.arange(S, device=q.device)
    outs = []
    for c0 in range(0, S, C):
        i = c0 + torch.arange(C, device=q.device)
        m = j[None, :] <= i[:, None]
        if window:
            m &= (i[:, None] - j[None, :]) < window
        outs.append(_attend(q[:, c0:c0 + C], k, v, m[None], cfg))
    return torch.cat(outs, dim=1)


def apply_full(p: AttnParams, x, cfg, *, window: int = 0, is_causal: bool = True,
               kv_override=None):
    """Train/encoder path over the full sequence.  ``kv_override`` supplies
    cross-attention keys/values from an encoder, head-major (``encode_kv``;
    x only provides queries; no RoPE across modalities).  Where autograd
    records, self-attention is the plain ``_sdpa`` (``_sdpa_chunked`` when
    causal above ``Q_CHUNK`` tokens), as the JAX package's; else the
    flash kernel."""
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    h = common.rms_norm(x, p.ln)
    if kv_override is None:
        q, k, v = _qkv(p, h, positions, cfg)
        if common.records(q, k, v):
            k, v = k.transpose(1, 2), v.transpose(1, 2)  # head-major
            if is_causal and S > Q_CHUNK:
                out = _sdpa_chunked(q, k, v, cfg, window)
            else:
                mask = (causal_mask(S, window, x.device) if is_causal
                        else full_mask(S, S, x.device))
                out = _attend(q, k, v, mask, cfg)
        else:
            out = _self_attention(q, k, v, cfg, window, is_causal)
    else:
        q = _proj(h, p.wq)
        if cfg.qk_norm:
            q = common.rms_norm(q, p.q_norm)
        k, v = kv_override
        out = _attend(q, k.to(q.dtype), v.to(q.dtype), full_mask(S, k.shape[2], x.device), cfg)
    return _out(x, out, p.wo)


def encode_kv(p: AttnParams, enc_out, cfg):
    """Cross-attention K/V from encoder output (whisper decoder), head-major
    [B, K, S, hd]."""
    k, v = _proj(enc_out, p.wk), _proj(enc_out, p.wv)  # already normed by the encoder
    if cfg.qk_norm:
        k = common.rms_norm(k, p.k_norm)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def init_cache(cfg, batch: int, max_len: int, dtype, device=None) -> KVCache:
    K, hd = cfg.n_kv_heads, cfg.hd
    return KVCache(k=torch.zeros((batch, K, max_len, hd), dtype=dtype, device=device),
                   v=torch.zeros((batch, K, max_len, hd), dtype=dtype, device=device), pos=0)


def apply_prefill(p: AttnParams, x, cfg, cache: KVCache, *, window: int = 0,
                  plain: bool = False):
    """Full-sequence forward that also fills the KV cache (in place: the
    cache is the one ``model.prefill`` just made).  Windowed caches are
    ring buffers (slot = abs_position mod cache_len), so only the last
    ``cache_len`` positions are retained."""
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    h = common.rms_norm(x, p.ln)
    q, k, v = _qkv(p, h, positions, cfg)
    if common.is_dtensor(q):  # the cache keeps k and v as the kernel takes them: reduced once
        q, k, v = _flash_layout(q, k, v)
    out = _self_attention(q, k, v, cfg, window, True, plain)
    y = _out(x, out, p.wo)
    Sc = cache.k.shape[2]
    k, v = k.transpose(1, 2), v.transpose(1, 2)  # head-major
    if S >= Sc:  # keep last Sc entries, ring-aligned
        ks = common.roll(k[:, :, -Sc:], S % Sc, 2).to(cache.k.dtype)
        vs = common.roll(v[:, :, -Sc:], S % Sc, 2).to(cache.v.dtype)
        return y, KVCache(k=ks, v=vs, pos=S)
    cache.k[:, :, :S] = k
    cache.v[:, :, :S] = v
    return y, KVCache(k=cache.k, v=cache.v, pos=S)


def apply_decode(p: AttnParams, x, cfg, cache: KVCache, *, window: int = 0):
    """One-token step. x: [B, 1, D]; attends to cache + self.  The cache is
    a ring buffer when shorter than the absolute position horizon; it is
    written in place."""
    B = x.shape[0]
    pos = cache.pos
    positions = torch.full((B, 1), pos, device=x.device)
    h = common.rms_norm(x, p.ln)
    q, k, v = _qkv(p, h, positions, cfg)
    Sc = cache.k.shape[2]
    slot = pos % Sc
    cache.k[:, :, slot] = k[:, 0]
    cache.v[:, :, slot] = v[:, 0]
    j = torch.arange(Sc, device=x.device)[None, None, :]  # [1,1,Sc]
    age = (slot - j) % Sc  # steps since slot j was written (0 = current)
    mask = (pos - age) >= 0
    if window:
        mask &= age < window
    out = _attend(q, cache.k.to(q.dtype), cache.v.to(q.dtype), mask, cfg)
    return _out(x, out, p.wo), KVCache(k=cache.k, v=cache.v, pos=pos + 1)
