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
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out(x, out, wo):
    """The residual plus out [B, S, H, hd] @ wo [H, hd, D]."""
    return x + out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


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
    qh = q.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4).reshape(B, K, G * Sq, hd)
    scores = (qh @ k.transpose(-1, -2)).view(B, K, G, Sq, Skv).to(torch.float32)
    scores = scores * (hd**-0.5)
    scores = common.softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, fa.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = (w.view(B, K, G * Sq, Skv) @ v).view(B, K, G, Sq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def _self_attention(q, k, v, cfg, window: int, causal: bool, plain: bool = False):
    """Self-attention over the whole sequence: the flash kernel (its plain
    version on CPU tensors, or where ``plain``).  As in the JAX package a
    window applies to causal attention only."""
    kw = dict(causal=causal, window=window if causal else 0, softcap=cfg.attn_softcap)
    if plain:
        return fa.flash_attention_torch(q, k, v, **kw)
    return ops.flash_attention(q, k, v, **kw)


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
        outs.append(_sdpa(q[:, c0:c0 + C], k, v, m[None], cfg))
    return torch.cat(outs, dim=1)


def _records(*tensors) -> bool:
    """Whether autograd records an operation on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
        if _records(q, k, v):
            k, v = k.transpose(1, 2), v.transpose(1, 2)  # head-major
            if is_causal and S > Q_CHUNK:
                out = _sdpa_chunked(q, k, v, cfg, window)
            else:
                mask = (causal_mask(S, window, x.device) if is_causal
                        else full_mask(S, S, x.device))
                out = _sdpa(q, k, v, mask, cfg)
        else:
            out = _self_attention(q, k, v, cfg, window, is_causal)
    else:
        q = _proj(h, p.wq)
        if cfg.qk_norm:
            q = common.rms_norm(q, p.q_norm)
        k, v = kv_override
        out = _sdpa(q, k.to(q.dtype), v.to(q.dtype), full_mask(S, k.shape[2], x.device), cfg)
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
    out = _self_attention(q, k, v, cfg, window, True, plain)
    y = _out(x, out, p.wo)
    Sc = cache.k.shape[2]
    k, v = k.transpose(1, 2), v.transpose(1, 2)  # head-major
    if S >= Sc:  # keep last Sc entries, ring-aligned
        ks = torch.roll(k[:, :, -Sc:], S % Sc, dims=2).to(cache.k.dtype)
        vs = torch.roll(v[:, :, -Sc:], S % Sc, dims=2).to(cache.v.dtype)
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
    out = _sdpa(q, cache.k.to(q.dtype), cache.v.to(q.dtype), mask, cfg)
    return _out(x, out, p.wo), KVCache(k=cache.k, v=cache.v, pos=pos + 1)
