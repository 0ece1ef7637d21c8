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
    return _normed(q, p.q_norm, positions, cfg), _normed(k, p.k_norm, positions, cfg), \
        v.contiguous()


def _normed(t, scale, positions, cfg):
    """q or k [B, S, heads, hd] after the qk-norm (qwen3's; its mean over hd)
    and RoPE at ``positions``: contiguous, as the kernel's TMA reads it."""
    if cfg.qk_norm:
        t = common.rms_norm(t, scale)
    return common.rope(t, positions, cfg.rope_theta).contiguous()


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
    window applies to causal attention only.  DTensors come laid out by
    ``_sharded_self_attention`` (the op's rule moves nothing)."""
    kw = dict(causal=causal, window=window if causal else 0, softcap=cfg.attn_softcap)
    if plain:
        return fa.flash_attention_torch(q, k, v, **kw)
    if common.is_dtensor(q):
        ops.register_flash_sharding()
    return ops.flash_attention(q, k, v, **kw)


def flash_plan(mesh, B: int, S: int, H: int, K: int) -> str:
    """How a sharded prefill's flash attention splits over the mesh's
    "model" dim of M members (the batch over the data-parallel dims in
    every case):

      "heads"     the query and the KV heads where both divide (or no
                  "model" dim of more than one member);
      "kv_heads"  the query heads where they divide and each device's H / M
                  consecutive heads read one KV head (the group H / K a
                  multiple of H / M): k and v whole on each device, which
                  passes the kernel its one KV head (qwen3-32b,
                  granite-3-8b, nemotron-4-15b, internvl2-26b and
                  recurrentgemma-9b at 16);
      "sequence"  else the queries, S in 2M blocks, device r taking blocks
                  r and 2M - 1 - r (``sequence_blocks``) against every key
                  (gemma2-2b's 8 and 4 heads, whisper-large-v3's 20,
                  granite-moe-3b-a800m's 24 and 8 at 16);
      "replicated" else (S not in 2M blocks): every "model" member attends
                  the whole batch's rows."""
    names = mesh.mesh_dim_names
    M = mesh.size(names.index("model")) if "model" in names else 1
    if H % M == 0 and K % M == 0:
        return "heads"
    if H % M == 0 and M % K == 0:
        return "kv_heads"
    return "sequence" if S % (2 * M) == 0 else "replicated"


def sequence_blocks(S: int, M: int, r: int) -> tuple:
    """(start, rows) of member r's two query blocks of S split into 2M:
    blocks r and 2M - 1 - r, so that each member's causal work is the same
    (with contiguous blocks the last would do 2M - 1 times the first's)."""
    b = S // (2 * M)
    return (r * b, b), ((2 * M - 1 - r) * b, b)


def _placed_for_flash(t, mesh, model):
    """A DTensor [B, S, heads, hd] laid out as the flash op takes it: the
    batch as the residual stream's (``common.batch_placements``), and on
    "model" (where the mesh has it) the placement ``model``."""
    out = common.batch_placements(mesh, t.shape[0])
    if "model" in mesh.mesh_dim_names:
        out[mesh.mesh_dim_names.index("model")] = model
    return t.redistribute(mesh, out)


def _sharded_self_attention(p: AttnParams, x, h, cfg, window: int, causal: bool,
                            plain: bool = False):
    """x + self-attention of the normed DTensor stream h [B, S, D] where
    autograd does not record (a sharded prefill), split over "model" as
    ``flash_plan`` says; returns (x + out, k, v), k and v [B, S, K, hd] as
    the cache keeps them (reduced once over "model": split over it by the
    heads, else whole).  q, k and v reach their layout before the qk-norm
    and RoPE (the norm's mean over hd is then a device's own, and no
    float32 copy of q or k crosses "model"); q by a reduce-scatter of its
    partial sums where "model" splits the heads or the sequence."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = h.device_mesh
    B, S, _ = h.shape
    H, K = cfg.n_heads, cfg.n_kv_heads
    positions = torch.arange(S, device=h.device)[None, :]
    q, k, v = _proj(h, p.wq), _proj(h, p.wk), _proj(h, p.wv)
    plan = flash_plan(mesh, B, S, H, K)
    heads = Shard(2) if plan == "heads" else Replicate()
    k, v = (_placed_for_flash(t, mesh, heads) for t in (k, v))
    k, v = _normed(k, p.k_norm, positions, cfg), v.contiguous()
    if plan == "sequence":
        return _on_sequence(p, x, q, k, v, cfg, window, causal, plain), k, v
    q = _normed(_placed_for_flash(q, mesh, Replicate() if plan == "replicated" else Shard(2)),
                p.q_norm, positions, cfg)
    ka, va = (_device_kv_head(t, H) for t in (k, v)) if plan == "kv_heads" else (k, v)
    out = _self_attention(q, ka, va, cfg, window, causal, plain)
    return _out(x, out, p.wo), k, v


def _device_kv_head(t, H: int):
    """k or v [B, S, K, hd], whole over "model", as the flash op takes it
    against q split over "model" by its heads where each device's heads
    read one KV head: [B, S, M, hd] split over "model", device r's block
    its KV head (r * (H / M)) // (H / K) (the KV heads repeated, each as
    many times as devices read it)."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    m = mesh.mesh_dim_names.index("model")
    M, r = mesh.size(m), mesh.get_local_rank(m)
    j = r * (H // M) // (H // t.shape[2])
    places = list(t.placements)
    places[m] = Shard(2)
    return common.from_local(t.to_local()[:, :, j:j + 1].contiguous(), mesh, places,
                             (t.shape[0], t.shape[1], M, t.shape[3]))


def _on_sequence(p: AttnParams, x, q, k, v, cfg, window: int, causal: bool, plain: bool):
    """x + the attention of q [B, S, H, hd] (as ``_proj`` made it) over k and v
    (whole over "model", normed), with "model" splitting the queries:
    device r's blocks r and 2M - 1 - r (``sequence_blocks``) reduced onto
    it by one reduce-scatter (sliced where q is whole), normed and rotated
    there, each attended as a query block at its offset against the keys;
    then its rows' output projection (``wo`` gathered whole) and one
    all-gather of the products back to the rows' layout."""
    from torch.distributed.tensor import Replicate

    mesh = q.device_mesh
    m = mesh.mesh_dim_names.index("model")
    M, r = mesh.size(m), mesh.get_local_rank(m)
    B, S, H, hd = q.shape
    group = mesh.get_group(m).group_name
    c10d = torch.ops._c10d_functional
    model = q.placements[m]
    q = _placed_for_flash(q, mesh, model if model.is_partial() else Replicate())
    ql = q.to_local()
    b, Bl = S // (2 * M), ql.shape[0]
    blocks = ql.view(Bl, 2 * M, b, H, hd).transpose(0, 1)  # [2M, Bl, b, H, hd]
    if model.is_partial():
        order = [j for i in range(M) for j in (i, 2 * M - 1 - i)]  # member i's pair at 2i
        ql = c10d.wait_tensor(c10d.reduce_scatter_tensor(
            blocks[order].view(M, 2 * Bl * b, H, hd), "sum", M, group)).view(2, Bl, b, H, hd)
    else:
        ql = blocks[[r, 2 * M - 1 - r]]
    del q, blocks
    kl, vl = k.to_local(), v.to_local()
    kw = dict(causal=causal, window=window if causal else 0, softcap=cfg.attn_softcap)
    wo = common.whole(p.wo).reshape(H * hd, -1)
    scale = common.whole(p.q_norm) if cfg.qk_norm else None
    ys = []
    for j, (start, n) in enumerate(sequence_blocks(S, M, r)):
        pos = torch.arange(start, start + n, device=ql.device)[None, :]
        qj = _normed(ql[j], scale, pos, cfg)
        if plain:
            out = fa.flash_attention_torch(qj, kl, vl, q_offset=start, **kw)
        else:
            out = ops.flash_attention(qj, kl, vl, q_offset=start, **kw)
        ys.append(out.reshape(Bl, n, H * hd) @ wo)
    got = c10d.wait_tensor(c10d.all_gather_into_tensor(torch.stack(ys), M, group))
    back = [2 * t if t < M else 2 * (2 * M - 1 - t) + 1 for t in range(2 * M)]
    y = got.view(2 * M, Bl, b, -1)[back].transpose(0, 1).reshape(Bl, S, -1)
    return x + common.from_local(y, mesh, common.batch_placements(mesh, B), x.shape)


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
    if kv_override is None and common.is_dtensor(h) and not common.records(
            h, *p.parameters()):
        return _sharded_self_attention(p, x, h, cfg, window, is_causal)[0]
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
    if common.is_dtensor(h):  # the cache keeps k and v as laid out for the kernel
        y, k, v = _sharded_self_attention(p, x, h, cfg, window, True, plain)
    else:
        q, k, v = _qkv(p, h, positions, cfg)
        y = _out(x, _self_attention(q, k, v, cfg, window, True, plain), p.wo)
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
