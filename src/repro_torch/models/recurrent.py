"""Recurrent sequence mixers, mirroring ``repro.models.recurrent``: mLSTM
and sLSTM (xLSTM) and RG-LRU (Griffin / RecurrentGemma).

  mLSTM  a matrix-memory cell with exponential gating, run chunkwise
         parallel over 256-token chunks (products against a decay matrix
         inside a chunk, the state (C, n) carried across chunks).  A
         sequence must be shorter than a chunk or a whole number of them.
         The JAX package's scale quirk is kept: inside a chunk hd ** -0.5
         scales the intra-chunk scores only, not the carried-state term
         q . C0 nor the denominator |q . n_t|; decode scales q in both.
  sLSTM  a scalar cell whose hidden state feeds back through the gates:
         not associative, so a loop over time (``lax.scan`` in the JAX
         package).
  RG-LRU a diagonal linear recurrence with input-dependent gates, run as
         a log-depth Hillis-Steele scan over (a, b) pairs, where the JAX
         package runs ``lax.associative_scan``: ceil(log2(S + 1))
         elementwise passes in float32, the sums in another order.

Decode updates O(1)-size states.  Caches are NamedTuples with the JAX
package's field names and layouts.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import common

MLSTM_CHUNK = 256
_RGLRU_C = 8.0


def _ones(shape) -> common.Field:
    return common.Field(tuple(shape), "ones", f32=True)


def _proj(x, w):
    """x [B, S, P] @ w [P, H, hd] -> [B, S, H, hd]."""
    y = common.matmul(x, common.merge_ready(w, 1, -1).reshape(w.shape[0], -1))
    return common.fenced(common.split_ready(y, -1, w.shape[1]).unflatten(-1, w.shape[1:]))


# ----------------------------------------------------------------- conv1d
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, prev: torch.Tensor | None = None):
    """Depthwise causal conv.  x: [B, S, C], w: [W, C]; ``prev`` [B, W-1, C]
    carries the last inputs in (decode).  Returns (y, new prev); the taps
    are added in order, as the JAX package's ``sum``."""
    W, S = w.shape[0], x.shape[1]
    if prev is None:
        prev = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    xp = torch.cat([prev, x], dim=1)  # [B, S+W-1, C]
    y = xp[:, :S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    return y, xp[:, -(W - 1):].clone()


# ------------------------------------------------------------------ mLSTM
class MLSTMParams(common.ParamModule):
    """ln [D]; w_up, w_gate [D, P]; conv_w [W, P]; wq, wk, wv [P, H, hd];
    w_if [P, 2H] (input and forget gates); gn [H, hd] (group norm,
    float32); w_down [P, D]."""

    FIELDS = ("ln", "w_up", "w_gate", "conv_w", "wq", "wk", "wv", "w_if", "gn", "w_down")


class MLSTMCache(NamedTuple):
    C: torch.Tensor  # [B, H, hd, hd] f32
    n: torch.Tensor  # [B, H, hd] f32
    conv: torch.Tensor  # [B, W-1, P]


def _mlstm_dims(cfg):
    P = int(cfg.mlstm_proj_factor * cfg.d_model)
    return P, cfg.n_heads, P // cfg.n_heads


def mlstm_shapes(cfg) -> dict:
    D, W = cfg.d_model, cfg.conv1d_width
    P, H, hd = _mlstm_dims(cfg)
    dense = common.dense
    return {"ln": common.norm((D,)), "w_up": dense((D, P), D), "w_gate": dense((D, P), D),
            "conv_w": dense((W, P), W), "wq": dense((P, H, hd), P),
            "wk": dense((P, H, hd), P), "wv": dense((P, H, hd), P),
            "w_if": dense((P, 2 * H), P), "gn": _ones((H, hd)), "w_down": dense((P, D), P)}


def mlstm_cache_init(cfg, batch: int, dtype, device=None) -> MLSTMCache:
    P, H, hd = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(C=torch.zeros((batch, H, hd, hd), **f32),
                      n=torch.zeros((batch, H, hd), **f32),
                      conv=torch.zeros((batch, cfg.conv1d_width - 1, P), dtype=dtype,
                                       device=device))


def _gate_values(g):
    """i (clamped exp) and log-f (log-sigmoid) gates [B, S, H] of the
    pre-activations g [B, S, 2H], float32."""
    H = g.shape[-1] // 2
    return torch.exp(torch.clamp(g[..., :H], max=8.0)), common.log_sigmoid(g[..., H:])


def _mlstm_gates(uc, p: MLSTMParams):
    """``_gate_values`` of uc @ w_if.  On DTensors the product runs on each
    device's rows with the whole weight (``common.on_rows``): its 2H
    columns do not split over "model", and DTensor would split the rows
    there, merged with the batch into a strided shard by the next
    product."""
    return _gate_values(common.on_rows(torch.matmul, (uc,), (p.w_if,)).to(torch.float32))


def _chunk_end(C0, n0, k, v, i, b):
    """The state (C1, n1) at the end of a chunk from (C0, n0), b its
    cumulative log-decay [B, L, H]."""
    bL = b[:, -1]  # [B, H]
    kdec = torch.exp(bL[:, None] - b)[..., None] * (i[..., None] * k)  # [B, L, H, hd]
    C1 = torch.exp(bL)[..., None, None] * C0 + torch.einsum("blhk,blhv->bhkv", kdec, v)
    n1 = torch.exp(bL)[..., None] * n0 + kdec.sum(1)
    return C1, n1


def _mlstm_chunk(C0, n0, q, k, v, i, logf, scale: float):
    """One chunk: (C1, n1, h).  C0 [B, H, k, v], n0 [B, H, k]; q, k, v
    [B, L, H, hd] and i, logf [B, L, H], float32."""
    b = torch.cumsum(logf, dim=1)  # [B, L, H] cumulative log-decay
    L = q.shape[1]
    # decay matrix D[t, s] = exp(b_t - b_s) * i_s for s <= t
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    dmat = b[:, :, None, :] - b[:, None, :, :]  # [B, t, s, H]
    dmat = torch.where(tri, torch.exp(dmat) * i[:, None, :, :], 0.0)
    scores = torch.einsum("bthd,bshd->btsh", q, k) * scale * dmat
    intra = torch.einsum("btsh,bshd->bthd", scores, v)
    eb = torch.exp(b)[..., None]
    inter = eb * torch.einsum("bthd,bhdk->bthk", q, C0)
    n_t = eb * n0[:, None] + torch.einsum("btsh,bshd->bthd", dmat, k)
    denom = torch.clamp(torch.abs(torch.einsum("bthd,bthd->bth", q, n_t)), min=1.0)
    h = (intra + inter) / denom[..., None]  # [B, L, H, hd]
    return (*_chunk_end(C0, n0, k, v, i, b), h)


def _mlstm_scan(q, k, v, i, logf, C0, n0, scale: float):
    """The chunks in order from the state (C0, n0): (h [B, S, H, hd], C1,
    n1)."""
    S = q.shape[1]
    L = min(MLSTM_CHUNK, S)
    C1, n1, hs = C0, n0, []
    for c in range(0, S, L):
        C1, n1, hc = _mlstm_chunk(C1, n1, *(t[:, c:c + L] for t in (q, k, v, i, logf)), scale)
        hs.append(hc)
    return torch.cat(hs, dim=1), C1, n1


def mlstm_run_end(k, v, i, logf):
    """A run of whole chunks from the zero state: its end state (C, n) and
    its total log-decay F [B, H] (the sum of its chunks' last cumulative
    log-decays), the same chunk by chunk as ``_mlstm_scan``.  The state at
    the run's end from any (C0, n0) is then (e^F C0 + C, e^F n0 + n)."""
    S = k.shape[1]
    L = min(MLSTM_CHUNK, S)
    B, _, H, hd = k.shape
    C = k.new_zeros((B, H, hd, hd))
    n, F = k.new_zeros((B, H, hd)), k.new_zeros((B, H))
    for c in range(0, S, L):
        b = torch.cumsum(logf[:, c:c + L], dim=1)
        C, n = _chunk_end(C, n, k[:, c:c + L], v[:, c:c + L], i[:, c:c + L], b)
        F = F + b[:, -1]
    return C, n, F


def mlstm_carry(C0, n0, runs):
    """The state entering the run after ``runs`` (each ``mlstm_run_end``'s
    (C, n, F), in sequence order) from the state (C0, n0) before them: the
    carry is linear in the state, so each run's own end state is added to
    the decayed carry, exact up to summation order."""
    C, n = C0, n0
    for Cj, nj, Fj in runs:
        e = torch.exp(Fj)
        C = e[..., None, None] * C + Cj
        n = e[..., None] * n + nj
    return C, n


def mlstm_compose(a, b):
    """The run a followed by the run b, each (C, n, F) as ``mlstm_run_end``
    gives it: (e^Fb C_a + C_b, e^Fb n_a + n_b, F_a + F_b).  Associative, so
    that runs compose in any grouping (up to summation order)."""
    Ca, na, Fa = a
    Cb, nb, Fb = b
    e = torch.exp(Fb)
    return e[..., None, None] * Ca + Cb, e[..., None] * na + nb, Fa + Fb


def _exchange(t, peer: int, M: int, group: str):
    """``t`` sent to member ``peer`` of the mesh dim's group of M, and what
    ``peer`` sends back (a pairwise exchange, as one all-to-all)."""
    c10d = torch.ops._c10d_functional
    split = [t.numel() if j == peer else 0 for j in range(M)]
    return c10d.wait_tensor(c10d.all_to_all_single(t.reshape(-1), split, split, group))


def mlstm_prefix(run, M: int, r: int, group: str):
    """(the runs of members 0 .. r - 1 composed, or ``None`` for member 0;
    every member's run composed), for member r of M (a power of two) whose
    own run is ``run`` (``mlstm_run_end``'s (C, n, F)): log2(M) rounds of
    a pairwise exchange, member r with r XOR d, each sending the runs its
    half has composed so far (the recursive-doubling scan), where gathering
    every member's end state would move M of them to each."""
    shapes = [t.shape for t in run]
    sizes = [t.numel() for t in run]
    prefix, total, d = None, run, 1
    while d < M:
        peer = r ^ d
        got = _exchange(torch.cat([t.reshape(-1) for t in total]), peer, M, group)
        theirs = tuple(a.view(sh) for a, sh in zip(got.split(sizes), shapes))
        if peer < r:
            prefix = theirs if prefix is None else mlstm_compose(theirs, prefix)
            total = mlstm_compose(theirs, total)
        else:
            total = mlstm_compose(total, theirs)
        d *= 2
    return prefix, total


def _sequence_split(t, S: int):
    """The index of the "model" mesh dim over which a DTensor prefill's
    mLSTM and sLSTM split the sequence, or ``None`` (a plain tensor; no
    "model" dim of more than one member, or of a size not a power of two;
    or S / its size not a whole number of 256-token chunks).  Chunks start
    at multiples of 256 from position 0, and the reference's scale quirk
    makes a chunk's output depend on where it starts, so a split that would
    cut a chunk between ranks is never taken: the rows path runs instead."""
    if not common.is_dtensor(t):
        return None
    names = t.device_mesh.mesh_dim_names
    if "model" not in names:
        return None
    m = names.index("model")
    n = t.device_mesh.size(m)
    return m if n > 1 and not n & (n - 1) and S % (n * MLSTM_CHUNK) == 0 else None


def _sequence_layouts(x, m: int):
    """(the rows' placements, the sequence's: the rows' with "model" mesh dim
    ``m`` splitting dim 1) of the stream x [B, S, D]."""
    from torch.distributed.tensor import Shard

    rows = common.batch_placements(x.device_mesh, x.shape[0])
    seq = list(rows)
    seq[m] = Shard(1)
    return rows, seq


def _own_tokens(x, m: int):
    """This member's contiguous S / M tokens of the stream x [B, S, D] as a
    local tensor [B_local, S / M, D]: sliced where x is whole over "model"
    (the rows' layout), as it is where x comes split over the sequence."""
    mesh = x.device_mesh
    rows, seq = _sequence_layouts(x, m)
    if list(x.placements) == seq:
        return x.to_local()
    M, r = mesh.size(m), mesh.get_local_rank(m)
    n = x.shape[1] // M
    return common.laid_out(x, mesh, rows).to_local()[:, r * n:(r + 1) * n]


def _mlstm_on_sequence(p: MLSTMParams, x, cache, m: int, scale: float):
    """The mLSTM's prefill on DTensors split over the sequence on "model"
    (mesh dim ``m``, of M members): each member runs its own contiguous S /
    M tokens (whole chunks) through the whole block, with the weights
    gathered whole (the products each token's whole dot products, as on
    one device, where partial sums over "model" would move the mLSTM's
    inputs by a rounding each: its gates and denominators turn a relative
    1e-7 there into 1e-4 of the logits at 512 tokens).  The causal conv
    takes the previous member's last W - 1 inputs (one small all-gather
    of each member's); each member's run of chunks from the zero state
    (``mlstm_run_end``) is composed with the others' by ``mlstm_prefix``,
    and it scans its chunks from the carry of the runs before it.  The
    stream stays split over the sequence (the next block takes it so).  The
    states after the last token, on every member, are written into the
    storage of the cache's (``cache``: the prefill's working cache, laid
    out as the rows).  Returns (x + out, the new cache, laid out as the
    rows)."""
    mesh = x.device_mesh
    M, r = mesh.size(m), mesh.get_local_rank(m)
    rows, seq = _sequence_layouts(x, m)
    group = mesh.get_group(m).group_name
    c10d = torch.ops._c10d_functional
    xl = _own_tokens(x, m)
    Bl, n = xl.shape[:2]
    h_in = common.rms_norm(xl, common.whole(p.ln))
    u, z = h_in @ common.whole(p.w_up), h_in @ common.whole(p.w_gate)
    W = p.conv_w.shape[0]
    tails = c10d.wait_tensor(c10d.all_gather_into_tensor(
        u[:, n - (W - 1):].contiguous(), M, group)).view(M, Bl, W - 1, -1)
    C0, n0, conv = (common.laid_out(t, mesh, rows).to_local() for t in cache)
    uc, _ = causal_conv1d(u, common.whole(p.conv_w), tails[r - 1] if r else conv)
    uc = F.silu(uc)
    wq, wk, wv = (common.whole(w) for w in (p.wq, p.wk, p.wv))
    P, H, hd = wq.shape
    q, k, v = ((t @ w.reshape(P, -1)).view(Bl, n, H, hd).to(torch.float32)
               for t, w in ((uc, wq), (uc, wk), (u, wv)))
    i, logf = _gate_values(torch.matmul(uc, common.whole(p.w_if)).to(torch.float32))
    before, total = mlstm_prefix(mlstm_run_end(k, v, i, logf), M, r, group)
    Cr, nr = mlstm_carry(C0, n0, [] if before is None else [before])
    h, _, _ = _mlstm_scan(q, k, v, i, logf, Cr, nr, scale=scale)
    C1, n1 = mlstm_carry(C0, n0, [total])
    C0.copy_(C1)  # the working cache's storage: no second copy of the states is kept
    n0.copy_(n1)
    conv.copy_(tails[M - 1])
    h = common.rms_norm(h.to(x.dtype), common.whole(p.gn) - 1.0)  # per-head group norm
    y = (h.reshape(Bl, n, -1) * F.silu(z)) @ common.whole(p.w_down)
    return (common.from_local(xl + y, mesh, seq, x.shape),
            MLSTMCache(*(common.from_local(t, mesh, rows, c.shape)
                         for t, c in zip((C0, n0, conv), cache))))


def mlstm_apply(p: MLSTMParams, x, cfg, cache: MLSTMCache | None = None,
                decode: bool = False):
    """Full-sequence (chunkwise) or single-step (decode) mLSTM block;
    returns (x + out, new cache).  A full sequence of S tokens needs S <
    256 or S % 256 == 0 (``ValueError`` otherwise).  A DTensor prefill
    whose S splits into whole chunks over "model" (``_sequence_split``),
    where autograd does not record, runs ``_mlstm_on_sequence``; else each
    device runs its own rows' chunks (``common.on_rows``)."""
    B, S, D = x.shape
    dt = x.dtype
    H, hd = p.wq.shape[1], p.wq.shape[2]
    scale = hd ** -0.5
    m = (None if decode or cache is None or common.records(x, *p.parameters())
         else _sequence_split(x, S))
    if m is not None:
        with common.span("recurrent.mlstm"):
            return _mlstm_on_sequence(p, x, cache, m, scale)
    x = common.batch_layout(x)
    h_in = common.rms_norm(x, p.ln)
    u = common.matmul(h_in, p.w_up)
    z = common.matmul(h_in, p.w_gate)
    uc, conv_new = causal_conv1d(u, p.conv_w, cache.conv if cache is not None else None)
    uc = F.silu(uc)
    if cache is not None:
        C0, n0 = cache.C, cache.n
    else:
        C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    q = _proj(uc, p.wq).to(torch.float32)
    k = _proj(uc, p.wk).to(torch.float32)
    v = _proj(u, p.wv).to(torch.float32)
    i, logf = _mlstm_gates(uc, p)

    with common.span("recurrent.mlstm"):
        if decode:  # S == 1
            f1 = torch.exp(logf[:, 0])  # [B, H]
            ik = i[:, 0, :, None] * k[:, 0]  # [B, H, hd]
            C1 = f1[..., None, None] * C0 + ik[..., :, None] * v[:, 0][..., None, :]
            n1 = f1[..., None] * n0 + ik
            qs = q[:, 0] * scale
            num = torch.einsum("bhd,bhdk->bhk", qs, C1)
            den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", qs, n1)), min=1.0)
            h = (num / den[..., None])[:, None]  # [B, 1, H, hd]
        else:
            if S % min(MLSTM_CHUNK, S):
                raise ValueError(f"the mLSTM runs {S} tokens in chunks of {MLSTM_CHUNK}: "
                                 "a sequence must be shorter than a chunk or a multiple of it")
            # on DTensors each device runs its own rows' chunks (common.on_rows)
            h, C1, n1 = common.on_rows(functools.partial(_mlstm_scan, scale=scale),
                                       (q, k, v, i, logf, C0, n0), ())
    h = common.rms_norm(h.to(dt), p.gn - 1.0)  # per-head group norm
    out = common.fenced(common.merge_ready(h, 2, 3).reshape(B, S, -1)) * F.silu(z)
    return x + common.matmul(out, p.w_down), MLSTMCache(C=C1, n=n1, conv=conv_new)


# ------------------------------------------------------------------ sLSTM
class SLSTMParams(common.ParamModule):
    """ln [D]; w [D, H, 4, hd] (i, f, z, o projections); r [H, hd, 4, hd]
    (recurrent, per head) and b [H, 4, hd], float32; gn [H, hd]; w_up1,
    w_up2 [D, F], w_down [F, D] (the gated FFN after the cell)."""

    FIELDS = ("ln", "w", "r", "b", "gn", "w_up1", "w_up2", "w_down")


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # [B, H, hd] f32
    n: torch.Tensor  # [B, H, hd] f32
    h: torch.Tensor  # [B, H, hd] f32
    m: torch.Tensor  # [B, H, hd] f32 stabilizer


def slstm_shapes(cfg) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H
    Ff = int(cfg.slstm_proj_factor * D)
    dense = common.dense
    return {"ln": common.norm((D,)), "w": dense((D, H, 4, hd), D),
            "r": dense((H, hd, 4, hd), D // H, f32=True),
            "b": common.Field((H, 4, hd), "zeros", f32=True), "gn": _ones((H, hd)),
            "w_up1": dense((D, Ff), D), "w_up2": dense((D, Ff), D), "w_down": dense((Ff, D), Ff)}


def slstm_cache_init(cfg, batch: int, dtype=None, device=None) -> SLSTMCache:
    H = cfg.n_heads
    hd = cfg.d_model // H

    def z():
        return torch.zeros((batch, H, hd), dtype=torch.float32, device=device)
    return SLSTMCache(c=z(), n=z(), h=z(), m=z() - 10.0)


def _slstm_cell(state: SLSTMCache, gx, r) -> SLSTMCache:
    """gx [B, H, 4, hd]: the input's pre-activations; r [H, hd, 4 * hd]."""
    c, n, h, m = state
    B, H, _, hd = gx.shape
    hr = common.split_ready(torch.bmm(h.transpose(0, 1), r), 2, 4)
    g = gx + hr.transpose(0, 1).view(B, H, 4, hd)
    it, ft, zt, ot = g.unbind(2)
    logf = common.log_sigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(zt)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1.0)
    return SLSTMCache(c=c_new, n=n_new, h=h_new, m=m_new)


def _slstm_scan(gx, c, n, h, m, r, b=None):
    """The loop over time: (h at every step [B, S, H, hd], the last state).
    With ``b`` gx holds the products in the compute dtype, each step's taken
    to float32 and b added as it is read (the same numbers as adding b to
    the whole float32 gx, of which no copy is then held)."""
    state, hs = SLSTMCache(c=c, n=n, h=h, m=m), []
    for t in range(gx.shape[1]):  # decode: S == 1
        g = gx[:, t] if b is None else gx[:, t].to(torch.float32) + b
        state = _slstm_cell(state, g, r)
        hs.append(state.h)
    return torch.stack(hs, dim=1), state


def _slstm_ffn(hs, w_up1, w_up2, w_down):
    """The gated FFN after the cell."""
    return (F.silu(hs @ w_up1) * (hs @ w_up2)) @ w_down


def _slstm_on_sequence(p: SLSTMParams, x, cache, m: int):
    """The sLSTM's prefill on DTensors where the stream splits over the
    sequence on "model" (mesh dim ``m``, of M members; ``_sequence_split``).
    Only its loop runs over time; the gate product and the FFN act on each
    position alone.  So each member takes the gate product of its own S /
    M tokens with the whole weight, one all-gather over "model" makes the
    products whole in the compute dtype (never the float32 gate inputs),
    every member runs the loop over its data rank's rows (each step's
    inputs taken to float32 with the bias as read), and the group norm and
    the FFN (whole weights) run on its own tokens: the stream stays split
    over the sequence.  Returns (x + out, the state after the last token,
    laid out as the rows)."""
    mesh = x.device_mesh
    _, S, D = x.shape
    M, r = mesh.size(m), mesh.get_local_rank(m)
    rows, seq = _sequence_layouts(x, m)
    group = mesh.get_group(m).group_name
    c10d = torch.ops._c10d_functional
    xl = _own_tokens(x, m)
    Bl, n = xl.shape[:2]
    w = common.whole(p.w)
    H, hd = w.shape[1], w.shape[3]
    gx = common.rms_norm(xl, common.whole(p.ln)) @ w.reshape(D, -1)  # [Bl, n, 4 H hd]
    every = c10d.wait_tensor(c10d.all_gather_into_tensor(gx, M, group))
    gx = every.view(M, Bl, n, -1).transpose(0, 1).reshape(Bl, S, H, 4, hd)
    del every
    rr = common.whole(p.r).reshape(H, hd, 4 * hd)
    state = (common.laid_out(t, mesh, rows).to_local() for t in cache)
    with common.span("recurrent.slstm"):
        hs, state = _slstm_scan(gx, *state, rr, common.whole(p.b))
    del gx
    hs = common.rms_norm(hs[:, r * n:(r + 1) * n].to(x.dtype), common.whole(p.gn) - 1.0)
    ffn = (common.whole(t) for t in (p.w_up1, p.w_up2, p.w_down))
    y = _slstm_ffn(hs.reshape(Bl, n, D), *ffn)
    return (common.from_local(xl + y, mesh, seq, x.shape),
            SLSTMCache(*(common.from_local(t, mesh, rows, c.shape)
                         for t, c in zip(state, cache))))


def slstm_apply(p: SLSTMParams, x, cfg, cache: SLSTMCache | None = None,
                decode: bool = False):
    """The sLSTM block: the gate product, the loop over time and the gated
    FFN; returns (x + out, new cache).  A DTensor prefill whose stream
    splits over the sequence (``_sequence_split``), where autograd does not
    record, runs ``_slstm_on_sequence``; else each device runs its own
    rows' loop (``common.on_rows``)."""
    B, S, D = x.shape
    m = (None if decode or cache is None or common.records(x, *p.parameters())
         else _sequence_split(x, S))
    if m is not None:
        return _slstm_on_sequence(p, x, cache, m)
    x = common.batch_layout(x)
    dt = x.dtype
    h_in = common.rms_norm(x, p.ln)
    H, hd = p.r.shape[0], p.r.shape[1]
    gx = common.matmul(h_in, common.merge_ready(p.w, 1, -1).reshape(D, -1))
    gx = common.split_ready(gx.to(torch.float32), -1, H).view(B, S, *p.w.shape[1:])
    # the batch's layout before the bias (torch 2.11's DTensor cannot add a
    # sharded bias to a partial sum)
    gx = common.batch_layout(common.fenced(gx)) + p.b
    r = common.merge_ready(p.r, 2, 3).reshape(H, hd, 4 * hd)
    state = cache if cache is not None else slstm_cache_init(cfg, B, device=x.device)
    with common.span("recurrent.slstm"):
        # on DTensors each device runs its own rows' loop (common.on_rows)
        hs, state = common.on_rows(_slstm_scan, (gx, *state), (r,))
    hs = common.batch_layout(hs)
    hs = common.rms_norm(hs.to(dt), p.gn - 1.0)
    hs = common.fenced(common.merge_ready(hs, 2, 3).reshape(B, S, D))
    # on DTensors each device runs its own rows through the whole weights
    # (common.on_rows): F = 2,730 does not split over "model", and DTensor
    # would split the rows there, which the next product merges with the
    # batch into a strided shard
    return x + common.on_rows(_slstm_ffn, (hs,), (p.w_up1, p.w_up2, p.w_down)), state


# ------------------------------------------------------------------ RG-LRU
class RGLRUParams(common.ParamModule):
    """ln [D]; w_in, w_gate [D, R]; conv_w [W, R]; w_rg, w_ig [R, R]
    (recurrence and input gates); lam [R] (Lambda, float32); w_out [R, D]."""

    FIELDS = ("ln", "w_in", "w_gate", "conv_w", "w_rg", "w_ig", "lam", "w_out")


class RGLRUCache(NamedTuple):
    h: torch.Tensor  # [B, R] f32
    conv: torch.Tensor  # [B, W-1, R]


def rglru_shapes(cfg) -> dict:
    D, W = cfg.d_model, cfg.conv1d_width
    R = cfg.rglru_width or D
    dense = common.dense
    return {"ln": common.norm((D,)), "w_in": dense((D, R), D), "w_gate": dense((D, R), D),
            "conv_w": dense((W, R), W), "w_rg": dense((R, R), R), "w_ig": dense((R, R), R),
            "lam": common.Field((R,), "lam", f32=True), "w_out": dense((R, D), R)}


def rglru_cache_init(cfg, batch: int, dtype, device=None) -> RGLRUCache:
    R = cfg.rglru_width or cfg.d_model
    return RGLRUCache(h=torch.zeros((batch, R), dtype=torch.float32, device=device),
                      conv=torch.zeros((batch, cfg.conv1d_width - 1, R), dtype=dtype,
                                       device=device))


def _gated(rg, ig, xc, lam):
    """a_t, b_t of h_t = a_t h + b_t [B, S, R], float32, from the gates'
    pre-activations rg, ig (xc @ w_rg, xc @ w_ig), xc and Lambda: channel
    by channel."""
    rg = torch.sigmoid(rg.to(torch.float32))
    ig = torch.sigmoid(ig.to(torch.float32))
    log_a = -_RGLRU_C * rg * F.softplus(lam)  # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * ig \
        * xc.to(torch.float32)
    return a, b


def _rglru_coeffs(xc, p: RGLRUParams):
    """a_t, b_t of h_t = a_t h + b_t [B, S, R], float32."""
    return _gated(common.matmul(xc, p.w_rg), common.matmul(xc, p.w_ig), xc, p.lam)


def _scan_passes(a, b, h0):
    """The log-depth passes of ``linear_scan``, each one fused multiply-add
    into the other of two buffers (no autograd).  Returns h [B, S, R]."""
    A = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
    Bv = torch.cat([h0[:, None], b], dim=1)
    n, d = A.shape[1], 1
    A2, B2 = torch.empty_like(A), torch.empty_like(Bv)
    while d < n:
        B2[:, :d] = Bv[:, :d]
        torch.addcmul(Bv[:, d:], A[:, d:], Bv[:, :-d], out=B2[:, d:])
        Bv, B2 = B2, Bv
        if 2 * d < n:
            A2[:, :d] = A[:, :d]
            torch.mul(A[:, :-d], A[:, d:], out=A2[:, d:])
            A, A2 = A2, A
        d *= 2
    return Bv[:, 1:]


class _LinearScan(torch.autograd.Function):
    """``_scan_passes`` with its gradient by the reverse recurrence: for
    g_t = dL/dh_t through the whole sequence, g_t = dh_t + a_{t+1} g_{t+1}
    (the same scan run backwards in time), db_t = g_t, da_t = g_t h_{t-1},
    dh0 = a_1 g_1.  It keeps a and h (and h0) for the backward, where
    autograd through the passes keeps two buffers a pass."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _scan_passes(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        g = _scan_passes(a_next.flip(1), dh.flip(1), torch.zeros_like(h0)).flip(1)
        da = g * torch.cat([h0[:, None], h[:, :-1]], dim=1) if ctx.needs_input_grad[0] else None
        dh0 = a[:, 0] * g[:, 0] if ctx.needs_input_grad[2] else None
        return da, g, dh0


def linear_scan(a, b, h0):
    """h_t = a_t h_{t-1} + b_t over axis 1, from h0 [B, R]: the carry as a
    pseudo-step (a = 1, b = h0) ahead of the sequence, then Hillis-Steele
    over the pairs, ceil(log2(S + 1)) passes of (a_l, b_l) . (a_r, b_r) =
    (a_l a_r, a_r b_l + b_r).  Where autograd records, the same passes
    with the reverse recurrence as their gradient (``_LinearScan``).
    Returns h [B, S, R]."""
    if common.records(a, b, h0):
        return _LinearScan.apply(a, b, h0)
    return _scan_passes(a, b, h0)


def _channel_split(t, R: int):
    """The index of the "model" mesh dim over which a DTensor RG-LRU splits
    its R channels, or ``None`` (a plain tensor; no "model" dim of more
    than one member; or R not a multiple of its size): the rows path runs
    instead."""
    if not common.is_dtensor(t):
        return None
    names = t.device_mesh.mesh_dim_names
    if "model" not in names:
        return None
    m = names.index("model")
    n = t.device_mesh.size(m)
    return m if n > 1 and R % n == 0 else None


def _rglru_on_channels(p: RGLRUParams, x, hx, cache: RGLRUCache | None, m: int):
    """The RG-LRU's full sequence on DTensors split over "model" (mesh dim
    ``m``) on its R channels, each device on its own rows (the residual
    stream's layout) and R / M channels.  The recurrence is diagonal in its
    channels, so the conv, the gates and the scan send nothing.  The four
    products that feed it take their weight's columns (w_in, w_gate, w_rg,
    w_ig, each moved from "model" on its input dim to "model" on its
    output dim: an all-to-all of the weight's block, its gradient moved
    back so), so that each product is an R-split output computed once,
    not a whole-width partial sum over "model"; w_rg and w_ig read xc
    whole over "model" (one all-gather, its gradient a reduce-scatter).
    The output returns through ``w_out`` the same way: gathered whole over
    "model" against the weight's columns, a D-split product (a partial
    sum over "model" would be saved at the whole width).  Returns (x +
    out, the cache: h and conv laid out as the channels)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    B, S, _ = x.shape
    R, W = p.w_in.shape[-1], p.conv_w.shape[0]
    rows = common.batch_placements(mesh, B)

    def split(dim, base=rows):  # ``base`` with "model" on ``dim``
        out = list(base)
        out[m] = Shard(dim)
        return out

    whole = [Replicate()] * mesh.ndim

    def cols(w):
        return common.laid_out(w, mesh, split(1, whole))

    chans = split(2)
    gate = F.gelu(common.matmul(hx, cols(p.w_gate)), approximate="tanh")
    xin = common.matmul(hx, cols(p.w_in))
    if cache is not None:
        prev = common.laid_out(cache.conv, mesh, chans)
    else:
        local = xin.to_local()
        prev = common.from_local(local.new_zeros((local.shape[0], W - 1, local.shape[2])),
                                 mesh, chans, (B, W - 1, R))
    xc, conv_new = causal_conv1d(xin, common.laid_out(p.conv_w, mesh, split(1, whole)), prev)
    xw = common.gathered_on(xc, (2,))
    rg, ig = common.matmul(xw, cols(p.w_rg)), common.matmul(xw, cols(p.w_ig))
    # Lambda's gradient: a partial sum over the dims that split the rows
    lam = common.laid_out(p.lam, mesh, split(0, whole)).to_local(
        grad_placements=split(0, [Partial() if r.is_shard() else Replicate() for r in rows]))
    local = [t.to_local() for t in (rg, ig, xc)]
    if cache is not None:
        h0 = common.laid_out(cache.h, mesh, split(1)).to_local()
    else:
        h0 = local[0].new_zeros((local[0].shape[0], local[0].shape[2]), dtype=torch.float32)
    with common.span("recurrent.rglru"):
        hs = linear_scan(*_gated(*local, lam), h0)
    hs = common.from_local(hs, mesh, chans, (B, S, R))
    out = common.gathered_on(hs.to(x.dtype) * gate, (2,))
    y = common.batch_layout(common.matmul(out, cols(p.w_out)))
    return x + y, RGLRUCache(h=hs[:, -1].clone(), conv=conv_new)


def rglru_apply(p: RGLRUParams, x, cfg, cache: RGLRUCache | None = None,
                decode: bool = False):
    """Full-sequence (the log-depth scan) or single-step (decode) RG-LRU
    block; returns (x + out, new cache).  A DTensor full sequence whose R
    channels split over "model" (``_channel_split``) runs
    ``_rglru_on_channels``; else, on DTensors, each device scans its own
    rows at the whole R (``common.on_rows``)."""
    B, S, D = x.shape
    dt = x.dtype
    hx = common.rms_norm(x, p.ln)
    m = None if decode else _channel_split(x, p.w_in.shape[-1])
    if m is not None:
        return _rglru_on_channels(p, x, hx, cache, m)
    gate = F.gelu(common.matmul(hx, p.w_gate), approximate="tanh")
    xin = common.matmul(hx, p.w_in)
    xc, conv_new = causal_conv1d(xin, p.conv_w, cache.conv if cache is not None else None)
    a, b = _rglru_coeffs(common.fenced(common.batch_layout(xc)), p)
    h0 = cache.h if cache is not None else a.new_zeros((B, a.shape[-1]))
    with common.span("recurrent.rglru"):
        # on DTensors each device scans its own rows (common.on_rows)
        hs = ((a[:, 0] * h0 + b[:, 0])[:, None] if decode
              else common.on_rows(linear_scan, (a, b, h0), ()))
    # the stream's layout before the product (its rows would otherwise merge
    # a split sequence with the batch into a strided shard)
    out = common.batch_layout(common.fenced(hs.to(dt) * gate))
    return x + common.matmul(out, p.w_out), RGLRUCache(h=hs[:, -1].clone(), conv=conv_new)
