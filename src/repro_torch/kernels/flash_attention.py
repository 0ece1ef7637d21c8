"""Causal grouped-query flash attention with an optional sliding window and
tanh softcap, as two hand-written CUDA kernels with their plain PyTorch
version.

``flash_attention`` replaces the JAX package's Pallas kernel
``kernels/flash_attention.py::flash_attention``.  On CUDA tensors it
launches one of two kernels, chosen by ``flash_route`` from the dtype and
the head dim alone:

  "wgmma"  ``csrc/flash_attention_sm90.cu``: bfloat16 at hd 64, 128 or 256
           (the repo's model widths), on the tensor cores, fed by TMA;
  "simt"   ``csrc/flash_attention.cu``: float32 at any hd, and bfloat16 at
           hd 16 or 32, on the fp32 CUDA cores.

On CPU tensors it runs ``flash_attention_torch``.  Layout, the JAX
package's: q [B, S, H, hd], k and v [B, S, K, hd] with H a multiple of K
(query head h reads KV head h // (H / K)); the output has q's dtype.  The
softmax runs in float32.  Both kernels mask a ragged edge themselves, so
S need not be a multiple of a block.  ``flash_attention.launches`` counts
every launch and ``flash_attention.route_launches`` each route's.

A query block at an offset: q [B, Sq, H, hd] against k and v [B, Sk, K,
hd] with ``q_offset`` + Sq <= Sk gives rows [q_offset, q_offset + Sq) of
the attention of Sk queries over the Sk keys (query row i at position
q_offset + i for the causal mask and the window).  A sequence split over
devices runs each device's block of queries so; ``q_offset`` = 0 and Sq =
Sk is the JAX kernel's own call, launched as it was.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30  # the finite mask value of the JAX kernel (see the CUDA source)
HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# route -> (library, C entry, its argument types)
_ENTRIES = {
    "simt": ("flash_attention", "flash_attention_launch",
             (_p,) * 4 + (_i,) * 10 + (_f,) * 2 + (_p,)),
    "wgmma": ("flash_attention_sm90", "flash_attention_sm90_launch",
              (_p,) * 4 + (_i,) * 9 + (_f,) * 2 + (_p,)),
}


def flash_route(dtype, hd: int) -> str:
    """The kernel that serves (dtype, head dim): "wgmma" for bfloat16 at the
    model widths, "simt" for the rest; raises for what neither takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "simt"


@contextlib.contextmanager
def full_fp32_matmul():
    """float32 products in full float32 (no TF32) for the duration."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def check_offset(Sq: int, Sk: int, q_offset: int) -> None:
    """A query block of Sq rows at ``q_offset`` must lie inside the Sk keys."""
    if q_offset < 0 or Sq > Sk or q_offset + Sq > Sk:
        raise ValueError(f"{Sq} query rows at offset {q_offset} do not lie inside {Sk} keys")


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, q_offset: int = 0):
    """Plain PyTorch version of the kernel, mirroring
    ``kernels/ref.py::flash_attention_ref``: the full score matrix in
    float32, in true float32 products on the card too; q's rows at
    positions ``q_offset`` on against k's and v's Sk keys."""
    B, S, H, hd = q.shape
    K, Sk = k.shape[2], k.shape[1]
    check_offset(S, Sk, q_offset)
    G = H // K
    qg = q.reshape(B, S, K, G, hd).to(torch.float32)
    with full_fp32_matmul():
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32)) * (hd ** -0.5)
        if softcap:
            scores = softcap * torch.tanh(scores / softcap)
        i = q_offset + torch.arange(S, device=q.device)[:, None]
        j = torch.arange(Sk, device=q.device)[None, :]
        mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= j <= i
        if window:
            mask &= (i - j) < window
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(torch.float32))
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """Flash attention: the CUDA kernel of ``flash_route`` for CUDA tensors,
    the plain version for CPU tensors.  It has no backward, so it refuses
    inputs that autograd records (a launch would return an output with no
    gradient); training takes the plain attention
    (``models.attention.apply_full``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward: it refuses inputs that "
                           "require grad")
    dev = q.device
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    if dev.type == "cpu":
        return flash_attention_torch(q, k, v, **kw)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {dev}")
    B, S, H, hd = q.shape
    K, Sk = k.shape[2], k.shape[1]
    route = flash_route(q.dtype, hd)
    if K < 1 or H % K:
        raise ValueError(f"{H} query heads do not split into {K} KV heads")
    if window < 0 or softcap < 0:
        raise ValueError("window and softcap must be >= 0")
    check_offset(S, Sk, q_offset)
    build.check("q", q, q.dtype, (B, S, H, hd), dev)
    build.check("k", k, q.dtype, (B, Sk, K, hd), dev)
    build.check("v", v, q.dtype, (B, Sk, K, hd), dev)
    out = torch.empty_like(q)
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("the wgmma route's TMA needs 16-byte aligned q, k and v")
    lib, name, argtypes = _ENTRIES[route]
    fn = build.entry(lib, name, argtypes)
    shape = (B, S, Sk, int(q_offset), H, K, hd, int(causal), int(window), float(softcap),
             hd ** -0.5)
    dtype = () if route == "wgmma" else (_DTYPES[q.dtype],)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dtype, *shape,
                 stream)
    build.raise_on(err, f"flash_attention ({route})")
    build.count_launch(flash_attention, flash_attention.route_launches, route)
    return out


flash_attention.launches = 0
flash_attention.route_launches = {"wgmma": 0, "simt": 0}
