"""Causal grouped-query flash attention with an optional sliding window and
tanh softcap, as a hand-written CUDA kernel with its plain PyTorch version.

``flash_attention`` launches ``csrc/flash_attention.cu`` (it replaces the
JAX package's Pallas kernel ``kernels/flash_attention.py::
flash_attention``) on CUDA tensors and runs ``flash_attention_torch`` on
CPU tensors.  Layout, the JAX package's: q [B, S, H, hd], k and v
[B, S, K, hd] with H a multiple of K (query head h reads KV head
h // (H / K)); float32 or bfloat16; the output has q's dtype.  The
softmax runs in float32.  The kernel tiles 64 queries by 64 keys and masks
a ragged edge itself, so S need not be a multiple of a block; it takes
hd in {16, 32, 64, 128, 256}.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30  # the finite mask value of the JAX kernel (see the CUDA source)
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_p,) * 4 + (_i,) * 8 + (_f,) * 2 + (_p,)


@contextlib.contextmanager
def full_fp32_matmul():
    """float32 products in full float32 (no TF32) for the duration."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0):
    """Plain PyTorch version of the kernel, mirroring
    ``kernels/ref.py::flash_attention_ref``: the full score matrix in
    float32, in true float32 products on the card too."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd).to(torch.float32)
    with full_fp32_matmul():
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32)) * (hd ** -0.5)
        if softcap:
            scores = softcap * torch.tanh(scores / softcap)
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None, :]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= j <= i
        if window:
            mask &= (i - j) < window
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(torch.float32))
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Flash attention: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  ``flash_attention.launches`` counts the launches."""
    dev = q.device
    kw = dict(causal=causal, window=window, softcap=softcap)
    if dev.type == "cpu":
        return flash_attention_torch(q, k, v, **kw)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {dev}")
    B, S, H, hd = q.shape
    K = k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if K < 1 or H % K:
        raise ValueError(f"{H} query heads do not split into {K} KV heads")
    if window < 0 or softcap < 0:
        raise ValueError("window and softcap must be >= 0")
    build.check("q", q, q.dtype, (B, S, H, hd), dev)
    build.check("k", k, q.dtype, (B, S, K, hd), dev)
    build.check("v", v, q.dtype, (B, S, K, hd), dev)
    out = torch.empty_like(q)
    fn = build.entry("flash_attention", "flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                 B, S, H, K, hd, int(causal), int(window), float(softcap), hd ** -0.5,
                 stream)
    build.raise_on(err, "flash_attention")
    build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
