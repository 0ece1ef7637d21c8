"""Deterministic synthetic data pipeline with O(1) skip-ahead, mirroring
``repro.data.pipeline``.

Batches are a pure function of (seed, step, position), so a restart at
step N resumes the exact token stream with no state replay.  The hashing
is the JAX package's uint32 arithmetic, carried in int64 tensors by
``core.hashing`` (``u32``, ``mul32``, ``fmix32``): the tokens equal the
JAX package's exactly, at any seed and step below 2**32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import hashing


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    # synthetic structure: token t+1 = f(token t) with noise, so that a
    # model has a signal to learn and its loss falls
    copy_prob: float = 0.9


def batch_at(cfg: DataConfig, step: int, device=None) -> dict:
    """Global batch for ``step`` on ``device`` (``None`` means ``"cuda"``):
    {tokens, labels}, each int32 [B, S], labels the tokens shifted by one."""
    dev = resolve_device(device)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    b = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    s = torch.arange(S + 1, dtype=torch.int64, device=dev)[None, :]
    key = (hashing.mul32(hashing.u32(cfg.seed), 0x85EBCA6B)
           ^ hashing.mul32(hashing.u32(step), 0xC2B2AE35)).to(dev)
    base = hashing.fmix32(hashing.mul32(b, 0x9E3779B9) ^ key)
    noise = hashing.fmix32(base ^ hashing.mul32(s, 0x27D4EB2F))
    # Markov-ish stream: mostly a deterministic walk, sometimes a jump
    m = max(V - 1, 1)
    walk = hashing.add32(base, s * 7) % m
    jump = noise % m
    use_jump = (noise % 1000) < int(1000 * (1 - cfg.copy_prob))
    toks = torch.where(use_jump, jump, walk).to(torch.int32) + 1  # avoid 0 (pad)
    return {"tokens": toks[:, :S], "labels": toks[:, 1:]}
