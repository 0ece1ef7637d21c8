"""Batched serving engine: fixed-slot batching over the prefill/decode
step functions, mirroring ``repro.serve.engine``.

Requests are admitted into ``batch_size`` slots; every engine tick runs one
decode step for all slots (finished slots keep decoding and are masked out
on the host).  Prefill runs per admission batch.  Greedy decoding: the
next tokens are the argmax, read to the host once a tick.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model


def pad_prompts(prompts, rows: int | None = None) -> np.ndarray:
    """i32[rows, longest prompt]: each prompt in its row, left-padded with
    token 1 (rows past the prompts are all 1), as ``admit`` batches them."""
    rows = len(prompts) if rows is None else rows
    L = max(len(p) for p in prompts)
    toks = np.ones((rows, L), np.int32)
    for i, p in enumerate(prompts):
        toks[i, L - len(p):] = p
    return toks


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # i32[prompt_len]
    max_new_tokens: int
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """``device=None`` means ``"cuda"`` and raises without one; ``params``
    (a ``model.Params``) are moved to the device."""

    def __init__(self, cfg, params, batch_size: int, max_len: int,
                 stop_token: int | None = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.B = batch_size
        self.max_len = max_len
        self.stop_token = stop_token
        self.cache = None
        self.active: list[Request | None] = [None] * batch_size
        self.remaining = np.zeros(batch_size, np.int64)

    def admit(self, requests: list[Request]):
        """Admit a full batch (prefill).  Slot-aligned prompts are padded to
        the longest prompt; shorter prompts left-pad with token 1 (attended:
        there is no padding mask, as in the JAX package)."""
        if len(requests) > self.B:
            raise ValueError(f"{len(requests)} requests for {self.B} slots")
        toks = pad_prompts([r.prompt for r in requests], self.B)
        for i, r in enumerate(requests):
            self.active[i] = r
            self.remaining[i] = r.max_new_tokens
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        logits, self.cache = model.prefill(self.params, self.cfg, batch, self.max_len)
        self._next = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        host_next = self._next.cpu().numpy()
        for i, r in enumerate(requests):
            r.out_tokens.append(int(host_next[i, 0]))
            self.remaining[i] -= 1

    def step(self) -> int:
        """One decode tick for every active slot; returns #active."""
        logits, self.cache = model.decode_step(self.params, self.cfg, self._next, self.cache)
        self._next = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        n_active = 0
        host_next = self._next.cpu().numpy()
        for i, r in enumerate(self.active):
            if r is None or r.done:
                continue
            tok = int(host_next[i, 0])
            r.out_tokens.append(tok)
            self.remaining[i] -= 1
            if self.remaining[i] <= 0 or (self.stop_token is not None and tok == self.stop_token):
                r.done = True
            else:
                n_active += 1
        return n_active

    def run(self) -> list[Request]:
        while self.step() > 0:
            pass
        return [r for r in self.active if r is not None]
