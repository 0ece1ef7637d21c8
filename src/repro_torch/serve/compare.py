"""Holding one serving run against another: the prefill and decode steps
as ``ServeEngine`` runs them, free or teacher-forced, and the rules that
compare their logits and greedy tokens.

Logits are compared as |got - reference| over the RMS of the reference's
row (its norm / sqrt(vocab)): in units of the row norm a tolerance would
shrink with the vocabulary.  Greedy tokens are compared up to each
request's first near-tie, a step whose reference top-1/top-2 margin is
below ``NEAR_TIE * tol * RMS``: past one, two right runs may part ways.
"""
from __future__ import annotations

import torch

from repro_torch.models import model
from repro_torch.serve import engine

# float32 against float32: sums in another order (the port on the CPU
# against the JAX package: 8e-6), where a bfloat16 rounding in a float32
# run (2e-3 of a value) breaks the limit.  bfloat16: each side rounds to
# bfloat16 in other places (the flash kernel rounds the softmax weights
# before the product with V, the plain version does not; the port on the
# CPU against the JAX package: 0.032); one bfloat16 step of a logit of
# 16-32 is 0.125
SERVE_TOL = {"float32": 1e-4, "bfloat16": 0.15}
NEAR_TIE = 4.0


def serve_steps(params, cfg, prompts, max_len: int, steps: int, forced=None,
                plain: bool = False):
    """``model.prefill`` then ``model.decode_step`` as ``ServeEngine`` runs
    them (left-padded prompts, greedy), or fed ``forced`` tokens [steps, B]:
    (tokens [steps, B], float32 logits [steps, B, V]) on ``params``'
    device.  ``plain`` runs the plain attention, the reference the kernel
    is held against."""
    dev = params.device
    with torch.inference_mode():
        toks = torch.as_tensor(engine.pad_prompts(prompts), device=dev)
        logits, cache = model.prefill(params, cfg, {"tokens": toks}, max_len,
                                      plain_attention=plain)
        out_t, out_l = [], [logits.float()]
        for s in range(steps):
            nxt = torch.argmax(logits, -1) if forced is None else forced[s]
            nxt = nxt.to(device=dev, dtype=torch.int32)[:, None]
            out_t.append(nxt[:, 0])
            if s < steps - 1:
                logits, cache = model.decode_step(params, cfg, nxt, cache)
                out_l.append(logits.float())
    return torch.stack(out_t), torch.stack(out_l)


def logit_agreement(got, ref_logits, ref_tokens, top: int | None = 8) -> tuple[float, torch.Tensor]:
    """The largest |got - ref| / the RMS of ref's row over ref's ``top``
    ids and its greedy token (over every id where ``top`` is None), and
    those RMS [steps, B]."""
    rms = ref_logits.norm(dim=-1, keepdim=True) / ref_logits.shape[-1] ** 0.5
    if top is None:
        return float(((got - ref_logits).abs() / rms).max()), rms[..., 0]
    ids = torch.cat([ref_logits.topk(top, dim=-1).indices, ref_tokens[..., None].long()], -1)
    err = (torch.gather(got, -1, ids) - torch.gather(ref_logits, -1, ids)).abs() / rms
    return float(err.max()), rms[..., 0]


def tokens_before_near_tie(margin, rms, tol: float) -> list[int]:
    """Per request, the steps before the first whose margin is below
    ``NEAR_TIE * tol * rms`` ([steps, B] each)."""
    near = margin < NEAR_TIE * tol * rms
    steps = near.shape[0]
    return [int(near[:, i].float().argmax()) if bool(near[:, i].any()) else steps
            for i in range(near.shape[1])]


def margins(ref_logits) -> torch.Tensor:
    """The top-1/top-2 margin of each row [steps, B]."""
    top2 = ref_logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]
