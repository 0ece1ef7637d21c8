"""Holding one serving run against another: the prefill and decode steps
as ``ServeEngine`` runs them, free or teacher-forced, and the rules that
compare their logits and greedy tokens; and one recurrent unit against
another fed the same input (``unit_outputs``, ``unit_errors``).

Logits are compared as |got - reference| over the RMS of the reference's
row (its norm / sqrt(vocab)): in units of the row norm a tolerance would
shrink with the vocabulary.  Greedy tokens are compared up to each
request's first near-tie, a step whose reference top-1/top-2 margin is
below ``NEAR_TIE * tol * RMS``: past one, two right runs may part ways.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model, recurrent
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
# A recurrent unit fed one input on both sides: the largest and the mean,
# over the sampled rows, of a row's largest |got - ref| over the RMS of
# ref's row (ref: the unit's output less its input, in float32).  In
# bfloat16 an mLSTM head whose values are small is divided by their small
# RMS in the group norm, which magnifies the rounding: the JAX package's
# own bfloat16 mLSTM at xlstm-1.3b's width lies up to 0.12 (mean 0.031)
# of a row's RMS from its float32 run, where a carried state scaled by
# hd ** -0.5 reads 2.7 (mean 0.34) and a dropped sLSTM recurrence 1.7
# (mean 1.03) (families_reference.json's "units")
UNIT_TOL = {"float32": {"max": 1e-4, "mean": 1e-4}, "bfloat16": {"max": 0.5, "mean": 0.1}}
UNIT_APPLY = {"mlstm": recurrent.mlstm_apply, "slstm": recurrent.slstm_apply}


def serve_steps(params, cfg, prompts, max_len: int, steps: int, forced=None,
                plain: bool = False, routes=None, route_as=None):
    """``model.prefill`` then ``model.decode_step`` as ``ServeEngine`` runs
    them (left-padded prompts, greedy), or fed ``forced`` tokens [steps, B]:
    (tokens [steps, B], float32 logits [steps, B, V]) on ``params``'
    device.  ``plain`` runs the plain attention, the reference the kernel
    is held against.  ``routes``, a list, receives each step's list of
    moe dispatches (``moe.Routing``, in layer order; the prefill first);
    ``route_as``, such a list of another run, routes each step's tokens
    to that run's experts."""
    dev = params.device

    def probe(s: int) -> dict:
        kw = {}
        if routes is not None:
            routes.append([])
            kw["routes"] = routes[-1]
        if route_as is not None:
            kw["experts"] = [r.gate_idx for r in route_as[s]]
        return kw

    with torch.inference_mode():
        toks = torch.as_tensor(engine.pad_prompts(prompts), device=dev)
        logits, cache = model.prefill(params, cfg, {"tokens": toks}, max_len,
                                      plain_attention=plain, **probe(0))
        out_t, out_l = [], [logits.float()]
        for s in range(steps):
            nxt = torch.argmax(logits, -1) if forced is None else forced[s]
            nxt = nxt.to(device=dev, dtype=torch.int32)[:, None]
            out_t.append(nxt[:, 0])
            if s < steps - 1:
                logits, cache = model.decode_step(params, cfg, nxt, cache, **probe(s + 1))
                out_l.append(logits.float())
    return torch.stack(out_t), torch.stack(out_l)


def logit_errors(got, ref_logits, ref_tokens, top: int | None = 8):
    """Per step and request [steps, B]: the largest |got - ref| / the RMS
    of ref's row over ref's ``top`` ids and its greedy token (over every id
    where ``top`` is None); and those RMS."""
    rms = ref_logits.norm(dim=-1, keepdim=True) / ref_logits.shape[-1] ** 0.5
    if top is None:
        return ((got - ref_logits).abs() / rms).amax(-1), rms[..., 0]
    ids = torch.cat([ref_logits.topk(top, dim=-1).indices, ref_tokens[..., None].long()], -1)
    err = (torch.gather(got, -1, ids) - torch.gather(ref_logits, -1, ids)).abs() / rms
    return err.amax(-1), rms[..., 0]


def logit_agreement(got, ref_logits, ref_tokens, top: int | None = 8) -> tuple[float, torch.Tensor]:
    """The largest of ``logit_errors``, and the rows' RMS [steps, B]."""
    err, rms = logit_errors(got, ref_logits, ref_tokens, top)
    return float(err.max()), rms


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


def unit_inputs(seed: int, batch: int, seq: int, steps: int, width: int):
    """A prefill input [batch, seq, width] and ``steps`` decode inputs
    [steps, batch, 1, width], standard normal from ``seed``, rounded to
    bfloat16 (float32 numpy) so that every dtype is fed the same values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, width), dtype=np.float32)
    xd = rng.standard_normal((steps, batch, 1, width), dtype=np.float32)
    return tuple(torch.as_tensor(a).to(torch.bfloat16).float().numpy() for a in (x, xd))


def unit_outputs(kind: str, p, cfg, x, xd) -> torch.Tensor:
    """The ``kind`` unit's output less its input, float32 [B * S + steps *
    B, D]: the prefill of ``x`` [B, S, D] from the empty cache, then a
    decode step of each ``xd[s]`` [B, 1, D], in ``cfg.dtype`` on ``p``'s
    device."""
    apply = UNIT_APPLY[kind]
    dev, dt = p.ln.device, getattr(torch, cfg.dtype)
    out = []
    with torch.inference_mode():
        xt = torch.as_tensor(x, device=dev).to(dt)
        y, cache = apply(p, xt, cfg)
        out.append((y.float() - xt.float()).reshape(-1, x.shape[-1]))
        for step in xd:
            xt = torch.as_tensor(step, device=dev).to(dt)
            y, cache = apply(p, xt, cfg, cache, decode=True)
            out.append((y.float() - xt.float()).reshape(-1, x.shape[-1]))
    return torch.cat(out)


def unit_errors(got, want, rms) -> dict:
    """Per row [R]: the largest |got - want| [R, C] over ``rms`` [R];
    returns their max and mean (the rule of ``UNIT_TOL``)."""
    err = (np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max(-1)
           / np.asarray(rms, np.float64))
    return {"max": float(err.max()), "mean": float(err.mean())}
