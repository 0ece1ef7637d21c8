"""Fluid DCQCN rate control (Zhu et al., SIGCOMM'15), paper §IV "Flow CC",
mirroring ``repro.netsim.dcqcn`` (the expected-value ODE form: the CNP and
recovery branches are blended with the probability that a CNP fires)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.cascade_common import red_mark


class DCQCNParams(NamedTuple):
    kmin_bytes: float = 400e3
    kmax_bytes: float = 1600e3
    pmax: float = 0.2
    g: float = 1.0 / 256.0
    r_ai: float = 1e9  # additive increase (bps); HPCC-style tuning for 100G
    min_rate: float = 1e9
    cnp_interval: float = 50e-6
    alpha_interval: float = 55e-6
    rate_interval: float = 55e-6
    mtu_bytes: float = 1000.0


class DCQCNState(NamedTuple):
    rc: torch.Tensor  # f32[...] current rate (bps)
    rt: torch.Tensor  # f32[...] target rate
    alpha: torch.Tensor  # f32[...]
    t_since_cnp: torch.Tensor  # f32[...]
    t_since_rate: torch.Tensor  # f32[...]
    recovery_stage: torch.Tensor  # f32[...] (blended)


def init_state(shape, line_rate: float, device) -> DCQCNState:
    def f(v):
        return torch.full(shape, float(v), dtype=torch.float32, device=device)

    return DCQCNState(rc=f(line_rate), rt=f(line_rate), alpha=f(1.0),
                      t_since_cnp=f(1.0), t_since_rate=f(0.0), recovery_stage=f(0.0))


def mark_probability(queue_bytes: torch.Tensor, p: DCQCNParams) -> torch.Tensor:
    """RED-style ECN marking probability from instantaneous queue depth."""
    return red_mark(queue_bytes, p.kmin_bytes, p.kmax_bytes, p.pmax)


def alpha_decay(dt: float, p: DCQCNParams) -> float:
    """(1 - g) ** (dt / alpha_interval), raised in float32 as the reference
    does (a float32 base to a float32 power)."""
    return float(np.float32(1.0 - p.g) ** np.float32(dt / p.alpha_interval))


def step(state: DCQCNState, mark_frac: torch.Tensor, active: torch.Tensor, dt: float,
         line_rate: float, p: DCQCNParams) -> tuple[DCQCNState, torch.Tensor]:
    """One fluid step.  ``e`` is the probability that a CNP fires this step;
    inactive sub-flows hold their state.  Returns (new_state, e)."""
    pkts = torch.clamp(state.rc * dt / (8.0 * p.mtu_bytes), min=1.0)
    p_any = 1.0 - torch.exp(pkts * torch.log1p(-torch.clamp(mark_frac, max=0.999)))
    gate = (state.t_since_cnp >= p.cnp_interval) & active
    e = torch.where(gate, p_any, torch.zeros_like(p_any))

    # --- CNP branch
    rt_c = state.rc
    rc_c = torch.clamp(state.rc * (1.0 - state.alpha / 2.0), min=p.min_rate)
    alpha_c = (1.0 - p.g) * state.alpha + p.g

    # --- no-CNP branch
    t_rate = state.t_since_rate + dt
    do_rate = t_rate >= p.rate_interval
    in_recovery = state.recovery_stage < 5.0
    rc_n = torch.where(do_rate, (state.rc + state.rt) / 2.0, state.rc)
    rt_n = torch.where(do_rate & ~in_recovery, state.rt + p.r_ai, state.rt)
    rt_n = torch.clamp(rt_n, max=line_rate)
    rc_n = torch.clamp(rc_n, max=line_rate)
    stage_n = torch.where(do_rate, state.recovery_stage + 1.0, state.recovery_stage)
    alpha_n = state.alpha * alpha_decay(dt, p)

    def blend(c, n):
        return e * c + (1.0 - e) * n

    zero = torch.zeros_like(e)
    new = DCQCNState(
        rc=blend(rc_c, rc_n),
        rt=blend(rt_c, rt_n),
        alpha=blend(alpha_c, alpha_n),
        t_since_cnp=blend(zero, state.t_since_cnp + dt),
        t_since_rate=blend(zero, torch.where(do_rate, zero, t_rate)),
        recovery_stage=blend(zero, stage_n),
    )
    # inactive sub-flows hold full rate so they start at line rate
    new = DCQCNState(*(torch.where(active, a, b) for a, b in zip(new, state)))
    return new, e


def fast_forward(state: DCQCNState, active: torch.Tensor, n_steps: int, dt: float,
                 p: DCQCNParams) -> DCQCNState:
    """``n_steps`` zero-mark steps in closed form, valid where the compact
    engine's quiescence check holds (every active sub-flow pinned at
    ``rc == rt == line rate``, no marks): rc and rt are fixed points of the
    recovery branch, alpha decays geometrically, the rate timer is periodic
    and each of its firings adds a recovery stage.  Tensors of any leading
    shape; inactive sub-flows hold their state, as in :func:`step`.  The
    scalars are float32, as in the reference."""
    f32 = np.float32
    n = float(n_steps)
    n_dt = float(f32(n) * f32(dt))
    alpha = state.alpha * float(f32(alpha_decay(dt, p)) ** f32(n))
    # the rate timer climbs dt a step and resets to 0 on reaching
    # rate_interval: first firing after m1 = max(ceil((I - t0) / dt), 1)
    # steps, then one every ceil(I / dt) steps; its final value is the residue
    period = float(np.ceil(p.rate_interval / dt))
    m1 = torch.clamp(torch.ceil((p.rate_interval - state.t_since_rate) / dt), min=1.0)
    fired = m1 <= n
    events = torch.where(fired, 1.0 + torch.floor((n - m1) / period), torch.zeros_like(m1))
    t_rate = torch.where(fired, torch.remainder(n - m1, period) * float(f32(dt)),
                         state.t_since_rate + n_dt)
    new = DCQCNState(rc=state.rc, rt=state.rt, alpha=alpha,
                     t_since_cnp=state.t_since_cnp + n_dt, t_since_rate=t_rate,
                     recovery_stage=state.recovery_stage + events)
    return DCQCNState(*(torch.where(active, a, b) for a, b in zip(new, state)))
