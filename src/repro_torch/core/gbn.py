"""Go-back-N retransmission model (paper §II.A, Table I), mirroring
``repro.core.gbn``: ``ideal_fct``, ``fct_with_one_delayed_packet`` and
``table1_inflation`` reproduce Table I in closed form; DRILL's spray pays
``gbn_goodput_factor(ooo_probability(...))``, and a flowcell-split chunk
``ooo_probability`` of its paths' skew (``dataplane.reorder_gbn_factor``).

The Table I functions take each argument as a number, an array or a
tensor, and compute in float32 (as the JAX package does without x64) on
the device of the first tensor argument, or without one on ``device``
(``None``: the card)."""
from __future__ import annotations

import torch

from repro_torch import resolve_device


def _f32(size_bytes, *args, device=None) -> list:
    """``size_bytes`` and every other argument that is not a Python number
    as float32 tensors, all on the device of the first tensor among them,
    or on ``resolve_device(device)`` where none is a tensor."""
    dev = next((a.device for a in (size_bytes, *args) if isinstance(a, torch.Tensor)), None)
    dev = resolve_device(device) if dev is None else dev
    return [torch.as_tensor(size_bytes, dtype=torch.float32, device=dev)] + [
        a if isinstance(a, (int, float)) else torch.as_tensor(a, dtype=torch.float32, device=dev)
        for a in args]


def ideal_fct(size_bytes, rate_bps, base_rtt_s, mtu_bytes: float = 1000.0, *,
              device=None) -> torch.Tensor:
    """FCT of an uninterrupted transfer: serialization + one propagation."""
    size_bytes, rate_bps, base_rtt_s = _f32(size_bytes, rate_bps, base_rtt_s, device=device)
    return size_bytes * 8.0 / rate_bps + base_rtt_s


def fct_with_one_delayed_packet(size_bytes, rate_bps, base_rtt_s, delayed_frac,
                                nak_timeout_s, recovery_rate_frac: float = 0.25,
                                mtu_bytes: float = 1000.0, *, device=None) -> torch.Tensor:
    """FCT when the packet at ``delayed_frac`` in [0, 1) of the flow arrives
    out of order: the flow runs to the hole, stalls ``nak_timeout_s`` (the
    RNIC's NAK turnaround), then re-sends the rest at ``recovery_rate_frac``
    of the rate (DCQCN treats the rewind as congestion), plus one RTT."""
    size_bytes, rate_bps, base_rtt_s, delayed_frac, nak_timeout_s, recovery_rate_frac = _f32(
        size_bytes, rate_bps, base_rtt_s, delayed_frac, nak_timeout_s, recovery_rate_frac,
        device=device)
    t_serial = size_bytes * 8.0 / rate_bps
    t_to_hole = delayed_frac * t_serial
    t_resend = (1.0 - delayed_frac) * t_serial / recovery_rate_frac
    return t_to_hole + nak_timeout_s + t_resend + base_rtt_s


def table1_inflation(size_bytes, rate_bps=40e9, base_rtt_s=8e-6, delayed_frac=0.5,
                     nak_timeout_s=80e-6, recovery_rate_frac=0.25, *,
                     device=None) -> torch.Tensor:
    """FCT(delayed) / FCT(ideal), Table I's ratio: 5.77x at 64 KB and 2.83x
    at 1 MB at the defaults (40 Gb/s, 8 us RTT, mid-flow hole, 80 us NAK
    turnaround, recovery at a quarter of the rate)."""
    return fct_with_one_delayed_packet(
        size_bytes, rate_bps, base_rtt_s, delayed_frac, nak_timeout_s, recovery_rate_frac,
        device=device) / ideal_fct(size_bytes, rate_bps, base_rtt_s, device=device)


def ooo_probability(path_delay_spread_s: torch.Tensor, rate_bps: torch.Tensor,
                    mtu_bytes: float = 1000.0) -> torch.Tensor:
    """Probability that a sprayed packet lands out of order:
    min(1, spread / inter-packet spacing)."""
    dt = mtu_bytes * 8.0 / torch.clamp(rate_bps, min=1.0)
    return torch.clamp(path_delay_spread_s / torch.clamp(dt, min=1e-12), 0.0, 1.0)


def gbn_goodput_factor(p_ooo: torch.Tensor, window_pkts: float = 64.0) -> torch.Tensor:
    """Goodput multiplier 1 / (1 + p_ooo * W/2) under go-back-N."""
    return 1.0 / (1.0 + p_ooo * (window_pkts / 2.0))
