"""Go-back-N retransmission model (paper §II.A), mirroring the two
functions of ``repro.core.gbn`` that the simulator uses: DRILL's spray
pays ``gbn_goodput_factor(ooo_probability(...))``, and a flowcell-split
chunk ``ooo_probability`` of its paths' skew (``dataplane.reorder_gbn_factor``)."""
from __future__ import annotations

import torch


def ooo_probability(path_delay_spread_s: torch.Tensor, rate_bps: torch.Tensor,
                    mtu_bytes: float = 1000.0) -> torch.Tensor:
    """Probability that a sprayed packet lands out of order:
    min(1, spread / inter-packet spacing)."""
    dt = mtu_bytes * 8.0 / torch.clamp(rate_bps, min=1.0)
    return torch.clamp(path_delay_spread_s / torch.clamp(dt, min=1e-12), 0.0, 1.0)


def gbn_goodput_factor(p_ooo: torch.Tensor, window_pkts: float = 64.0) -> torch.Tensor:
    """Goodput multiplier 1 / (1 + p_ooo * W/2) under go-back-N."""
    return 1.0 / (1.0 + p_ooo * (window_pkts / 2.0))
