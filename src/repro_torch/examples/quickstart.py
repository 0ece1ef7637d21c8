"""Quickstart: the paper's mechanism in 40 lines, the twin of
``examples/quickstart.py`` on ``repro_torch.core``, printing the same
lines.

1. A WQE (message) is split into N=4 equal sub-WQEs (SeqBalance Shaper).
2. Each sub-flow hashes to a path at the source ToR; congested paths are
   double-hashed around.
3. The destination mirrors ECN marks back; the table holds them for phi.
4. A CQE fires only when every sub-flow's bitmap bit is set.

Run: python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import congestion_table as ctab, routing, shaper

N_PATHS, N_SUB, PHI = 8, 4, 32e-6


def run(device=None) -> list[str]:
    """The example's lines."""
    dev = resolve_device(device)
    lines = []
    # --- 1. shaper: split one 1 MB WQE into 4 sub-WQEs on distinct QPs
    size = torch.tensor(1_000_000, dtype=torch.int32, device=dev)
    sub_sizes = shaper.split_wqe(size, N_SUB)
    src, dst, sport, dport = shaper.subflow_five_tuples(
        torch.tensor(11, device=dev), torch.tensor(42, device=dev),
        flow_id=torch.tensor(7, device=dev), n=N_SUB)
    lines.append(f"sub-WQE sizes: {sub_sizes.cpu().numpy()} (sum: {int(sub_sizes.sum())} bytes)")

    # --- 2./3. congestion table: path 3 was reported congested just now
    table = ctab.CongestionTable.create(1, N_PATHS, dev)
    table = ctab.mark_congested(table, [0], [3], now=0.0, phi=PHI)
    inactive = ctab.inactive_row(table, 0, now=10e-6)
    paths = routing.select_paths(src, dst, sport, dport, inactive[None, :], N_PATHS)
    lines.append(f"inactive paths: {[i for i, b in enumerate(inactive.tolist()) if b]}")
    lines.append(f"chosen paths  : {paths.tolist()} "
                 "(never 3; sticky per sub-flow => no reordering)")

    # --- 4. bitmap CQE: the app sees ONE completion, only when all ACKs are in
    cqe = shaper.CQEState.create(1, N_SUB, dev)
    for i in range(N_SUB):
        cqe = shaper.ack_subwqe(cqe, torch.tensor([0], device=dev), torch.tensor([i], device=dev))
        lines.append(f"ACK sub-WQE {i}: CQE ready = {bool(shaper.cqe_ready(cqe)[0])}")
    return lines


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    lines = run(ap.parse_args(argv).device)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
