"""Feature extraction: flight log -> [epoch, uplink, feature] arrays.

The ROADMAP's predictive planner (arXiv 2506.08132) needs per-epoch,
per-uplink congestion features to forecast the next hotspot before
``LinkHealth`` reacts to it.  ``epoch_matrix`` is that data factory's
output format: it reads the ``epoch`` events of a flight log (their
``insim`` summaries come from the in-sim ring recorder) and lays them out
as a dense float matrix plus the epoch/feature axes — ready to stack
across ``run_cosim_grid`` rollouts into a training set.

Per-uplink features come from ``insim["uplink"]``; epoch-global features
(queue max, CNP total, fast-forward occupancy, plan churn, quarantine
count) are broadcast across the uplink axis so a single matrix carries
both views.
"""
from __future__ import annotations

import numpy as np

#: default feature axis, in matrix column order
FEATURES = (
    "offered_mean_gbps",  # per-uplink
    "offered_max_gbps",  # per-uplink
    "cap_mean_gbps",  # per-uplink
    "util_mean",  # per-uplink
    "util_max",  # per-uplink
    "queue_max_bytes",  # epoch-global, broadcast
    "cnp_pkts",  # epoch-global, broadcast
    "ff_fraction",  # epoch-global, broadcast
    "plan_churn",  # epoch-global, broadcast
    "quarantined_n",  # epoch-global, broadcast
)


def epoch_matrix(flight, *, features: tuple = FEATURES) -> dict:
    """Build the [E, U, F] feature matrix from a flight log.

    ``flight`` is a path (read via ``flightlog.read_flight``) or an
    already-loaded ``(header, records)`` pair.  Only ``epoch`` events that
    carry an ``insim`` summary contribute (recording must have been on);
    raises ``ValueError`` when none do or uplink counts disagree.

    Returns ``dict(epochs, features, matrix)`` with ``matrix`` a float64
    ndarray of shape ``[len(epochs), U, len(features)]``."""
    from repro_torch.obs.flightlog import read_flight

    if isinstance(flight, (tuple, list)):
        _, records = flight
    else:
        _, records = read_flight(flight)
    rows = [r for r in records
            if r.get("kind") == "epoch" and (r.get("insim") or {}).get("uplink")]
    if not rows:
        raise ValueError("flight log has no epoch events with in-sim "
                         "summaries (was recording enabled?)")
    U = len(rows[0]["insim"]["uplink"]["offered_mean_gbps"])
    mat = np.zeros((len(rows), U, len(features)), np.float64)
    for e, rec in enumerate(rows):
        ins = rec["insim"]
        upl = ins["uplink"]
        if len(upl["offered_mean_gbps"]) != U:
            raise ValueError(f"epoch {rec.get('epoch')}: uplink count "
                             f"{len(upl['offered_mean_gbps'])} != {U}")
        for fi, name in enumerate(features):
            if name in upl:
                mat[e, :, fi] = np.asarray(upl[name], np.float64)
            elif name == "ff_fraction":
                mat[e, :, fi] = (ins.get("ff_steps", 0)
                                 / max(ins.get("steps_covered", 0), 1))
            elif name == "quarantined_n":
                mat[e, :, fi] = len(rec.get("quarantined") or ())
            elif name in ins:
                mat[e, :, fi] = float(ins[name])
            else:
                mat[e, :, fi] = float(rec.get(name, 0.0))
    return dict(epochs=[r.get("epoch", e) for e, r in enumerate(rows)],
                features=list(features), matrix=mat)
