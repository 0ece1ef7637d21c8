"""In-simulation flight recorder, mirroring ``repro.obs.recorder``: a
fixed-shape ring of per-chunk summaries carried through
``compact.run_core``'s chunk loop beside the state.

One row per chunk (stepped, or fast-forwarded with ``ff`` = 1): the max,
mean and sum of the chunk's per-step outputs, the active sub-flows and
their DCQCN rate quantiles at the chunk's end, and each uplink's offered
load against its capacity.  The ring has a leading batch dimension B, as
the engine's state: ``meta`` f32[B, R, M], ``uplink`` f32[B, R, U, 2],
``count`` i64[B]; write ``i`` of a simulation lands in row ``i % R``.

The quantiles are rank statistics, as the reference's: the active rates
sorted with +inf elsewhere, read at index ``(n_active - 1) * q``
truncated (no interpolation).  ``drain`` unrolls one simulation's ring
into chronological order on the host, and ``epoch_summary`` reduces it to
the JSON-able record of the flight log.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RecordSpec:
    """Recorder knobs (frozen, hashable)."""

    ring_chunks: int = 64  # R: per-chunk summary rows retained (newest win)
    quantiles: tuple = (0.1, 0.5, 0.9)  # DCQCN rc rank quantiles


#: scalar summary columns of ``RingState.meta`` (before the per-spec
#: ``rc_q*`` quantile columns appended by ``meta_fields``)
META_FIELDS = (
    "step0",  # first dt step of the chunk
    "steps",  # chunk length in dt steps
    "ff",  # 1.0 if the chunk was covered by a quiescence fast-forward
    "queue_max",  # max over the chunk of the per-step max queue (bytes)
    "queue_mean",  # mean over the chunk of the per-step max queue (bytes)
    "cnp_pkts",  # expected congestion packets generated in the chunk
    "goodput_mean",  # mean total delivered rate over the chunk (bit/s)
    "active_subflows",  # active sub-flows at the chunk boundary
)


def meta_fields(spec: RecordSpec) -> tuple:
    return META_FIELDS + tuple(f"rc_q{int(round(q * 100))}" for q in spec.quantiles)


class RingState(NamedTuple):
    meta: torch.Tensor  # f32[B, R, M] per-chunk scalar summaries
    uplink: torch.Tensor  # f32[B, R, U, 2] per-uplink (offered, capacity) bit/s
    count: torch.Tensor  # i64[B] chunks written so far (may exceed R)


def ring_init(spec: RecordSpec, n_uplinks: int, B: int = 1, *, device) -> RingState:
    """An empty ring of ``B`` simulations on ``device`` (named by the
    caller: the port's entry points choose their device explicitly)."""
    R = int(spec.ring_chunks)
    return RingState(
        meta=torch.zeros((B, R, len(meta_fields(spec))), dtype=torch.float32, device=device),
        uplink=torch.zeros((B, R, int(n_uplinks), 2), dtype=torch.float32, device=device),
        count=torch.zeros((B,), dtype=torch.int64, device=device),
    )


def record_chunk(spec: RecordSpec, ring: RingState, *, step0, steps, ff, queue_max,
                 queue_mean, cnp, goodput, offered, cap, rc, active,
                 write=None) -> RingState:
    """Append one chunk-summary row to each simulation of the batch.

    ``step0``, ``queue_max``, ``queue_mean``, ``cnp``, ``goodput`` are [B]
    (or scalars); ``steps`` and ``ff`` numbers; ``offered`` f32[B, U] and
    ``cap`` f32[U] or [B, U] per-uplink rates of the chunk; ``rc`` f32[B,
    W, N] the DCQCN rates and ``active`` bool[B, W, N] the live sub-flows at
    the chunk's end.  ``write`` (bool[B], None for all) picks the
    simulations that write a row; the others keep their ring as it was."""
    f32 = torch.float32
    dev = ring.meta.device
    B, R = ring.meta.shape[:2]

    def col(x):  # a number is filled on the device: no host-to-device copy
        if isinstance(x, torch.Tensor):
            return x.to(f32).expand(B)
        return torch.full((B,), float(x), dtype=f32, device=dev)

    act = active.flatten(1)
    n_act = act.sum(1)
    n_act_f = n_act.to(f32)
    vals = torch.sort(torch.where(act, rc.flatten(1), torch.inf), dim=1).values
    qs = []
    for q in spec.quantiles:
        # q rounded to float32 first: the product is then the reference's
        idx = ((n_act_f - 1.0) * float(np.float32(q))).to(torch.int64)
        idx = torch.clamp(idx, 0, vals.shape[1] - 1)
        qs.append(torch.where(n_act > 0, vals.gather(1, idx[:, None])[:, 0], 0.0))
    row = torch.stack([col(step0), col(steps), col(ff), col(queue_max), col(queue_mean),
                       col(cnp), col(goodput), n_act_f] + qs, dim=1)  # [B, M]
    up = torch.stack([offered.to(f32), cap.to(f32).expand_as(offered)], dim=-1)  # [B, U, 2]
    b = torch.arange(B, device=dev)
    slot = ring.count % R
    meta, uplink = ring.meta.clone(), ring.uplink.clone()
    meta[b, slot] = row
    uplink[b, slot] = up
    if write is None:
        return RingState(meta, uplink, ring.count + 1)
    return RingState(torch.where(write[:, None, None], meta, ring.meta),
                     torch.where(write[:, None, None, None], uplink, ring.uplink),
                     ring.count + write.to(torch.int64))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def drain(spec: RecordSpec, ring: RingState, b: int = 0) -> dict:
    """Host-side: simulation ``b``'s ring in chronological order.  After
    ``count`` writes the oldest kept row sits at ``count % R``, so the
    newest R chunks survive a wraparound, the boundary chunk included."""
    R = int(spec.ring_chunks)
    count = int(_np(ring.count)[b])
    n = min(count, R)
    meta = _np(ring.meta)[b]
    uplink = _np(ring.uplink)[b]
    idx = np.arange(n) if count <= R else (count % R + np.arange(R)) % R
    return dict(fields=list(meta_fields(spec)), meta=meta[idx], uplink=uplink[idx],
                chunks_recorded=count, chunks_kept=int(n))


def epoch_summary(spec: RecordSpec, drained: dict) -> dict:
    """Reduce a drained ring to the JSON-able per-epoch record the flight
    log stores: chunk-weighted scalar aggregates, per-uplink offered /
    capacity / utilization vectors, and the per-chunk table."""
    meta = np.asarray(drained["meta"], np.float64)
    uplink = np.asarray(drained["uplink"], np.float64)
    fields = list(drained["fields"])
    out = dict(schema="insim_v1",
               chunks_recorded=int(drained["chunks_recorded"]),
               chunks_kept=int(drained["chunks_kept"]))
    if meta.shape[0] == 0:
        return out
    col = {f: meta[:, i] for i, f in enumerate(fields)}
    steps = col["steps"]
    w = steps / max(float(steps.sum()), 1e-9)  # chunk-length weights
    offered = uplink[:, :, 0]
    cap = np.maximum(uplink[:, :, 1], 1e-9)
    util = np.minimum(offered / cap, 1e6)  # dead links read huge, not inf

    def rnd(a):
        return np.round(np.asarray(a, np.float64), 6).tolist()

    out.update(
        steps_covered=int(steps.sum()),
        ff_chunks=int(col["ff"].sum()),
        ff_steps=int((col["ff"] * steps).sum()),
        queue_max_bytes=float(col["queue_max"].max()),
        queue_mean_bytes=float((col["queue_mean"] * w).sum()),
        cnp_pkts=float(col["cnp_pkts"].sum()),
        goodput_mean_bps=float((col["goodput_mean"] * w).sum()),
        active_subflows_max=float(col["active_subflows"].max()),
        uplink=dict(
            offered_mean_gbps=rnd((offered * w[:, None]).sum(0) / 1e9),
            offered_max_gbps=rnd(offered.max(0) / 1e9),
            cap_mean_gbps=rnd((cap * w[:, None]).sum(0) / 1e9),
            util_mean=rnd((util * w[:, None]).sum(0)),
            util_max=rnd(util.max(0)),
        ),
        chunks={f: rnd(col[f]) for f in fields},
    )
    return out
