"""Carrying a simulation across from the JAX package.

A simulator has no weights: what a run is made of is its trace, its
configuration and its engine state.  These helpers build the port's
counterparts from plain Python and numpy values (``dataclasses.asdict``
of a configuration, ``np.asarray`` of state leaves), so a test can start
both engines from the same mid-run state, and the flight recorder from
the same ring.  Nothing here imports the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.netsim import dcqcn as dcqcn_mod
from repro_torch.netsim.compact import CompactState, SlotCache
from repro_torch.core.congestion_table import CongestionTable
from repro_torch.netsim.engine import SimConfig
from repro_torch.netsim.workloads import Trace
from repro_torch.obs.recorder import RingState

def config_from_dict(d: dict) -> SimConfig:
    """SimConfig from ``dataclasses.asdict`` of a reference SimConfig, with
    ``dcqcn`` as a dict (or any NamedTuple of the same fields).  Fields
    the port has no use for (``mark_salt``) are dropped and the dataplane
    backend becomes ``"auto"``; ``adaptive`` and its ``ff_*`` knobs come
    across as they are."""
    d = dict(d)
    dc = d.pop("dcqcn", None)
    if dc is not None:
        dc = dc._asdict() if hasattr(dc, "_asdict") else dict(dc)
        d["dcqcn"] = dcqcn_mod.DCQCNParams(**dc)
    if "dataplane" in d:  # the reference's backend names a TPU choice; here
        d["dataplane"] = "auto"  # the device of the tensors picks the kernel
    d.pop("mark_salt", None)
    names = {f.name for f in dataclasses.fields(SimConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown SimConfig fields: {sorted(unknown)}")
    return SimConfig(**d)


def trace_from_arrays(**arrays) -> Trace:
    """Trace from numpy arrays named like its fields (sizes, arrivals, src,
    dst, flow_id, valid[, spray])."""
    return Trace(**{k: np.asarray(v) for k, v in arrays.items()})


def _leaves(obj) -> dict:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _tensor(x, device) -> torch.Tensor:
    a = np.array(x)  # a writable copy
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=device)[None]  # B = 1


def compact_state_from_numpy(leaves: dict, device) -> CompactState:
    """The port's CompactState (B = 1) from a reference CompactState, given
    as a dict of its fields (nested states as dicts or NamedTuples; leaves
    anything ``np.asarray`` takes, uint32 widened to int64).  Scalar
    counters become [1] tensors; int32 slot ids and counters become int64
    as the port keeps them."""
    lv = _leaves(leaves)
    cc = _leaves(lv["cc"])
    table = _leaves(lv["table"])
    cache = _leaves(lv["cache"])

    def t(x, dtype=None):
        out = _tensor(x, device)
        return out if dtype is None else out.to(dtype)

    return CompactState(
        slot_fid=t(lv["slot_fid"], torch.int64),
        remaining=t(lv["remaining"]),
        path=t(lv["path"], torch.int32),
        sub_done=t(lv["sub_done"]),
        cc=dcqcn_mod.DCQCNState(*(t(cc[f]) for f in dcqcn_mod.DCQCNState._fields)),
        cqe_bitmap=t(lv["cqe_bitmap"], torch.int64),
        admitted=t(lv["admitted"], torch.int64),
        finish=t(lv["finish"]),
        table=CongestionTable(inactive_until=t(table["inactive_until"])),
        queue=t(lv["queue"]),
        cnp_pkts=t(lv["cnp_pkts"]),
        spill_steps=t(lv["spill_steps"], torch.int64),
        step=t(lv["step"], torch.int64),
        ff_steps=t(lv["ff_steps"], torch.int64),
        cache=SlotCache(
            tx=t(cache["tx"], torch.int32), rx=t(cache["rx"], torch.int32),
            fab=t(cache["fab"], torch.int32), sleaf=t(cache["sleaf"], torch.int32),
            dleaf=t(cache["dleaf"], torch.int32), salt=t(cache["salt"], torch.int64),
            fid=t(cache["fid"], torch.int64), src=t(cache["src"], torch.int32),
            dst=t(cache["dst"], torch.int32), spray=t(cache["spray"], torch.int32),
        ),
    )


def ring_from_numpy(leaves, device) -> RingState:
    """The port's recorder ring (B = 1) from a reference ``RingState``
    (its fields as a dict or NamedTuple of numpy leaves: meta [R, M],
    uplink [R, U, 2], count scalar)."""
    lv = _leaves(leaves)
    return RingState(meta=_tensor(lv["meta"], device).to(torch.float32),
                     uplink=_tensor(lv["uplink"], device).to(torch.float32),
                     count=_tensor(lv["count"], device).to(torch.int64))
