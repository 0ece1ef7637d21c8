"""Batched sweep runner over the active-window engine, mirroring
``repro.netsim.sweep``.

Traces are grouped into power-of-two flow-count buckets (``F_pad``, at
least ``F_BUCKET``); each bucket runs as ONE batched simulation (the
reference's ``vmap``) over a shared window W and admission lane A.  Any
simulation that spills (an arrived flow found no free slot) is rerun with
a window re-planned from the concurrency it actually showed.

Entry points take ``device=None``, which means ``"cuda"``.

``cache_stats`` and ``obs_stats`` are the counters the co-sim driver
(``dist.cosim``) reads each epoch.  The port builds no program per shape
(the JAX package compiles one executable per shape bucket and counts
those): what it builds are the kernel libraries of ``kernels/build.py``,
compiled with nvcc and loaded once per process, so ``builds`` counts
those.  No path of the engines captures a CUDA graph.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import build
from repro_torch.netsim import compact
from repro_torch.netsim.engine import SimConfig, StepOutputs, line_rate_of
from repro_torch.netsim.topology import Topology
from repro_torch.netsim.workloads import Trace
from repro_torch.obs.recorder import RingState

F_BUCKET = 2048
W_BUCKET = 256

RETRY_JITTER = 0.5  # retry_sleep_s's jitter in run_jobs, the JAX package's default

_STATS_LOCK = threading.Lock()
_OBS_STATS = {"spill_retries": 0, "job_retries": 0, "job_timeouts": 0, "job_failures": 0}


def _bump(key: str) -> None:
    with _STATS_LOCK:
        _OBS_STATS[key] += 1


def cache_stats() -> dict:
    """``builds``: kernel libraries compiled or loaded in this process
    (``kernels.build.STATS``).  With every library loaded, a co-sim epoch
    adds none."""
    return {"builds": build.STATS["compiled"] + build.STATS["loaded"]}


def obs_stats() -> dict:
    """``cache_stats`` and the runner's resilience counters: spill retries
    (``_run_group``'s larger window) and job retries, timeouts and
    salvaged failures (``run_jobs``), for the co-sim's flight log."""
    with _STATS_LOCK:
        return {**cache_stats(), **_OBS_STATS}


def clear_cache() -> None:
    """Zero the runner's counters (the libraries stay loaded)."""
    with _STATS_LOCK:
        for k in _OBS_STATS:
            _OBS_STATS[k] = 0

# per-scheme lifetime slack for the concurrency bound: flowlet/hash schemes
# track near-ideal FCTs; SeqBalance holds more sub-flows.  DRILL keeps the
# default so that its first run doubles as the probe whose observed
# concurrency sizes the retry.
_SCHEME_SLACK = {
    "ecmp": (8.0, 100e-6),
    "letflow": (8.0, 100e-6),
    "conga": (8.0, 100e-6),
    "flowlet_timeout": (8.0, 100e-6),
    "seqbalance": (12.0, 150e-6),
}


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def _f_bucket(F: int) -> int:
    """Power-of-two flow-count buckets (>= F_BUCKET): per-step cost is O(W),
    so generous F padding is nearly free."""
    b = F_BUCKET
    while b < F:
        b *= 2
    return b


def plan_window(topo: Topology, sorted_arrays: list[tuple], *, scheme: str) -> int:
    """Shared active-window size for a batch of sorted traces (max of the
    per-trace concurrency bounds, bucketed)."""
    slack, extra = _SCHEME_SLACK.get(scheme, (12.0, 150e-6))
    line_rate = line_rate_of(topo)
    window_slots = max(
        compact.max_concurrency_bound(a[0], a[1], a[5], line_rate,
                                      slack_slowdown=slack, slack_s=extra)
        for a in sorted_arrays)
    return _round_up(window_slots, W_BUCKET)


def _observed_concurrency(prepped, finish, horizon_s: float) -> int:
    """Max in-flight flow count seen in a (possibly spilled) run; spill only
    stretches lifetimes, so this over-estimates the spill-free concurrency."""
    worst = 1
    for b, (arrays, _, F) in enumerate(prepped):
        valid = arrays[5][:F]
        a = arrays[1][:F][valid]
        f = finish[b, :F][valid]
        f = np.where(np.isfinite(f), f, horizon_s)
        end = np.sort(f)
        started = np.arange(1, a.size + 1)
        ended = np.searchsorted(end, a, side="left")
        if a.size:
            worst = max(worst, int((started - ended).max()))
    return worst


def plan_group(topo: Topology, cfg: SimConfig, prepped: list, window_slots=None):
    """The shapes of one batched run over sorted traces (``sort_trace``
    outputs) sharing an F_pad bucket: ``(F_pad, W, A, padded)``, with each
    trace's arrays padded to F_pad."""
    F_pad = _f_bucket(max(F for (_, _, F) in prepped))
    if window_slots is not None:
        W = max(8, min(int(window_slots), F_pad))
    else:
        W = min(plan_window(topo, [a for (a, _, _) in prepped], scheme=cfg.scheme), F_pad)
    A = _round_up(max(compact.max_admits_per_step(a[1], a[5], cfg.dt)
                      for (a, _, _) in prepped), 32)
    padded = [compact.pad_trace_arrays(a, F_pad) for (a, _, _) in prepped]
    return F_pad, W, min(A, F_pad), padded


def stack_group(padded: list, rows: list[int], device) -> tuple:
    """The trace tensors [B, F_pad] of the simulations ``rows`` of a group."""
    return compact.trace_tensors(tuple(np.stack([padded[i][k] for i in rows])
                                       for k in range(len(padded[0]))), device)


def _operands(topo: Topology, capacity, loss, reorder):
    """The traced capacity, loss and reorder operands as contiguous float32
    tensors on the topology's device (placed once for every group of a
    sweep; ``reorder`` a scalar)."""
    L1 = topo.n_links + 1

    def place(x, name, shapes):
        t = torch.as_tensor(x, dtype=torch.float32, device=topo.device).contiguous()
        if t.dim() not in shapes or t.shape[-1] != L1:
            raise ValueError(f"{name} must be f32[n_links + 1] = [{L1}]"
                             f"{' or f32[K, n_links + 1]' if 2 in shapes else ''}, "
                             f"got {list(t.shape)}")
        return t

    return (None if capacity is None else place(capacity, "capacity", (1, 2)),
            None if loss is None else place(loss, "loss", (1,)),
            None if reorder is None else torch.tensor(float(reorder), dtype=torch.float32,
                                                      device=topo.device))


def _dispatch(topo, cfg, W, F_pad, A, n_steps, padded, rows, ops, record):
    """One run of the simulations ``rows`` of a group: (finish, cnp,
    spill, ff, outs, ring) as numpy (the ring as CPU tensors, None without
    ``record``) with a leading [len(rows)] axis, and the steps each ran.
    An adaptive configuration whose macro-step spans several chunks runs
    one simulation at a time (see run_core)."""
    if cfg.adaptive and cfg.ff_macro_chunks > 1 and len(rows) > 1:
        parts = [_dispatch(topo, cfg, W, F_pad, A, n_steps, padded, [r], ops, record)
                 for r in rows]
        got = tuple(np.concatenate([p[0][i] for p in parts]) for i in range(4))
        outs = StepOutputs(*(np.concatenate([p[0][4][f] for p in parts]) for f in range(4)))
        ring = None if record is None else RingState(
            *(torch.cat([p[0][5][f] for p in parts]) for f in range(3)))
        return got + (outs, ring), [p[1][0] for p in parts]
    out = compact.run_core(topo, cfg, W, F_pad, A, n_steps,
                           stack_group(padded, rows, topo.device), capacity=ops[0],
                           loss=ops[1], reorder=ops[2], cap_seg_steps=ops[3], record=record)
    st, outs, steps = out[:3]
    ring = None if record is None else RingState(*(x.cpu() for x in out[3]))
    got = tuple(x.cpu().numpy() for x in (st.finish, st.cnp_pkts, st.spill_steps, st.ff_steps))
    return got + (StepOutputs(*(o.cpu().numpy() for o in outs)), ring), [steps] * len(rows)


def _run_group(topo, cfg, prepped, n_steps, window_slots, ops, record):
    """One batched run over traces sharing an F_pad bucket, with the
    spill-retry loop: spill-free simulations keep their first-run results
    (each with its own slice of the recorder's ring), only the offenders
    are rerun with a larger window (and the same operands)."""
    F_pad, W, A, padded = plan_group(topo, cfg, prepped, window_slots)
    results: list = [None] * len(prepped)
    outs_list: list = [None] * len(prepped)
    pending = list(range(len(prepped)))
    while pending:
        (finish, cnp, spill, ff, outs, ring), steps = _dispatch(
            topo, cfg, W, F_pad, A, n_steps, padded, pending, ops, record)
        still, still_rows = [], []
        for b, i in enumerate(pending):
            if spill[b] == 0 or W >= F_pad:
                _, inv, F = prepped[i]
                results[i] = compact.CompactResult(
                    finish=finish[b, :F][inv], cnp_pkts=cnp[b],
                    spill_steps=int(spill[b]), window_slots=W, steps=steps[b],
                    ff_steps=int(ff[b]),
                    ring=None if ring is None else RingState(*(x[b:b + 1] for x in ring)))
                outs_list[i] = StepOutputs(*(o[b] for o in outs))
            else:
                still.append(i)
                still_rows.append(b)
        pending = still
        if pending:
            _bump("spill_retries")
            seen = _observed_concurrency([prepped[i] for i in pending],
                                         finish[still_rows], n_steps * cfg.dt)
            W = min(max(W * 2, _round_up(int(seen * 1.2) + 64, W_BUCKET)), F_pad)
            A = min(A * 2, F_pad)
    return results, outs_list


def run_batch(topo: Topology, cfg: SimConfig, traces: list[Trace], *,
              window_slots: int | None = None, device=None, capacity=None,
              loss=None, cap_seg_steps: int = 0, reorder: float | None = None,
              record=None) -> tuple[list[compact.CompactResult], list[StepOutputs]]:
    """Run every trace under one (scheme, topology) pair, one batched
    simulation per F_pad bucket.

    ``capacity`` (f32[n_links + 1], sentinel slot included, or a wall-clock
    schedule f32[K, n_links + 1] stepped every ``cap_seg_steps`` steps) takes
    the place of ``topo.capacity`` for the whole batch; ``loss``
    (f32[n_links + 1]) adds per-link loss rates (go-back-N goodput).
    ``reorder`` (packets) turns on the flowcell reordering cost: flows
    whose trace ``spray`` is above 1 pay ``dataplane.reorder_gbn_factor``
    beyond that budget.  When ``loss`` or ``reorder`` comes without a
    capacity, the capacity becomes ``topo.capacity``, as in the reference.
    Numpy arrays or tensors; they go to the device once.

    ``record`` (an ``obs.RecordSpec``) turns on the flight recorder: each
    result's ``ring`` is its simulation's ring (B = 1; ``obs.drain(spec,
    result.ring)``).  ``record=None`` leaves every result as it was."""
    if not traces:
        raise ValueError("empty sweep")
    topo = topo.to(resolve_device(device))
    if (loss is not None or reorder is not None) and capacity is None:
        capacity = topo.capacity
    ops = _operands(topo, capacity, loss, reorder) + (int(cap_seg_steps),)
    prepped = [compact.sort_trace(t) for t in traces]
    n_steps = int(round(cfg.duration_s / cfg.dt))
    groups: dict[int, list[int]] = {}
    for i, (_, _, F) in enumerate(prepped):
        groups.setdefault(_f_bucket(F), []).append(i)
    results: list = [None] * len(traces)
    outs_list: list = [None] * len(traces)
    for idxs in groups.values():
        res, outs = _run_group(topo, cfg, [prepped[i] for i in idxs], n_steps,
                               window_slots, ops, record)
        for i, r, o in zip(idxs, res, outs):
            results[i] = r
            outs_list[i] = o
    return results, outs_list


def run_one(topo: Topology, cfg: SimConfig, trace: Trace, *,
            window_slots: int | None = None, device=None, **operands):
    """One trace through ``run_batch`` (``operands``: its capacity, loss,
    cap_seg_steps, reorder and record keywords)."""
    results, outs = run_batch(topo, cfg, [trace], window_slots=window_slots,
                              device=device, **operands)
    return results[0], outs[0]


def _run_job(job, device):
    """One ``run_jobs`` entry: ``(topo, cfg, traces)``,
    ``(topo, cfg, traces, run_batch_kwargs)``, or any callable without
    arguments (e.g. one ``dist.cosim.run_cosim`` loop), which picks its own
    device."""
    if callable(job):
        return job()
    topo, cfg, traces, *rest = job
    kw = dict(rest[0]) if rest else {}
    kw.setdefault("device", device)
    return run_batch(topo, cfg, traces, **kw)


@dataclasses.dataclass(frozen=True)
class JobFailure:
    """What a salvaged job returns in its place: the grid completes, and
    the failure stays visible at its index (``failed`` is True)."""

    index: int  # the job's place in the run_jobs list
    attempts: int
    error: str  # "ExcType: message" of the last attempt
    elapsed_s: float
    timed_out: bool = False

    @property
    def failed(self) -> bool:
        return True


def retry_sleep_s(index: int, attempt: int, backoff_s: float, jitter_frac: float) -> float:
    """The backoff before retry ``attempt`` of job ``index``:
    ``backoff_s * 2**(attempt - 1)`` (at most 30 s) stretched by a factor
    in [1, 1 + jitter_frac] drawn from a generator seeded on (index,
    attempt), so jobs that failed together do not retry together and a
    test replays the same sleeps."""
    base = min(backoff_s * (2 ** (attempt - 1)), 30.0)
    if base <= 0.0 or jitter_frac <= 0.0:
        return base
    u = float(np.random.default_rng((index, attempt)).uniform())
    return base * (1.0 + jitter_frac * u)


def _run_job_resilient(job, index: int, device, *, retries: int, backoff_s: float,
                       salvage: bool):
    t0 = time.time()
    for attempt in range(1, retries + 2):
        try:
            return _run_job(job, device)
        except Exception as e:  # noqa: BLE001 (a grid cell may fail in any way)
            if attempt <= retries:
                _bump("job_retries")
                time.sleep(retry_sleep_s(index, attempt, backoff_s, RETRY_JITTER))
                continue
            if not salvage:
                raise
            _bump("job_failures")
            return JobFailure(index=index, attempts=attempt,
                              error=f"{type(e).__name__}: {e}", elapsed_s=time.time() - t0)


def run_jobs(jobs: list, *, workers: int = 1, device=None, timeout_s: float | None = None,
             retries: int = 0, backoff_s: float = 0.5, salvage: bool = False) -> list:
    """Run independent sweep jobs (one per scheme, or one co-sim loop per
    grid point: see ``_run_job``); results come back in job order.
    ``workers > 1`` runs them on a thread pool, where they interleave
    their launches on the one device.

    ``retries``: a job that raises runs again up to this many times, after
    ``retry_sleep_s``.  ``salvage``: a job that still fails returns a
    ``JobFailure`` at its index instead of raising.  ``timeout_s``: a job
    not done this long after its result is awaited is abandoned (a thread
    cannot be killed; it ends with the process) and salvaged as timed
    out; only with a pool (``workers > 1``)."""
    device = resolve_device(device)
    kw = dict(retries=retries, backoff_s=backoff_s, salvage=salvage)
    if workers <= 1 or len(jobs) <= 1:
        return [_run_job_resilient(j, i, device, **kw) for i, j in enumerate(jobs)]
    pool = cf.ThreadPoolExecutor(max_workers=workers)
    timed_out = False
    try:
        futs = [pool.submit(_run_job_resilient, j, i, device, **kw)
                for i, j in enumerate(jobs)]
        out = []
        for i, f in enumerate(futs):
            try:
                out.append(f.result(timeout=timeout_s))
            except cf.TimeoutError:
                timed_out = True
                _bump("job_timeouts")
                if not salvage:
                    raise
                out.append(JobFailure(index=i, attempts=1,
                                      error="TimeoutError: job still running",
                                      elapsed_s=float(timeout_s or 0.0), timed_out=True))
        return out
    finally:
        # waiting on a hung job's thread would wedge the whole pool behind it
        pool.shutdown(wait=not timed_out, cancel_futures=timed_out)
