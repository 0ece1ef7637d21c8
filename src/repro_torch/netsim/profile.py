"""Per-phase timing of the compact-engine step, mirroring
``repro.netsim.profile``.

The compact step is composed of four phase closures (``compact.
build_compact_sim`` returns them beside ``step_fn``, which runs them):

  admit   - searchsorted admission, slot resets, route-cache fill, routing
  cascade - offered rates -> NIC-tiered hop cascade -> queue/ECN marks
  dcqcn   - per-sub-flow rate control update
  finish  - transfer progress, bitmap CQE, scatter-on-finish, table update
  quiesce - adaptive-dt quiescence predicate (one chunk-boundary check)

``quiescence_profile`` replays a fixed-dt run chunk by chunk and records
which chunk boundaries the adaptive engine would have fast-forwarded: the
share of the horizon coverable in closed form and the macro-step length
histogram.

Each phase is timed alone on one mid-simulation state (the same state for
every phase, reached by ``warm_steps`` real steps).  On the card each call
is bracketed by ``torch.cuda.synchronize``, so a time is the call's host
work and its kernels together.  The isolated phases do not add up exactly
to the step, so the whole step is reported beside them as ``step_fused``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.netsim import compact, sweep
from repro_torch.netsim.engine import SimConfig
from repro_torch.netsim.topology import Topology
from repro_torch.netsim.workloads import Trace


class TimeUs(float):
    """A per-call time in µs that is still a float (the min over the
    iterations, the least noisy estimate) and keeps every sample:
    ``.min_us`` / ``.mean_us`` / ``.std_us`` / ``.samples``, or all four
    through ``.stats()``."""

    __slots__ = ("samples",)

    def __new__(cls, samples):
        samples = [float(s) for s in samples]
        self = super().__new__(cls, min(samples))
        self.samples = samples
        return self

    @property
    def min_us(self) -> float:
        return float(self)

    @property
    def mean_us(self) -> float:
        return sum(self.samples) / len(self.samples)

    @property
    def std_us(self) -> float:
        m = self.mean_us
        return (sum((s - m) ** 2 for s in self.samples) / len(self.samples)) ** 0.5

    def stats(self) -> dict:
        """JSON-able {min_us, mean_us, std_us, iters}."""
        return dict(min_us=round(self.min_us, 3), mean_us=round(self.mean_us, 3),
                    std_us=round(self.std_us, 3), iters=len(self.samples))


def _time_us(fn, *args, iters: int, device: torch.device) -> TimeUs:
    """``fn(*args)`` once to warm, then ``iters`` timed calls, each between
    two synchronizations of the card (none on the CPU)."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    fn(*args)
    sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        samples.append((time.perf_counter() - t0) * 1e6)
    return TimeUs(samples)


def _build(topo: Topology, cfg: SimConfig, trace, device):
    """The compact simulation of ``trace``: (topo on the device,
    init_state, step_fn, phases, W).  A Trace is planned as the JAX
    package plans one; a list of them is run as one batch, planned as
    ``sweep.run_batch`` plans a bucket, which the JAX package's
    ``profile_phases`` does not take: the batch is there for
    ``chip_smoke.py`` phase 6, which times the fig12 sweep's batch of two."""
    topo = topo.to(device)
    traces = trace if isinstance(trace, (list, tuple)) else [trace]
    prepped = [compact.sort_trace(t) for t in traces]
    if len(prepped) == 1:  # as the JAX package plans a single trace
        arrays, _, F = prepped[0]
        F_pad = max(F, 1)
        W, A = compact.plan_single_window(topo, cfg, arrays, F_pad)
        padded = [compact.pad_trace_arrays(arrays, F_pad)]
    else:
        F_pad, W, A, padded = sweep.plan_group(topo, cfg, prepped)
    tensors = sweep.stack_group(padded, list(range(len(padded))), device)
    init, step_fn, phases = compact.build_compact_sim(topo, cfg, tensors, W, F_pad, A)
    return topo, init, step_fn, phases, W


def profile_phases(topo: Topology, cfg: SimConfig, trace: Trace | list, *,
                   warm_steps: int = 200, iters: int = 30, device=None) -> dict:
    """Time each compact-step phase on a warmed mid-simulation state.
    Returns {phase: µs (TimeUs)} for ``admit``, ``cascade``, ``dcqcn``,
    ``finish``, ``step_fused`` (the whole step) and ``quiesce`` (one
    check of a chunk), ``phase_sum`` (the four step phases added up) and
    ``window_slots``."""
    device = resolve_device(device)
    _, init, step_fn, phases, W = _build(topo, cfg, trace, device)
    st = init()
    for _ in range(warm_steps):
        st, _ = step_fn(st)
    t = st.step.to(torch.float32) * cfg.dt
    K, _, _ = compact.plan_chunks(cfg, int(round(cfg.duration_s / cfg.dt)))
    admit, cascade = phases["admit"], phases["cascade"]
    st_admit = admit(st)
    arrival, new_queue, thr, p_sub, p_fab, rc, active = cascade(st_admit)

    def timed(fn, *args):
        return _time_us(fn, *args, iters=iters, device=device)

    out = {
        "admit": timed(admit, st),
        "cascade": timed(cascade, st_admit),
        "dcqcn": timed(phases["dcqcn"], st_admit, p_sub, active),
        "finish": timed(phases["finish"], st_admit, t, thr, active, rc, p_fab),
        "step_fused": timed(step_fn, st),
        "quiesce": timed(phases["quiesce"], st, K),
    }
    out["phase_sum"] = sum(out[k] for k in ("admit", "cascade", "dcqcn", "finish"))
    out["window_slots"] = W
    return out


def quiescence_profile(topo: Topology, cfg: SimConfig, trace: Trace, *,
                       iters: int = 30, device=None) -> dict:
    """Quiescence occupancy of one simulation: replay the fixed-dt
    trajectory chunk by chunk, evaluating the adaptive engine's predicate
    at every chunk boundary without fast-forwarding (so the trajectory
    stays the oracle's).  Returns:

      ff_fraction   - share of the chunks that were quiescent (what the
                      adaptive engine would cover in closed form)
      macro_hist    - {macro-step length in dt steps: count} from runs of
                      consecutive quiescent chunks
      predicate_us  - one predicate evaluation alone (what the adaptive
                      engine pays at a boundary on top of the steps)
      chunk_steps / n_chunks - the event grid's geometry
    """
    device = resolve_device(device)
    _, init, step_fn, phases, _ = _build(topo, cfg, trace, device)
    n_steps = int(round(cfg.duration_s / cfg.dt))
    K, n_chunks, _ = compact.plan_chunks(cfg, n_steps)
    quiesce = phases["quiesce"]
    st, flags = init(), []
    for _ in range(n_chunks):  # stepped, never fast-forwarded
        flags.append(quiesce(st, K)[1][0])
        for _ in range(K):
            st, _ = step_fn(st)
    quiet = torch.stack(flags).cpu().numpy() if flags else np.zeros(0, bool)
    hist: dict[int, int] = {}
    run = 0
    for q in list(quiet) + [False]:  # the trailing False closes the last run
        if q:
            run += 1
        elif run:
            hist[run * K] = hist.get(run * K, 0) + 1
            run = 0
    return {
        "ff_fraction": float(quiet.mean()) if quiet.size else 0.0,
        "macro_hist": hist,
        "predicate_us": _time_us(lambda s: quiesce(s, K), init(), iters=iters,
                                 device=device),
        "chunk_steps": K,
        "n_chunks": n_chunks,
    }
