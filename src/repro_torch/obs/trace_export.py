"""Chrome trace-event exporter: flight log -> perfetto-loadable JSON.

Lays a whole co-sim run on one timeline (open the output at
https://ui.perfetto.dev or chrome://tracing):

  * ``epochs`` track    — one "X" span per planning epoch (wall-clock),
    args carrying plan version/churn, builds, FCT stats;
  * ``faults`` track    — one span per active fault per epoch (kind +
    parameters in args), so brownouts/flaps line up under the epochs they
    perturb;
  * ``control`` track   — "C" counter series (plan_churn, quarantined_n,
    new_builds, ff_steps, reports_admitted) perfetto renders as graphs,
    plus instant markers for safe-mode entry/exit;
  * ``in-sim`` track    — the recorder's fast-forwarded chunks placed
    *proportionally* inside their epoch's wall-clock span (sim step ->
    fraction of the epoch), making quiescence occupancy visible at a
    glance.

Timestamps are microseconds relative to the first epoch start (the
trace-event format's native unit).  CLI:

    PYTHONPATH=src python -m repro_torch.obs.trace_export flight.jsonl trace.json
"""
from __future__ import annotations

import json

_PID = 1
_TID_EPOCH, _TID_FAULT, _TID_CTRL, _TID_INSIM = 1, 2, 3, 4

#: epoch-record fields exported as "C" counter series on the control track
_COUNTERS = ("plan_churn", "quarantined_n", "new_builds", "ff_steps",
             "reports_admitted")


def chrome_trace(header: dict, records: list) -> dict:
    """Build the trace-event dict (``{"traceEvents": [...]}``) from a
    parsed flight log.  Pure function of the records — no I/O."""
    ev = [
        {"ph": "M", "pid": _PID, "name": "process_name",
         "args": {"name": f"cosim {header.get('run_id', '?')}"}},
    ]
    for tid, name in ((_TID_EPOCH, "epochs"), (_TID_FAULT, "faults"),
                      (_TID_CTRL, "control"), (_TID_INSIM, "in-sim")):
        ev.append({"ph": "M", "pid": _PID, "tid": tid, "name": "thread_name",
                   "args": {"name": name}})

    epochs = [r for r in records if r.get("kind") == "epoch"]
    if not epochs:
        return {"traceEvents": ev, "displayTimeUnit": "ms"}
    t_base = min(r.get("t0_s", r.get("ts_s", 0.0)) for r in epochs)

    def us(t):
        return round((t - t_base) * 1e6, 1)

    prev_safe = False
    for rec in epochs:
        t0 = rec.get("t0_s", rec.get("ts_s", t_base))
        dur_us = max(float(rec.get("dur_s", 0.0)) * 1e6, 1.0)
        args = {k: rec[k] for k in
                ("plan_version", "plan_churn", "new_builds", "safe_mode",
                 "fct_p50_us", "fct_p99_us", "completion", "quarantined")
                if k in rec}
        ev.append({"ph": "X", "pid": _PID, "tid": _TID_EPOCH,
                   "name": f"epoch {rec.get('epoch')}", "ts": us(t0),
                   "dur": dur_us, "args": args})

        for cname in _COUNTERS:
            if cname == "quarantined_n":
                val = len(rec.get("quarantined") or ())
            elif cname == "reports_admitted":
                val = (rec.get("reports") or {}).get("admitted", -1)
                if val < 0:
                    continue
            else:
                val = rec.get(cname)
                if val is None:
                    continue
            ev.append({"ph": "C", "pid": _PID, "tid": _TID_CTRL,
                       "name": cname, "ts": us(t0), "args": {cname: val}})

        safe = bool(rec.get("safe_mode"))
        if safe != prev_safe:
            ev.append({"ph": "i", "pid": _PID, "tid": _TID_CTRL, "s": "p",
                       "name": "safe-mode " + ("enter" if safe else "exit"),
                       "ts": us(t0)})
            prev_safe = safe

        for f in rec.get("faults") or ():
            ev.append({"ph": "X", "pid": _PID, "tid": _TID_FAULT,
                       "name": f.get("kind", "fault"), "ts": us(t0),
                       "dur": dur_us, "args": f})

        ins = rec.get("insim") or {}
        chunks = ins.get("chunks") or {}
        n_steps = rec.get("n_steps") or 0
        if chunks.get("step0") and n_steps:
            # sim step -> fraction of the epoch's wall-clock span
            scale = dur_us / n_steps
            for s0, stp, ff in zip(chunks["step0"], chunks["steps"],
                                   chunks["ff"]):
                if ff:
                    ev.append({"ph": "X", "pid": _PID, "tid": _TID_INSIM,
                               "name": "fast-forward",
                               "ts": us(t0) + round(s0 * scale, 1),
                               "dur": max(round(stp * scale, 1), 0.1),
                               "args": {"step0": int(s0), "steps": int(stp)}})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def export_chrome_trace(flight_path, out_path) -> dict:
    """Read a flight log, write the Chrome trace JSON, return the trace."""
    from repro_torch.obs.flightlog import read_flight

    header, records = read_flight(flight_path)
    trace = chrome_trace(header, records)
    with open(out_path, "w") as fh:
        json.dump(trace, fh)
    return trace


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="export a flight log as a perfetto-loadable Chrome "
                    "trace-event JSON")
    ap.add_argument("flight", help="flight-log JSONL path")
    ap.add_argument("out", help="output trace JSON path")
    args = ap.parse_args(argv)
    trace = export_chrome_trace(args.flight, args.out)
    print(f"wrote {len(trace['traceEvents'])} events -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
