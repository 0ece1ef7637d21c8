"""Text dashboard for a co-sim flight log (DESIGN.md §16): the twin of
``scripts/obs_report.py`` on ``repro_torch.obs.read_flight``, its text the
same for the same flight log.

Reads the schema-v2 JSONL written by ``dist.cosim.run_cosim(flight=...)``
and prints the run at a glance: per-epoch FCT / plan churn / quarantine /
safe-mode / fast-forward table, the hottest uplinks across the run, fault
activations, telemetry verdict counters, and the sweep's build +
resilience totals.  It reads a file only: nothing runs on a device.

    python -m repro_torch.obs.report flight.jsonl [--top 5]
"""
from __future__ import annotations

import argparse
import sys


def report(path: str, top: int = 5) -> int:
    from repro_torch.obs import read_flight

    header, records = read_flight(path)
    epochs = [r for r in records if r.get("kind") == "epoch"]
    camp = next((r for r in records if r.get("kind") == "campaign"), {})
    end = next((r for r in records if r.get("kind") == "run_end"), {})

    rm = header.get("runmeta") or {}
    print(f"flight {path}")
    print(f"  run {header.get('run_id', '?')}  git {rm.get('git_sha', '?')}"
          f"  host {rm.get('host', '?')}  devices {rm.get('n_devices', '?')}")
    print(f"  scheme {camp.get('scheme', '?')}  epochs "
          f"{len(epochs)}/{camp.get('epochs', '?')}  "
          f"n_steps {camp.get('n_steps', '?')}  "
          f"faults {camp.get('n_faults', 0)}")
    if not epochs:
        print("  (no epoch records)")
        return 1

    print(f"\n  {'ep':>3} {'p99_us':>10} {'compl':>6} {'churn':>5} "
          f"{'quar':>8} {'safe':>4} {'ff%':>5} {'builds':>6} {'faults':>16}")
    for r in epochs:
        ins = r.get("insim") or {}
        n_steps = r.get("n_steps") or 0
        ffpct = 100.0 * ins.get("ff_steps", 0) / n_steps if n_steps else 0.0
        faults = ",".join(f.get("kind", "?") for f in r.get("faults") or ())
        print(f"  {r.get('epoch', -1):>3} {r.get('fct_p99_us', 0):>10.1f} "
              f"{r.get('completion', 0):>6.3f} {r.get('plan_churn', 0):>5} "
              f"{str(r.get('quarantined') or '-'):>8} "
              f"{'Y' if r.get('safe_mode') else '.':>4} {ffpct:>5.1f} "
              f"{r.get('new_builds', 0):>6} {faults or '-':>16}")

    # hottest uplinks across the whole run (max util per (leaf, uplink))
    hot: dict[tuple, dict] = {}
    for r in epochs:
        for h in r.get("hot_uplinks") or ():
            k = (h.get("leaf"), h.get("uplink"))
            if k not in hot or h["util"] > hot[k]["util"]:
                hot[k] = h
    if hot:
        print(f"\n  hottest uplinks (top {top}, max over epochs):")
        for h in sorted(hot.values(), key=lambda d: -d["util"])[:top]:
            print(f"    leaf {h['leaf']} uplink {h['uplink']} "
                  f"(link {h['link']}): util {h['util']:.3f}  "
                  f"offered {h['offered_gbps']:.2f} Gb/s")

    last = epochs[-1]
    wd = last.get("watchdog") or {}
    if wd:
        t = wd.get("transitions") or {}
        print(f"\n  watchdog: silent {wd.get('silent')} safe "
              f"{wd.get('safe')}  transitions "
              + " ".join(f"{k}={t.get(k, 0)}" for k in
                         ("ok", "silent", "safe", "recovered")))
    sw = (end.get("sweep") or last.get("sweep")) or {}
    if sw:
        print("  sweep: " + "  ".join(f"{k} {v}" for k, v in sw.items()))
    if end:
        print(f"  run_end: convergence_epoch {end.get('convergence_epoch')}"
              f"  plan_refused {end.get('plan_refused')}  total_new_builds "
              f"{end.get('total_new_builds')}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="text dashboard for a cosim flight log")
    ap.add_argument("flight", help="flight-log JSONL path")
    ap.add_argument("--top", type=int, default=5,
                    help="hottest-uplink rows to show")
    args = ap.parse_args(argv)
    return report(args.flight, top=args.top)


if __name__ == "__main__":
    sys.exit(main())
