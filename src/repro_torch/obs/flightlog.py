"""Structured control-plane flight log (DESIGN.md §16).

One JSONL file per run, written next to the co-sim epoch journal and
sharing its schema version (``cosim.JOURNAL_SCHEMA_VERSION == 2`` — the
flight log is journal schema v2 with ``journal: "flight"``, not a second
schema).  Line 0 is the header (run id + ``obs.runmeta()`` provenance);
every following line is one event ``{"kind": ..., "ts_s": <unix s>, ...}``.
Counters, gauges, and histograms are plain fields on typed events rather
than a separate metric taxonomy — the consumers (``obs.trace_export``,
``obs.features.epoch_matrix``, ``scripts/obs_report.py``) read kinds:

  * ``campaign``  — fault-campaign / scenario description at run start
  * ``epoch``     — one per planning epoch: wall-clock span, FCT stats,
    plan version/churn, quarantine + watchdog + telemetry-channel state,
    sweep compile/retry counters, hot uplinks, fault activations, and the
    drained in-sim ring summary under ``insim``
  * ``run_end``   — convergence summary + totals
  * ``profile``   — benchmarks/run.py --profile phase rows (min/mean/std)
  * ``counter``   — generic named counter sample

Writes are line-buffered and flushed per event; ``read_flight`` tolerates
a torn tail (a crashed run's last partial line is dropped, same contract
as the epoch journal) and refuses other schema versions loudly
(``FlightLogError``).
"""
from __future__ import annotations

import json
import time

#: Must track cosim.JOURNAL_SCHEMA_VERSION — asserted in tests/test_obs.py.
SCHEMA_VERSION = 2


class FlightLogError(RuntimeError):
    """Flight-log file unreadable or from an incompatible schema."""


class FlightLog:
    """Append-only JSONL event writer.  ``close()`` is idempotent."""

    def __init__(self, path, *, meta: dict | None = None,
                 run_id: str | None = None):
        from repro_torch import obs  # deferred: obs/__init__ imports this module

        self.path = str(path)
        rm = obs.runmeta()
        self.run_id = run_id or rm["run_id"]
        self._fh = open(self.path, "a")
        header = {"journal": "flight", "schema_version": SCHEMA_VERSION,
                  "run_id": self.run_id, "runmeta": rm}
        if meta:
            header["meta"] = meta
        self._write(header)

    def _write(self, obj: dict):
        if self._fh is None:
            return
        self._fh.write(json.dumps(obj) + "\n")
        self._fh.flush()

    def event(self, kind: str, **fields):
        """One event line.  ``ts_s`` is stamped here unless the caller
        passes its own (e.g. an epoch's true start time)."""
        rec = {"kind": kind}
        rec.setdefault("ts_s", fields.pop("ts_s", time.time()))
        rec.update(fields)
        self._write(rec)

    def counter(self, name: str, value, **fields):
        self.event("counter", name=name, value=value, **fields)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_flight(path) -> tuple[dict, list]:
    """(header, events) from a flight-log file.

    Skips blank lines, drops a torn tail, tolerates appended restart
    headers (same run id appending after a resume), and raises
    ``FlightLogError`` on a missing header or a schema-version mismatch."""
    header = None
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                break  # torn tail: a crash mid-write loses only that line
            if obj.get("journal") == "flight":
                if obj.get("schema_version") != SCHEMA_VERSION:
                    raise FlightLogError(
                        f"{path}: flight schema v{obj.get('schema_version')} "
                        f"!= v{SCHEMA_VERSION} (refusing to guess)")
                if header is None:
                    header = obj
                continue  # restart header mid-file: keep reading events
            if header is None:
                raise FlightLogError(f"{path}: first line is not a flight "
                                     "header")
            records.append(obj)
    if header is None:
        raise FlightLogError(f"{path}: empty or headerless flight log")
    return header, records
