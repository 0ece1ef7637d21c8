"""The observability plane, mirroring ``repro.obs``:

  * ``recorder``     — the in-simulation ring of per-chunk summaries
    carried through ``compact.run_core`` (``record=None`` adds no
    operation to the step loop);
  * ``flightlog``    — the schema-versioned JSONL control-plane event log;
  * ``trace_export`` / ``features`` — the Chrome-trace exporter and the
    [epoch, uplink, feature] matrix.

``flightlog``, ``features`` and ``trace_export`` are copies of the
reference's (json and numpy only).  ``runmeta()`` stamps records with run
id, git sha, host and device count.
"""
from __future__ import annotations

import functools
import os
import socket
import subprocess
import time
import uuid

from repro_torch.obs.flightlog import (  # noqa: F401
    SCHEMA_VERSION, FlightLog, FlightLogError, read_flight,
)
from repro_torch.obs.recorder import (  # noqa: F401
    META_FIELDS, RecordSpec, RingState, drain, epoch_summary, meta_fields,
    record_chunk, ring_init,
)

#: one run id per process, so that every record this process writes joins
_RUN_ID = uuid.uuid4().hex[:12]


@functools.lru_cache(maxsize=1)
def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def runmeta() -> dict:
    """Provenance stamp: run id, git sha, host, CUDA device count and
    backend ("cuda" or "cpu"), UTC wall clock."""
    import torch

    n_devices = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return dict(
        run_id=_RUN_ID,
        git_sha=_git_sha(),
        host=socket.gethostname(),
        n_devices=int(n_devices),
        backend="cuda" if n_devices else "cpu",
        time_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    )
