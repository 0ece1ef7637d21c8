"""The port's epoch driver (``repro_torch.dist.cosim.run_cosim``) against
the JAX package's on the same specs, on the CPU at small sizes: the
killed-spine scenario of tests/test_adaptive_dt.py (``COSIM_GOLD``'s
spec, held to the live JAX run, not to its goldens), a chaos campaign
with in-epoch replanning and a straggler, a telemetry channel with loss
and delay, one with a blackout (safe mode), and the recorder with a
flight log.  Every JAX run starts from an empty executable cache
(``sweep.clear_cache()``): the JAX sweep reuses a program across
topologies of one shape.

Run as a script to regenerate ``src/repro_torch/netsim/cosim_reference.json``,
the JAX package's runs of ``chip_smoke.py`` phase 11's cases
(``chip_smoke.cosim_cases``; a few minutes on 8 cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_cosim.py --write-cosim-reference
"""
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.dist import cosim as jc  # noqa: E402
from repro.netsim import faults as jf, sweep as js, topology as jt  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.dist import cosim as tc  # noqa: E402
from repro_torch.netsim import faults as tf, topology as tt  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "src" / "repro_torch" / "netsim" / "cosim_reference.json"
DT = 10e-6
# the fields of each epoch that must be equal
EQUAL = ("quarantined", "reported_slow", "plan_version", "plan_churn", "spill_steps",
         "replan_round", "straggler_quarantined", "straggler_scale", "safe_mode",
         "reports_sent", "reports_delivered", "reports_admitted", "reports_stale",
         "reports_duplicate", "ff_steps")


def _jax(spec):
    js.clear_cache()
    try:
        return jc.run_cosim(**spec)
    finally:
        js.clear_cache()


def _ls444(pkg):
    return (jt.leaf_spine(4, 4, 4, 100e9) if pkg == "jax"
            else tt.leaf_spine(4, 4, 4, 100e9, device="cpu"))


def _pair(build):
    """(JAX history, port history) of ``build(cosim, faults, topology,
    topo)``'s spec in each package, on leaf_spine(4, 4, 4)."""
    want = _jax(build(jc, jf, jt, _ls444("jax")))
    got = tc.run_cosim(**build(tc, tf, tt, _ls444("torch")), device="cpu")
    return want, got


def _assert_same_epochs(got, want, fields=EQUAL):
    """Per epoch: the fields equal; the censored p50 and p99 within one dt
    step; the completion within one flow in 1e3."""
    assert len(got.records) == len(want.records)
    for g, w in zip(got.records, want.records):
        for f in fields:
            assert getattr(g, f) == getattr(w, f), (g.epoch, f, getattr(g, f), getattr(w, f))
        for f in ("fct_p50_s", "fct_p99_s"):
            assert abs(getattr(g, f) - getattr(w, f)) <= DT + 1e-9, (g.epoch, f)
        assert abs(g.completion - w.completion) <= 1e-3, g.epoch
        assert g.new_builds == 0  # the CPU loads no kernel library
    assert got.plan_refused == want.plan_refused == 0
    assert [p.inactive for p in got.plans] == [p.inactive for p in want.plans]
    assert got.final_plan.inactive == want.final_plan.inactive


def _killed(cosim, topo, **kw):
    """tests/test_adaptive_dt.py's COSIM_GOLD spec: SeqBalance on a ring of
    8 at 4 MB, spine 2 killed at epoch 1 and back at 3, 4 epochs."""
    spec = dict(topo=topo, hosts=cosim.ring_hosts(topo, 8), size_bytes=4e6,
                scheme="seqbalance", epochs=4, phi_steps=2, n_chunks=4, seed=0,
                faults=(cosim.kill_spine(topo, 2, epoch=1, recover_epoch=3),))
    spec.update(kw)
    return spec


def test_killed_spine_matches_reference():
    """The COSIM_GOLD scenario: the same quarantined sets, reports, plans
    and convergence epoch as the live JAX run, p99/p50 to the same dt
    step."""
    want, got = _pair(lambda cosim, faults, topology, topo: _killed(cosim, topo))
    _assert_same_epochs(got, want)
    assert [r.quarantined for r in got.records] == [(), (), (2,), (2,)]
    assert got.convergence_epoch(1) == want.convergence_epoch(1) is not None
    assert got.health.expiry(2) == want.health.expiry(2)


def _campaign(cosim, faults, topology, topo):
    """A flap kill of spine 1 at onset 0.02 in epochs 1-2 (in-epoch
    replanning), 1 % loss on spine 3 in epochs 2-3, rank 2 a 3x straggler
    in epochs 1-3; ECMP, cooldown 2, 4 epochs."""
    camp = faults.FaultCampaign(events=(
        faults.LinkFlap(links=topology.spine_links(topo, 1), start_epoch=1, end_epoch=3,
                        duty=1.0, onset_frac=0.02, scale=0.0),
        faults.LossyLink(links=topology.spine_links(topo, 3), loss_rate=0.01, start_epoch=2,
                         end_epoch=4),
        faults.Straggler(rank=2, slowdown=3.0, start_epoch=1, end_epoch=4)))
    return dict(topo=topo, hosts=cosim.ring_hosts(topo, 8), size_bytes=4e6, scheme="ecmp",
                epochs=4, phi_steps=2, cooldown_steps=2, n_chunks=4, seed=0, campaign=camp)


def test_campaign_replans_in_epoch_and_benches_the_straggler():
    want, got = _pair(_campaign)
    _assert_same_epochs(got, want)
    assert max(r.replan_round for r in got.records) > 0
    assert any(r.straggler_quarantined for r in got.records)
    assert any(r.straggler_scale > 1.0 for r in got.records)


@pytest.mark.parametrize("cell", ["loss_delay", "blackout"])
def test_telemetry_channel_matches_reference(cell):
    """The killed spine's reports through a TelemetryChannel: 30 % loss and
    a 2-epoch delay, or a blackout of epochs 0-3 that puts the driver in
    safe mode; the report counts and safe mode per epoch equal the JAX
    package's, the plan versions strictly increase."""
    def build(cosim, faults, topology, topo):
        if cell == "loss_delay":
            ch = faults.TelemetryChannel(loss=0.3, delay_epochs=2, seed=7)
            return _killed(cosim, topo, scheme="ecmp", epochs=5, telemetry=ch,
                           staleness_bound=2)
        ch = faults.TelemetryChannel(loss=0.0, delay_epochs=0, seed=7, blackout=(0, 3))
        return _killed(cosim, topo, scheme="ecmp", epochs=5, telemetry=ch, staleness_bound=2,
                       blackout_epochs=2)
    want, got = _pair(build)
    _assert_same_epochs(got, want)
    vs = [r.plan_version for r in got.records]
    assert all(b > a for a, b in zip(vs, vs[1:]))
    assert all(r.reports_sent > 0 for r in got.records)
    if cell == "blackout":
        assert any(r.safe_mode for r in got.records)
        assert not got.records[-1].safe_mode


def test_record_and_flight_log(tmp_path):
    """``record=`` puts each epoch's recorder summary on the record, as the
    JAX package's; ``flight=`` writes one campaign event, an epoch event an
    epoch and a run_end that the port's flight-log reader parses."""
    def build(cosim, faults, topology, topo):
        spec = (jobs if cosim is jc else tobs).RecordSpec(ring_chunks=16)
        return _killed(cosim, topo, epochs=3, record=spec,
                       flight=str(tmp_path / f"{cosim.__name__}.jsonl"))
    want, got = _pair(build)
    _assert_same_epochs(got, want)
    for g, w in zip(got.records, want.records):
        assert g.insim["chunks_recorded"] == w.insim["chunks_recorded"]
        assert g.insim["chunks"]["steps"] == w.insim["chunks"]["steps"]
        for k in ("goodput_mean_bps", "queue_mean_bytes"):
            assert g.insim[k] == pytest.approx(w.insim[k], rel=1e-3, abs=1e-6)
        np.testing.assert_allclose(g.insim["uplink"]["util_mean"],
                                   w.insim["uplink"]["util_mean"], rtol=1e-3, atol=1e-6)
    head, events = tobs.read_flight(tmp_path / f"{tc.__name__}.jsonl")
    kinds = [e["kind"] for e in events]
    assert kinds == ["campaign"] + ["epoch"] * 3 + ["run_end"]
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert [e["quarantined"] for e in epochs] == [list(r.quarantined) for r in got.records]
    assert events[-1]["convergence_epoch"] == want.convergence_epoch(1)
    _, jevents = jobs.read_flight(tmp_path / f"{jc.__name__}.jsonl")
    assert [e["kind"] for e in jevents] == kinds


def write_cosim_reference() -> None:
    """Run the JAX package on chip_smoke.py phase 11's cases and record
    what phase 11 compares of each history (``chip_smoke.cosim_row``)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    cases = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, runs in chip_smoke.cosim_cases(jc, jf, jt, jobs, {}, tmp).items():
            cases[name] = {}
            for label, spec in runs:
                hist = _jax(spec)
                cases[name][label] = chip_smoke.cosim_row(hist)
                print(name, label, cases[name][label]["convergence_epoch"],
                      [round(r.fct_p99_s * 1e6, 1) for r in hist.records], flush=True)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip()
    REFERENCE.write_text(json.dumps({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_cosim.py "
                   "--write-cosim-reference",
        "source": "JAX package, dist.cosim.run_cosim on chip_smoke.cosim_cases, each from "
                  "an empty executable cache; chip_smoke.cosim_row of each history",
        "commit": commit, "backend": "cpu", "cases": cases,
    }, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-cosim-reference"]:
        write_cosim_reference()
    else:
        sys.exit("usage: test_torch_cosim.py --write-cosim-reference")
