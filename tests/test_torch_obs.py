"""The port's flight recorder (``repro_torch.obs``) against the JAX
package's: ``record_chunk``, ``drain`` (a ring that wraps included) and
``epoch_summary`` on the same inputs; whole runs of
``benchmarks/paper_benches.py::_collective_setup``'s collective with the
ring on, whose finish times must not move; a batch whose rings equal each
simulation's ring alone; the ring carried across from the reference; and
the copied flight log, feature matrix and trace export.

Run as a script to regenerate ``src/repro_torch/netsim/record_reference.json``,
the JAX package's rings for ``chip_smoke.py`` phase 10 (about two minutes
on 8 cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_obs.py --write-record-reference
"""
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.dist import collectives as j_col, cosim as j_cos  # noqa: E402
from repro.netsim import engine as je, sweep as js, topology as jt, workloads as jw  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.dist import collectives as t_col, cosim as t_cos  # noqa: E402
from repro_torch.netsim import carry, compact as tc, engine as te, sweep as ts  # noqa: E402
from repro_torch.netsim import topology as tt, workloads as tw  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "src" / "repro_torch" / "netsim" / "record_reference.json"
COLLECTIVE_CFG = dict(scheme="seqbalance", duration_s=14e-3, uplink_sample_every=10)


def _collective(wl, col, cos, topo):
    """_collective_setup's trace: a 4-chunk ring of 8, 4 MB, 800 us gaps."""
    plan = col.PathPlan(n_chunks=4, directions=(1, -1, 1, -1))
    return wl.collective_trace(plan, cos.ring_hosts(topo, 8), 4e6, link_bw=100e9,
                               round_gap_s=800e-6, seed=0, steer_paths=topo.n_paths)


def _chunk_inputs(rng, W=40, N=4, U=6):
    """One chunk's summary inputs, from numpy."""
    active = rng.random((W, N)) < rng.uniform(0.0, 0.9)
    return dict(step0=int(rng.integers(0, 1000)), steps=int(rng.integers(1, 40)),
                ff=int(rng.integers(0, 2)),
                queue_max=np.float32(rng.uniform(0, 1e6)),
                queue_mean=np.float32(rng.uniform(0, 1e5)),
                cnp=np.float32(rng.uniform(0, 50)), goodput=np.float32(rng.uniform(0, 1e12)),
                offered=rng.uniform(0, 1e11, U).astype(np.float32),
                cap=rng.uniform(1e10, 1e11, U).astype(np.float32),
                rc=np.round(rng.uniform(1e9, 1e11, (W, N)), -9).astype(np.float32),
                active=active)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_record_chunk_drain_and_summary_match_reference(seed):
    """A ring of 4 rows written 7 times (it wraps), with rates that tie and
    chunks with no active sub-flow: every row, the drained order and the
    epoch summary equal the reference's."""
    rng = np.random.default_rng(seed)
    spec_j, spec_t = jobs.RecordSpec(ring_chunks=4), tobs.RecordSpec(ring_chunks=4)
    ring_j, ring_t = jobs.ring_init(spec_j, 6), tobs.ring_init(spec_t, 6, device="cpu")
    for i in range(7):
        c = _chunk_inputs(rng)
        if i == 3:
            c["active"][:] = False
        ring_j = jobs.record_chunk(spec_j, ring_j, **{k: jnp.asarray(v) if isinstance(
            v, np.ndarray) else v for k, v in c.items()})
        ring_t = tobs.record_chunk(spec_t, ring_t, **{
            k: torch.as_tensor(v)[None] if isinstance(v, np.ndarray) and k != "cap"
            else (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in c.items()})
    np.testing.assert_array_equal(ring_t.meta[0].numpy(), np.asarray(ring_j.meta))
    np.testing.assert_array_equal(ring_t.uplink[0].numpy(), np.asarray(ring_j.uplink))
    assert int(ring_t.count[0]) == int(ring_j.count) == 7
    dj, dt_ = jobs.drain(spec_j, ring_j), tobs.drain(spec_t, ring_t)
    assert dt_["fields"] == dj["fields"] and dt_["chunks_kept"] == 4
    np.testing.assert_array_equal(dt_["meta"], dj["meta"])
    np.testing.assert_array_equal(dt_["uplink"], dj["uplink"])
    assert tobs.epoch_summary(spec_t, dt_) == jobs.epoch_summary(spec_j, dj)
    assert dt_["meta"][-1, 0] == ring_t.meta[0, 6 % 4, 0]  # the newest write is last


@functools.lru_cache(maxsize=None)
def _ls444_runs(adaptive: bool):
    """The collective on leaf_spine(4, 4, 4) in both packages, recorded, and
    the port's without the ring."""
    spec = dict(ring_chunks=16)  # 53 chunks: the ring wraps
    jtopo, ttopo = jt.leaf_spine(4, 4, 4, 100e9), tt.leaf_spine(4, 4, 4, 100e9, device="cpu")
    cfg = dict(COLLECTIVE_CFG, adaptive=adaptive)
    js.clear_cache()  # no program of another topology of this shape (see test_torch_flowcell)
    jr, _ = js.run_one(jtopo, je.SimConfig(**cfg), _collective(jw, j_col, j_cos, jtopo),
                       record=jobs.RecordSpec(**spec))
    js.clear_cache()
    trace = _collective(tw, t_col, t_cos, ttopo)
    tr, touts = ts.run_one(ttopo, te.SimConfig(**cfg), trace, record=tobs.RecordSpec(**spec),
                           device="cpu")
    plain, pouts = ts.run_one(ttopo, te.SimConfig(**cfg), trace, device="cpu")
    return jr, (tr, touts), (plain, pouts), spec


def _rings_agree(spec, got, want):
    """The port's drained ring against the reference's: the same chunks
    and their step0/steps/ff columns; every other column and the uplink
    rows within 1e-6 relative (queues and counts within 1e-3 absolute)."""
    dg, dw = tobs.drain(tobs.RecordSpec(**spec), got), jobs.drain(jobs.RecordSpec(**spec), want)
    assert dg["chunks_recorded"] == dw["chunks_recorded"] > spec["ring_chunks"]
    for i, f in enumerate(dg["fields"]):
        if f in ("step0", "steps", "ff", "active_subflows"):
            np.testing.assert_array_equal(dg["meta"][:, i], dw["meta"][:, i], err_msg=f)
        else:
            np.testing.assert_allclose(dg["meta"][:, i], dw["meta"][:, i], rtol=1e-6,
                                       atol=1e-3, err_msg=f)
    np.testing.assert_allclose(dg["uplink"], dw["uplink"], rtol=1e-6)


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_recording_changes_no_result_and_matches_reference(adaptive):
    """The ring on or off: the same finish times and outputs, bit for bit;
    the ring against the JAX package's, fast-forwarded rows included."""
    jr, (tr, touts), (plain, pouts), spec = _ls444_runs(adaptive)
    np.testing.assert_array_equal(tr.finish, plain.finish)
    assert tr.ff_steps == plain.ff_steps == int(jr.ff_steps)
    for f in te.StepOutputs._fields:
        np.testing.assert_array_equal(getattr(touts, f), getattr(pouts, f), err_msg=f)
    assert plain.ring is None and tr.ring.meta.shape[0] == 1
    _rings_agree(spec, tr.ring, jr.ring)
    if adaptive:
        ff = tobs.drain(tobs.RecordSpec(**spec), tr.ring)["meta"][:, 2]
        assert ff.any() and not ff.all()


def test_batch_rings_equal_each_simulation_alone():
    """B = 2, adaptive: the collective (quiet in its gaps, so it writes
    fast-forward rows while its neighbour steps) beside a Poisson trace
    that ends early (it writes no row past its end): each simulation's
    ring equals the ring it writes alone, bit for bit."""
    topo = tt.leaf_spine(4, 4, 4, 100e9, device="cpu")
    poisson = tw.poisson_trace(tw.TraceConfig(
        workload="alistorage", load=0.5, duration_s=0.8e-3, n_hosts=topo.n_hosts,
        host_bw=100e9, seed=0, hosts_per_leaf=topo.hosts_per_leaf,
        load_base_bw=topo.n_leaf * topo.n_paths * 100e9))
    traces = [_collective(tw, t_col, t_cos, topo), poisson]
    cfg = te.SimConfig(adaptive=True, **COLLECTIVE_CFG)
    spec = tobs.RecordSpec(ring_chunks=32)
    before = tc.run_core.counts["mixed_fast_forwards"]
    batch, _ = ts.run_batch(topo, cfg, traces, window_slots=512, record=spec, device="cpu")
    assert tc.run_core.counts["mixed_fast_forwards"] > before
    counts = [int(r.ring.count[0]) for r in batch]
    assert counts[0] > counts[1] > 0
    for r, trace in zip(batch, traces):
        alone, _ = ts.run_one(topo, cfg, trace, window_slots=512, record=spec, device="cpu")
        np.testing.assert_array_equal(r.finish, alone.finish)
        for f in tobs.RingState._fields:
            np.testing.assert_array_equal(getattr(r.ring, f).numpy(),
                                          getattr(alone.ring, f).numpy(), err_msg=f)


def test_ring_carries_across_from_reference():
    """carry.ring_from_numpy: the reference's ring, one more chunk written
    on each side, gives the same ring."""
    rng = np.random.default_rng(4)
    spec_j, spec_t = jobs.RecordSpec(ring_chunks=3), tobs.RecordSpec(ring_chunks=3)
    ring_j = jobs.ring_init(spec_j, 6)
    for _ in range(4):
        c = _chunk_inputs(rng)
        ring_j = jobs.record_chunk(spec_j, ring_j, **c)
    ring_t = carry.ring_from_numpy({f: np.asarray(v) for f, v in ring_j._asdict().items()},
                                   "cpu")
    c = _chunk_inputs(rng)
    ring_j = jobs.record_chunk(spec_j, ring_j, **c)
    ring_t = tobs.record_chunk(spec_t, ring_t, **{
        k: (torch.as_tensor(v)[None] if k != "cap" else torch.as_tensor(v))
        if isinstance(v, np.ndarray) else v for k, v in c.items()})
    assert tobs.drain(spec_t, ring_t)["chunks_recorded"] == 5
    for f in ("meta", "uplink"):
        np.testing.assert_array_equal(getattr(ring_t, f)[0].numpy(),
                                      np.asarray(getattr(ring_j, f)))


def test_flight_log_round_trip(tmp_path):
    """A flight log written by the port reads back through both packages'
    readers; its feature matrix and trace export equal the reference's."""
    from repro.obs import features as jf, trace_export as jx
    from repro_torch.obs import features as tf, trace_export as tx

    jr, (tr, _), _, spec = _ls444_runs(False)
    insim = tobs.epoch_summary(tobs.RecordSpec(**spec),
                               tobs.drain(tobs.RecordSpec(**spec), tr.ring))
    path = tmp_path / "flight.jsonl"
    log = tobs.FlightLog(path, meta={"case": "ls444"})
    log.event("campaign", scenario="none")
    for e in range(3):
        log.event("epoch", epoch=e, wall_s=0.5 + e, insim=insim,
                  hot_uplinks=[{"leaf": 1, "uplink": 2, "util": 0.9}])
    log.event("run_end", epochs=3)
    log.close()
    log.close()
    header, events = tobs.read_flight(path)
    assert header["runmeta"]["backend"] in ("cpu", "cuda")
    assert (header, events) == jobs.read_flight(path)
    assert [e["kind"] for e in events] == ["campaign"] + ["epoch"] * 3 + ["run_end"]
    assert events[1]["insim"] == json.loads(json.dumps(insim))
    with path.open("a") as fh:
        fh.write('{"kind": "epo')  # a torn tail is dropped
    assert tobs.read_flight(path) == (header, events)
    got, want = tf.epoch_matrix(str(path)), jf.epoch_matrix(str(path))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert tx.chrome_trace(header, events) == jx.chrome_trace(header, events)
    path.write_text('{"journal": "flight", "schema_version": 1}\n')
    with pytest.raises(tobs.FlightLogError):
        tobs.read_flight(path)


def test_record_reference_covers_the_cases():
    """The file chip_smoke.py phase 10 holds the card to: both modes of the
    collective and both simulations of the fig12 batch, each an epoch
    summary with its chunk table."""
    ref = json.loads(REFERENCE.read_text())
    assert ref["backend"] == "cpu" and ref["ring_chunks"] == 64
    runs = ref["cases"]
    assert sorted(runs) == ["record_fig12", "record_ls444"]
    assert sorted(runs["record_ls444"]) == ["adaptive", "fixed"]
    assert sorted(runs["record_fig12"]) == ["alistorage_0.5", "alistorage_0.8"]
    for case in runs.values():
        for run in case.values():
            s = run["summary"]
            assert s["chunks_recorded"] == len(s["chunks"]["step0"]) > 0
            assert s["goodput_mean_bps"] > 0 and len(s["uplink"]["util_mean"]) > 0
    assert runs["record_ls444"]["adaptive"]["summary"]["ff_steps"] > 0


# ------------------------------------------------ the chip_smoke reference
def _fig12_alistorage(topo):
    fabric = topo.n_leaf * topo.n_paths * 100e9
    return [jw.poisson_trace(jw.TraceConfig(
        workload="alistorage", load=load, duration_s=2.5e-3, n_hosts=topo.n_hosts,
        host_bw=100e9, seed=1, hosts_per_leaf=topo.hosts_per_leaf, load_base_bw=fabric))
        for load in (0.5, 0.8)]


def write_record_reference() -> None:
    """Run the JAX package on chip_smoke.py phase 10's cases with
    RecordSpec(ring_chunks=64) and record each simulation's epoch summary
    (its chunk table included) and ff_steps."""
    spec = jobs.RecordSpec(ring_chunks=64)

    def row(res):
        return dict(ff_steps=int(res.ff_steps),
                    summary=jobs.epoch_summary(spec, jobs.drain(spec, res.ring)))

    ls444 = jt.leaf_spine(4, 4, 4, 100e9)
    col = _collective(jw, j_col, j_cos, ls444)
    cases = {"record_ls444": {}, "record_fig12": {}}
    for mode in ("fixed", "adaptive"):
        cfg = je.SimConfig(adaptive=mode == "adaptive", **COLLECTIVE_CFG)
        res, _ = js.run_one(ls444, cfg, col, record=spec)
        cases["record_ls444"][mode] = row(res)
        print("record_ls444", mode, res.ff_steps, flush=True)
    sim2 = jt.sim_2tier()
    cfg = je.SimConfig(scheme="seqbalance", duration_s=10e-3, uplink_sample_every=10)
    results, _ = js.run_batch(sim2, cfg, _fig12_alistorage(sim2), record=spec)
    for load, res in zip((0.5, 0.8), results):
        cases["record_fig12"][f"alistorage_{load}"] = row(res)
        print("record_fig12", load, flush=True)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip()
    REFERENCE.write_text(json.dumps({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_obs.py "
                   "--write-record-reference",
        "source": "JAX package, netsim.sweep.run_one / run_batch with "
                  "obs.RecordSpec(ring_chunks=64); obs.epoch_summary of each drained ring",
        "commit": commit, "backend": "cpu", "ring_chunks": spec.ring_chunks,
        "config": {"record_ls444": COLLECTIVE_CFG,
                   "record_fig12": dict(scheme="seqbalance", duration_s=10e-3,
                                             uplink_sample_every=10)},
        "cases": cases,
    }, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-record-reference"]:
        write_record_reference()
    else:
        sys.exit("usage: test_torch_obs.py --write-record-reference")
