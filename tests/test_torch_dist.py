"""The port's ``dist/`` host side against the JAX package's on the same
inputs: ``PathPlan``/``PinnedPlan``/``apply_plan``/``replan_chunk_paths``
(the cases of tests/test_dist_extra.py), ``LinkHealth`` (phi expiry, its
seeded regression, hysteresis and admission), the watchdog, the
straggler policy and the remesh plan, ``netfeed``'s overload and
dead-capacity rules and the three_tier uplink -> paths fan-out, one
``co_simulate`` cycle, and the epoch driver's flowcells, journal and grid
(``run_jobs``' salvage, retries and backoff).  CPU, small sizes."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist import collectives as jcol, cosim as jc, elastic as jel  # noqa: E402
from repro.dist import netfeed as jnf  # noqa: E402
from repro.netsim import sweep as js, topology as jt  # noqa: E402
from repro_torch.dist import collectives as tcol, cosim as tc, elastic as tel  # noqa: E402
from repro_torch.dist import netfeed as tnf  # noqa: E402
from repro_torch.netsim import sweep as ts, topology as tt  # noqa: E402


class _Outs:
    def __init__(self, uplink_load):
        self.uplink_load = uplink_load


def _random_plan(rng, pinned: bool):
    n_paths = int(rng.integers(1, 9))
    n_chunks = int(rng.integers(1, 13))
    inactive = tuple(bool(b) for b in rng.integers(0, 2, n_paths))
    kw = dict(n_chunks=n_chunks, directions=jel.alternating_directions(n_paths),
              inactive=inactive, flowcells=int(rng.integers(1, 5)),
              version=int(rng.integers(0, 9)))
    if pinned:
        kw["paths"] = tuple(int(p) for p in rng.integers(0, n_paths, n_chunks))
    return kw


@pytest.mark.parametrize("pinned", [False, True], ids=["PathPlan", "PinnedPlan"])
def test_plans_match_reference(pinned):
    """chunk -> path and flowcell -> path tables, over random plans (total
    quarantine included: the primary path carries the traffic)."""
    rng = np.random.default_rng(3)
    for _ in range(300):
        kw = _random_plan(rng, pinned)
        cls_j = jcol.PinnedPlan if pinned else jcol.PathPlan
        cls_t = tcol.PinnedPlan if pinned else tcol.PathPlan
        pj, pt = cls_j(**kw), cls_t(**kw)
        assert pt.chunk_paths() == pj.chunk_paths()
        assert pt.flowcell_paths() == pj.flowcell_paths()
        assert pt.n_paths == pj.n_paths and pt.version == pj.version
        if not pinned and all(kw["inactive"]):
            assert pt.chunk_paths() == (0,) * kw["n_chunks"]


def test_plan_fields_are_checked():
    with pytest.raises(ValueError):
        tcol.PathPlan(wire_dtype="float16")
    with pytest.raises(ValueError):
        tcol.PinnedPlan(n_chunks=2, directions=(1, -1), inactive=(False, False), paths=(0,))
    with pytest.raises(ValueError):
        tcol.PinnedPlan(n_chunks=1, directions=(1, -1), inactive=(False, False), paths=(2,))
    plan = tcol.PathPlan(wire_dtype="int8", version=3)
    assert plan.wire_dtype == "int8" and plan.inactive == (False, False)


def test_apply_plan_refuses_stale_and_repeated_versions():
    rng = np.random.default_rng(5)
    for _ in range(100):
        a, b = (int(v) for v in rng.integers(0, 5, 2))
        cur = [m.PathPlan(version=a) for m in (jcol, tcol)]
        cand = [m.PathPlan(version=b, inactive=(True, False)) for m in (jcol, tcol)]
        (aj, tj), (at, tt_) = (m.apply_plan(c, d) for m, c, d in zip((jcol, tcol), cur, cand))
        assert tt_ == tj == (b > a)
        assert (at is cand[1]) == (aj is cand[0])


def test_replan_chunk_paths_matches_reference():
    """Movers stay in their ring direction, in-flight chunks never move,
    and a chunk with no same-direction survivor stays; random cases."""
    rng = np.random.default_rng(9)
    for _ in range(400):
        n_paths = int(rng.integers(1, 9))
        dirs = tuple(int(d) for d in rng.choice([1, -1], n_paths))
        inactive = tuple(bool(b) for b in rng.integers(0, 2, n_paths))
        paths = tuple(int(p) for p in rng.integers(0, n_paths, int(rng.integers(1, 12))))
        flight = tuple(int(c) for c in rng.integers(0, len(paths), int(rng.integers(0, 3))))
        got = tcol.replan_chunk_paths(paths, dirs, inactive, flight)
        assert got == jcol.replan_chunk_paths(paths, dirs, inactive, flight)
        for c, (p0, p1) in enumerate(zip(paths, got)):
            assert dirs[p0] == dirs[p1]
            if c in flight:
                assert p0 == p1


def test_phi_expiry_releases_exactly_phi_steps_after_last_report():
    """tests/test_dist_extra.py's case on the port's LinkHealth."""
    lh = tel.LinkHealth(n_paths=6, phi_steps=5)
    lh.report_slow(2, step=10)
    assert lh.expiry(2) == 15
    assert lh.plan(14).inactive[2] and 2 not in lh.plan(14).chunk_paths()
    assert not lh.plan(15).inactive[2]
    assert 2 in lh.plan(15, n_chunks=12).chunk_paths()
    lh.report_slow(2, step=13)
    assert lh.expiry(2) == 18
    assert lh.plan(17).inactive[2] and not lh.plan(18).inactive[2]
    lh.report_slow(2, step=11)  # out of order: the window does not shrink
    assert lh.expiry(2) == 18
    assert lh.plan(18, version=7).version == 7 and lh.plan(18).version == 18


@pytest.mark.parametrize("cooldown", [0, 3])
def test_link_health_seeded_regression_matches_reference(cooldown):
    """Random reports and admissions into both packages' LinkHealth (with
    and without flap hysteresis): the same verdicts, inactive sets,
    expiries and snapshots, and a restored copy that goes on alike."""
    rng = np.random.default_rng(7 + cooldown)
    for _ in range(150):
        n_paths, phi = int(rng.integers(1, 8)), int(rng.integers(1, 9))
        kw = dict(n_paths=n_paths, phi_steps=phi, cooldown_steps=cooldown,
                  max_phi_steps=0 if rng.random() < 0.5 else 4 * phi,
                  max_staleness_epochs=None if rng.random() < 0.3 else int(rng.integers(0, 3)))
        hj, ht = jel.LinkHealth(**kw), tel.LinkHealth(**kw)
        newest = {}
        for _ in range(int(rng.integers(1, 14))):
            p, s = int(rng.integers(0, n_paths)), int(rng.integers(0, 30))
            if rng.random() < 0.5:
                hj.report_slow(p, s)
                ht.report_slow(p, s)
                newest[p] = max(newest.get(p, -1), s)
            else:
                origin = int(rng.integers(0, s + 1))
                verdict = ht.admit_report(p, origin, s)
                assert verdict == hj.admit_report(p, origin, s)
                if verdict == "admitted":
                    newest[p] = max(newest.get(p, -1), s)
        probe = int(rng.integers(0, 45))
        assert ht.inactive(probe) == hj.inactive(probe)
        assert all(ht.expiry(p) == hj.expiry(p) for p in range(n_paths))
        if cooldown == 0:
            assert all(ht.expiry(p) == s + phi for p, s in newest.items())
        state = ht.state()
        assert json.loads(json.dumps(state)) == hj.state()
        again = tel.LinkHealth(**kw)
        again.restore(json.loads(json.dumps(state)))
        again.report_slow(0, 31)
        ht.report_slow(0, 31)
        assert again.inactive(33) == ht.inactive(33) and again.expiry(0) == ht.expiry(0)


def test_watchdog_straggler_policy_and_remesh_match_reference():
    rng = np.random.default_rng(11)
    wj, wt = jel.TelemetryWatchdog(blackout_epochs=2), tel.TelemetryWatchdog(blackout_epochs=2)
    sj, st = jel.StragglerPolicy(deadline_s=1.0, max_misses=2), tel.StragglerPolicy(
        deadline_s=1.0, max_misses=2)
    for _ in range(200):
        n = int(rng.integers(0, 3)) * int(rng.random() < 0.4)
        assert wt.observe(n) == wj.observe(n)
        assert wt.safe_mode == wj.safe_mode and wt.state() == wj.state()
        rank, dur = int(rng.integers(0, 4)), float(rng.uniform(0.5, 1.6))
        assert st.observe(rank, dur) == sj.observe(rank, dur)
        assert st.quarantined() == sj.quarantined() and st.state() == sj.state()
    assert tel.remesh_plan((4, 16), (1, 3), 120) == tel.RemeshPlan(
        **dataclasses.asdict(jel.remesh_plan((4, 16), (1, 3), 120)))
    with pytest.raises(RuntimeError):
        tel.remesh_plan((2, 4), (0, 1), 0)


def test_report_congestion_overload_and_dead_capacity():
    """tests/test_dist_extra.py's two rules: 2x capacity on uplink 1 is
    reported and released after phi; a dead uplink (capacity 0) reads
    +inf, not idle, and is reported by the overload rule alone."""
    topo = tt.leaf_spine(2, 4, 2, 40e9, device="cpu")
    up = np.zeros((10, 2, 4), np.float32)
    up[:, 0, 1] = 80e9
    lh = tel.LinkHealth(n_paths=topo.n_paths, phi_steps=4)
    assert tnf.report_congestion(lh, topo, _Outs(up), step=5, overload=1.5) == (1,)
    assert lh.inactive(6) == (False, True, False, False)
    assert lh.inactive(9) == (False,) * 4
    idle = np.zeros((10, 2, 4), np.float32)
    cap = topo.capacity.numpy().copy()
    cap[2] = 0.0  # up[leaf 0, spine 2]
    util = tnf.path_utilization(topo, _Outs(idle), capacity=cap)
    assert np.isinf(util[2]) and (util[[0, 1, 3]] == 0.0).all()
    lh = tel.LinkHealth(n_paths=4, phi_steps=4)
    assert 2 in tnf.report_congestion(lh, topo, _Outs(idle), capacity=torch.as_tensor(cap),
                                      dead_capacity_frac=0.0)
    assert tnf.hot_uplinks(topo, _Outs(up), capacity=cap, top_n=2) == jnf.hot_uplinks(
        jt.leaf_spine(2, 4, 2, 40e9), _Outs(up), capacity=cap, top_n=2)


def test_three_tier_uplink_quarantines_exactly_its_core_paths_seeded():
    """An overloaded ToR uplink quarantines its n_core paths and nothing
    else; with a lossy link and random loads, the same reports as the JAX
    package's observe_congestion."""
    kw = dict(n_tor=3, n_agg=4, n_core=2, hosts_per_tor=2, bw_tor_agg=40e9,
              bw_agg_core=10e9, host_bw=10e9)
    topo, jtopo = tt.three_tier(**kw, device="cpu"), jt.three_tier(**kw)
    T, A = topo.uplink_ids.shape
    C = topo.n_paths // A
    cap = topo.capacity.numpy()[topo.uplink_ids]
    rng = np.random.default_rng(11)
    for _ in range(25):
        hot = {(int(rng.integers(0, T)), int(rng.integers(0, A)))
               for _ in range(int(rng.integers(1, 4)))}
        up = np.zeros((5, T, A), np.float32)
        for (leaf, a) in hot:
            up[:, leaf, a] = 3.0 * cap[leaf, a]
        lh = tel.LinkHealth(n_paths=topo.n_paths, phi_steps=4)
        slow = tnf.report_congestion(lh, topo, _Outs(up), step=0, overload=1.5)
        expect = {a * C + c for (_, a) in hot for c in range(C)}
        assert set(slow) == expect
        assert lh.inactive(1) == tuple(p in expect for p in range(topo.n_paths))
        noisy = rng.uniform(0, 2.0, (5, T, A)).astype(np.float32) * cap
        loss = np.zeros(topo.n_links + 1, np.float32)
        loss[rng.integers(0, topo.n_links, 2)] = 0.01
        assert tnf.observe_congestion(topo, _Outs(noisy), loss=loss) == \
            jnf.observe_congestion(jtopo, _Outs(noisy), loss=loss)


def test_co_simulate_reroutes_around_a_dead_spine():
    """tests/test_dist_extra.py's round trip: a spine at 1 Mb/s is seen by
    the fluid simulation and the next plan avoids it, as in the JAX
    package."""
    L, S, dead = 4, 4, 2
    over = {}
    for leaf in range(L):
        over[leaf * S + dead] = 1e6
        over[L * S + dead * L + leaf] = 1e6
    plan_kw = dict(n_chunks=4, directions=(1, -1, 1, -1))
    js.clear_cache()
    want = jnf.co_simulate(jt.leaf_spine(L, S, 2, 40e9, capacity_overrides=over),
                           jcol.PathPlan(**plan_kw), [0, 2, 4, 6], 2e6, scheme="ecmp",
                           duration_s=2e-3, step=100)
    js.clear_cache()
    topo = tt.leaf_spine(L, S, 2, 40e9, capacity_overrides=over, device="cpu")
    got = tnf.co_simulate(topo, tcol.PathPlan(**plan_kw), [0, 2, 4, 6], 2e6, scheme="ecmp",
                          duration_s=2e-3, step=100, device="cpu")
    assert got.slow_paths == want.slow_paths and dead in got.slow_paths
    assert tnf.path_utilization(topo, got.outs)[dead] > 10.0
    assert got.plan.chunk_paths() == want.plan.chunk_paths()
    assert dead not in got.plan.chunk_paths()


def _ls244(pkg):
    return (jt.leaf_spine(2, 4, 4, 100e9) if pkg == "jax"
            else tt.leaf_spine(2, 4, 4, 100e9, device="cpu"))


def _spec(cosim, topo, **kw):
    """A ring of 4 at 2 MB on leaf_spine(2, 4, 4), spine 1 killed at epoch
    1 and back at 2, 3 epochs."""
    spec = dict(topo=topo, hosts=cosim.ring_hosts(topo, 4), size_bytes=2e6, scheme="ecmp",
                epochs=3, phi_steps=1, n_chunks=4, seed=0,
                faults=(cosim.kill_spine(topo, 1, epoch=1, recover_epoch=2),))
    spec.update(kw)
    return spec


def test_flowcells_with_reorder_budget_match_reference():
    """flowcells=4 with a reordering budget: sprayed cells pay the
    reordering cost; the same reports, plans and censored FCTs (to the
    same dt step) as the JAX package's."""
    js.clear_cache()
    want = jc.run_cosim(**_spec(jc, _ls244("jax"), flowcells=4, reorder_budget=4.0))
    js.clear_cache()
    got = tc.run_cosim(**_spec(tc, _ls244("torch"), flowcells=4, reorder_budget=4.0),
                       device="cpu")
    plain = tc.run_cosim(**_spec(tc, _ls244("torch")), device="cpu")
    for g, w in zip(got.records, want.records):
        assert (g.quarantined, g.reported_slow, g.plan_version) == \
            (w.quarantined, w.reported_slow, w.plan_version)
        assert abs(g.fct_p99_s - w.fct_p99_s) <= 10e-6 + 1e-9
        assert abs(g.fct_p50_s - w.fct_p50_s) <= 10e-6 + 1e-9
        assert abs(g.completion - w.completion) <= 1e-3
    assert any(not np.array_equal(a.fct, b.fct) for a, b in zip(got.records, plain.records))


def test_journal_resumes_after_a_torn_tail(tmp_path):
    """A run cut after two epochs, its last line torn, resumes from the
    journal to the uninterrupted run's history; another schema version
    raises."""
    topo = _ls244("torch")
    full = tc.run_cosim(**_spec(tc, topo, epochs=3), device="cpu")
    path = tmp_path / "cosim.jsonl"
    tc.run_cosim(**_spec(tc, topo, epochs=3), journal=str(path), device="cpu")
    lines = path.read_text().splitlines()
    assert len(lines) == 4  # header + 3 epochs
    path.write_text("\n".join(lines[:3]) + "\n" + lines[3][: len(lines[3]) // 2])
    resumed = tc.run_cosim(**_spec(tc, topo, epochs=3), journal=str(path), device="cpu")
    for a, b in zip(resumed.records, full.records):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in ("fct", "imbalance"):
            np.testing.assert_array_equal(da.pop(k), db.pop(k))
        assert da == db
    assert resumed.plans == full.plans and resumed.final_plan == full.final_plan
    assert len(path.read_text().splitlines()) == 4
    head = json.loads(lines[0])
    path.write_text(json.dumps(dict(head, schema_version=1)) + "\n")
    with pytest.raises(tc.JournalSchemaError):
        tc.run_cosim(**_spec(tc, topo, epochs=3), journal=str(path), device="cpu")


def test_cosim_grid_salvages_a_failing_spec():
    """run_cosim_grid with salvage=True: a spec that raises gives a
    JobFailure at its index, the others their histories (the same as each
    spec alone); without salvage it raises."""
    topo = _ls244("torch")
    specs = [_spec(tc, topo, epochs=2), dict(_spec(tc, topo, epochs=2), scheme="nope"),
             _spec(tc, topo, epochs=2, scheme="seqbalance")]
    ts.clear_cache()
    out = tc.run_cosim_grid(specs, workers=2, salvage=True, device="cpu")
    assert isinstance(out[1], ts.JobFailure) and out[1].failed and out[1].index == 1
    assert out[1].error.startswith("ValueError")
    alone = tc.run_cosim(**specs[2], device="cpu")
    assert [r.fct_p99_s for r in out[2].records] == [r.fct_p99_s for r in alone.records]
    assert not getattr(out[0], "failed", False) and out[0].epochs == 2
    assert ts.obs_stats()["job_failures"] == 1
    with pytest.raises(ValueError):
        tc.run_cosim_grid(specs[:2], device="cpu")


def test_run_jobs_retries_with_the_reference_backoff():
    """A callable job that fails once succeeds on its retry; results stay
    in job order; the backoff is the JAX package's, jitter and all."""
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return "done"

    ts.clear_cache()
    assert ts.run_jobs([lambda: "first", flaky], retries=1, backoff_s=0.0,
                       device="cpu") == ["first", "done"]
    assert ts.obs_stats()["job_retries"] == 1
    for i in range(3):
        for attempt in (1, 2, 3):
            assert ts.retry_sleep_s(i, attempt, 0.5, 0.5) == js.retry_sleep_s(i, attempt,
                                                                              0.5, 0.5)
