"""The port's flowcell reordering cost and ``flowlet_timeout`` scheme
against the JAX package's: ``dataplane.reorder_gbn_factor``, the hetero
fabric, the flowcell plan and its trace's ``spray`` column, the WCMP
re-draw (held end to end where flowlets break), the degenerate cases
that must change nothing, whole runs of
``benchmarks/bench_flowcell.py``'s ring on the 25G fabric, and the port's
dense engine against its compact one.

Run as a script to regenerate ``src/repro_torch/netsim/flowcell_reference.json``,
the JAX package's results for ``chip_smoke.py`` phase 9 (a few minutes on
8 cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_flowcell.py --write-flowcell-reference
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jb  # noqa: E402
from repro.dist import collectives as j_col, cosim as j_cos  # noqa: E402
from repro.netsim import dataplane as jdp, engine as je, metrics as jm  # noqa: E402
from repro.netsim import sweep as js, topology as jt, workloads as jw  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.dist import collectives as t_col, cosim as t_cos  # noqa: E402
from repro_torch.netsim import compact as tc, dataplane as tdp, engine as te  # noqa: E402
from repro_torch.netsim import sweep as ts, topology as tt, workloads as tw  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "src" / "repro_torch" / "netsim" / "flowcell_reference.json"
DT = 10e-6
PKG = {"jax": (jt, jw, j_col, j_cos), "torch": (tt, tw, t_col, t_cos)}


def _jax_run(topo, cfg, trace, **kw):
    """The JAX package's run_one from an empty executable cache: its cache
    key drops the capacity of every topology whenever the operand
    signature is a tuple (``bool(ops_sig)`` is always true), so a run
    without operands would reuse the program compiled for another
    topology of the same shape, with that topology's capacities baked in.
    The cache is emptied after the run too, so that no later run meets
    these programs."""
    js.clear_cache()
    try:
        return js.run_one(topo, cfg, trace, **kw)
    finally:
        js.clear_cache()


def _fabric(pkg, name):
    """bench_flowcell's fabrics: 100G hosts over a 25G fabric, all four
    spines alike or the last one at 100G."""
    topology = PKG[pkg][0]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    if name == "symmetric":
        return topology.leaf_spine(4, 4, 4, 25e9, host_bw=100e9, **kw)
    return topology.hetero_leaf_spine(4, 4, 4, 25e9, 100e9, n_fast_spines=1, host_bw=100e9, **kw)


def _plan(col, fcells=1, budget=0.0, inactive=None):
    return col.PathPlan(n_chunks=4, directions=(1, -1, 1, -1), inactive=inactive,
                        flowcells=fcells, reorder_budget=budget)


def _ring(pkg, topo, fcells=1, size=16e6, budget=0.0, inactive=None, gap=3e-4):
    """bench_flowcell's ring of 8: 4 chunks, 300 us between rounds."""
    _, wl, col, cos = PKG[pkg]
    return wl.collective_trace(_plan(col, fcells, budget, inactive), cos.ring_hosts(topo, 8),
                               size, link_bw=25e9, round_gap_s=gap, seed=0,
                               steer_paths=topo.n_paths)


def _finish_close(a, b, dt=DT):
    """The same finished flows (some of them), every finish within one dt."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    done = np.isfinite(a)
    assert done.any()
    assert np.all(np.abs(a[done] - b[done]) <= dt + 1e-9), np.abs(a[done] - b[done]).max()


# ------------------------------------------------------------ the pieces
@pytest.mark.parametrize("fabric", ["symmetric", "hetero"])
@pytest.mark.parametrize("seed", [0, 1])
def test_reorder_gbn_factor_matches_reference(fabric, seed):
    rng = np.random.default_rng(seed)
    jtopo, ttopo = _fabric("jax", fabric), _fabric("torch", fabric)
    n, P = 256, jtopo.n_paths
    pq = rng.uniform(0.0, 4e5, (n, P)).astype(np.float32)
    pq[rng.random((n, P)) < 0.3] = 0.0
    spray = rng.integers(0, 6, n).astype(np.int32)
    rc0 = rng.uniform(0.0, 100e9, n).astype(np.float32)
    rc0[rng.random(n) < 0.1] = 0.0
    cap = np.asarray(jtopo.capacity) * np.float32(0.5)
    kw = dict(mtu_bytes=1000.0, jitter_mtus=4.0, window_pkts=16.0)
    for reorder in (0.0, 2.0, 16.0):
        for capacity in (None, cap):
            want = np.asarray(jdp.reorder_gbn_factor(
                jtopo, jnp.asarray(pq), jnp.asarray(spray), jnp.asarray(rc0),
                jnp.float32(reorder), capacity=None if capacity is None else jnp.asarray(cap),
                **kw))
            got = tdp.reorder_gbn_factor(
                ttopo, torch.as_tensor(pq)[None], torch.as_tensor(spray)[None],
                torch.as_tensor(rc0)[None], torch.tensor(reorder, dtype=torch.float32),
                capacity=None if capacity is None else torch.as_tensor(cap), **kw)[0].numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6)
            assert np.all(got[spray <= 1] == 1.0) and np.all(got >= 1.0)
            assert np.any(got[spray > 1] > 1.0)


TOPOLOGIES = {
    "hetero_default": lambda m, **kw: m.hetero_leaf_spine(**kw),
    "hetero_bench": lambda m, **kw: m.hetero_leaf_spine(4, 4, 4, 25e9, 100e9, n_fast_spines=1,
                                                         host_bw=100e9, **kw),
    "hetero_two_fast": lambda m, **kw: m.hetero_leaf_spine(2, 4, 4, 40e9, 160e9,
                                                            n_fast_spines=2, **kw),
    "leaf_spine_overrides": lambda m, **kw: m.leaf_spine(
        3, 4, 2, 40e9, capacity_overrides={2: 80e9, 13: 10e9, 25: 1e9}, **kw),
}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_topologies_match_reference(name):
    """Capacity vectors and link ids, exactly."""
    jtopo, ttopo = TOPOLOGIES[name](jt), TOPOLOGIES[name](tt, device="cpu")
    np.testing.assert_array_equal(ttopo.capacity.numpy(), np.asarray(jtopo.capacity))
    np.testing.assert_array_equal(ttopo.uplink_ids, np.asarray(jtopo.uplink_ids))
    np.testing.assert_array_equal(ttopo.path_link_table, np.asarray(jtopo.path_link_table))
    assert (ttopo.n_links, ttopo.n_paths, ttopo.n_leaf) == (jtopo.n_links, jtopo.n_paths,
                                                            jtopo.n_leaf)
    L, P = jtopo.n_leaf, jtopo.n_paths
    sl, dl, p = (a.ravel() for a in np.meshgrid(np.arange(L), np.arange(L), np.arange(P),
                                                indexing="ij"))
    np.testing.assert_array_equal(ttopo.fabric_links(sl, dl, p).numpy(),
                                  np.asarray(jtopo.fabric_links(sl, dl, p)))
    h = np.arange(jtopo.n_hosts)
    for got, want in zip(ttopo.nic_links(h, h[::-1].copy()), jtopo.nic_links(h, h[::-1])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tt.hetero_leaf_spine(n_spine=2, n_fast_spines=3, device="cpu")


@pytest.mark.parametrize("fcells,inactive", [(1, None), (3, None), (4, None),
                                             (4, (False, True, False, False))])
def test_flowcell_trace_matches_reference(fcells, inactive):
    """The plan's cell table and the rendered trace, all seven columns
    (``spray`` included), exactly."""
    jp, tp = _plan(j_col, fcells, 2.0, inactive), _plan(t_col, fcells, 2.0, inactive)
    assert tp.flowcell_paths() == jp.flowcell_paths()
    assert tp.chunk_paths() == jp.chunk_paths()
    assert [c[0] for c in tp.flowcell_paths()] == list(tp.chunk_paths())
    jtopo, ttopo = _fabric("jax", "hetero"), _fabric("torch", "hetero")
    want = _ring("jax", jtopo, fcells, inactive=inactive)
    got = _ring("torch", ttopo, fcells, inactive=inactive)
    for f in ("sizes", "arrivals", "src", "dst", "flow_id", "valid", "spray"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    n_active = 4 - sum(inactive or ())
    assert set(np.unique(got.spray)) == {min(fcells, n_active)}
    with pytest.raises(ValueError):
        t_col.PathPlan(flowcells=0)
    with pytest.raises(ValueError):
        t_col.PathPlan(reorder_budget=-1.0)


def test_wcmp_draws_match_reference_at_hetero_capacities():
    """flowlet_wcmp_paths: the u32 draw against the cumulative WCMP weights
    of the hetero fabric's uplink rows (and rows whose cumsum rounds), the
    same path for every flow."""
    rng = np.random.default_rng(3)
    n = 8192
    topo = _fabric("jax", "hetero")
    L, P = topo.n_leaf, topo.n_paths
    rows = [np.array(topo.capacity)[: L * P].reshape(L, P),
            np.array([[40e9, 40e9, 40e9, 100e9], [1e9, 3e9, 7e9, 11e9]], np.float32),
            rng.uniform(1e9, 400e9, (8, P)).astype(np.float32)]
    for cap in rows:
        leaf = rng.integers(0, cap.shape[0], n)
        u32 = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        gap = rng.random(n) < 0.7
        cur = rng.integers(0, P, n).astype(np.int32)
        want = np.asarray(jb.flowlet_wcmp_paths(
            jnp.asarray(cur), jnp.asarray(gap), jnp.asarray(u32),
            jb.wcmp_weights(jnp.asarray(cap))[jnp.asarray(leaf)]))
        got = tb.flowlet_wcmp_paths(
            torch.as_tensor(cur), torch.as_tensor(gap), torch.as_tensor(u32.astype(np.int64)),
            tb.wcmp_weights(torch.as_tensor(cap))[torch.as_tensor(leaf)])
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------- whole runs
def test_degenerate_cases_are_bit_identical():
    """flowcells=1 (with a budget on the plan) renders the classic trace and
    runs it bit for bit; reorder=0.0 on an unsprayed trace changes no
    finish time; a flowcell trace with reorder=0.0 pays (other finishes
    than reorder=None: the spray column reached the engine)."""
    topo = _fabric("torch", "symmetric")
    classic = _ring("torch", topo, size=4e6)
    plan1 = _ring("torch", topo, 1, size=4e6, budget=9.0)
    for f in ("sizes", "arrivals", "src", "dst", "flow_id", "valid", "spray"):
        np.testing.assert_array_equal(getattr(plan1, f), getattr(classic, f), err_msg=f)
    cfg = te.SimConfig(scheme="seqbalance", duration_s=3e-3)
    base, _ = ts.run_one(topo, cfg, classic, device="cpu")
    assert np.isfinite(base.finish).any()
    for trace, reorder in ((plan1, None), (classic, 0.0), (plan1, 0.0)):
        got, _ = ts.run_one(topo, cfg, trace, reorder=reorder, device="cpu")
        np.testing.assert_array_equal(got.finish, base.finish)
        assert float(got.cnp_pkts) == float(base.cnp_pkts)
    cells = _ring("torch", topo, 4, size=4e6)
    ecmp = te.SimConfig(scheme="ecmp", duration_s=3e-3)
    free, _ = ts.run_one(topo, ecmp, cells, device="cpu")
    strict, _ = ts.run_one(topo, ecmp, cells, reorder=0.0, device="cpu")
    assert np.isfinite(free.finish).any()
    assert not np.array_equal(free.finish, strict.finish)


RUNS = {  # fabric, scheme, flowcells, reorder, adaptive, round gap, horizon
    "flowlet_timeout_symmetric": ("symmetric", "flowlet_timeout", 1, None, False, 3e-4, 4e-3),
    "flowlet_timeout_hetero": ("hetero", "flowlet_timeout", 1, None, False, 3e-4, 4e-3),
    "flowcell_ecmp_b2": ("symmetric", "ecmp", 4, 2.0, False, 3e-4, 4e-3),
    "flowcell_ecmp_b4_hetero_adaptive": ("hetero", "ecmp", 4, 4.0, True, 1.5e-3, 10e-3),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_runs_match_reference(name):
    """The port's sweep against the JAX package's on bench_flowcell's ring
    (4 MB): the same finished flows, each within one dt; under adaptive dt
    a reorder run fast-forwards only idle spans (rounds 1.5 ms apart here),
    as many steps as the reference's."""
    fabric, scheme, fcells, reorder, adaptive, gap, horizon = RUNS[name]
    cfg = dict(scheme=scheme, duration_s=horizon, adaptive=adaptive, uplink_sample_every=10)
    jtopo, ttopo = _fabric("jax", fabric), _fabric("torch", fabric)
    want, _ = _jax_run(jtopo, je.SimConfig(**cfg),
                       _ring("jax", jtopo, fcells, size=4e6, gap=gap), reorder=reorder)
    got, _ = ts.run_one(ttopo, te.SimConfig(**cfg),
                        _ring("torch", ttopo, fcells, size=4e6, gap=gap), reorder=reorder,
                        device="cpu")
    _finish_close(got.finish, want.finish)
    assert got.ff_steps == int(want.ff_steps)
    if adaptive:
        assert got.ff_steps > 0


def _hetero_poisson(pkg, topo):
    """Alistorage at load 0.5 over the small hetero fabric's bisection."""
    wl = PKG[pkg][1]
    return wl.poisson_trace(wl.TraceConfig(
        workload="alistorage", load=0.5, duration_s=0.8e-3, n_hosts=topo.n_hosts,
        host_bw=40e9, seed=2, hosts_per_leaf=topo.hosts_per_leaf,
        load_base_bw=2 * 4 * 40e9))


def _line_rate(pkg, topo):
    """Three long flows from leaf 0 to leaf 1 that reach line rate."""
    return PKG[pkg][1].Trace(
        sizes=np.array([4e6, 4e6, 3e6], np.float32),
        arrivals=np.array([0.0, 1e-5, 2e-4], np.float32),
        src=np.array([0, 1, 2], np.int32), dst=np.array([4, 5, 6], np.int32),
        flow_id=np.array([11, 12, 13], np.uint32), valid=np.ones(3, bool))


REDRAW = {  # traffic, flowlet timeout (s), adaptive, capacity schedule
    "poisson": (_hetero_poisson, 1e-6, False, False),
    "poisson_schedule": (_hetero_poisson, 1e-6, False, True),
    "line_rate_adaptive": (_line_rate, 1e-9, True, False),
}


def _redraw(pkg, name):
    """A REDRAW case in ``pkg``: (topology, SimConfig keywords, trace, run
    operands).  The schedule moves leaf 0's fat uplink to another spine
    after 0.3 ms and keeps leaf 1's."""
    make, timeout, adaptive, schedule = REDRAW[name]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    topo = PKG[pkg][0].hetero_leaf_spine(2, 4, 4, 40e9, 160e9, n_fast_spines=1, **kw)
    ops = {}
    if schedule:
        cap = np.stack([np.asarray(topo.capacity)] * 2).astype(np.float32)
        up = cap[1, : topo.n_leaf * topo.n_paths].reshape(topo.n_leaf, topo.n_paths)
        up[0] = np.roll(up[0], 1)
        ops = dict(capacity=cap, cap_seg_steps=30)
    return topo, dict(duration_s=3e-3, adaptive=adaptive, flowlet_timeout=timeout), \
        make(pkg, topo), ops


@pytest.mark.parametrize("name", sorted(REDRAW))
def test_flowlet_redraw_matches_reference(name):
    """flowlet_timeout where flowlets break.  At the default 100 us timeout
    no flow below DCQCN's 1 Gb/s floor is ever at a gap, so the scheme
    runs as ECMP; a 1 us timeout puts every flow below 8 Gb/s at a gap,
    and 1 ns every flow, each step.  On the hetero fabric (2 leaves, one
    fat spine of 4) the port's run against the JAX package's: the same
    finished flows, each within one dt, and as many fast-forwarded steps.
    The re-draw fired (other finishes than ECMP on the same trace and
    operands); under the schedule the draws read the step's capacity row
    at the flow's source leaf; and under adaptive dt the gap guard holds
    back the fast-forward that ECMP takes."""
    jtopo, cfg, jtrace, ops = _redraw("jax", name)
    ttopo, _, ttrace, _ = _redraw("torch", name)
    want, _ = _jax_run(jtopo, je.SimConfig(scheme="flowlet_timeout", **cfg), jtrace, **ops)
    got, _ = ts.run_one(ttopo, te.SimConfig(scheme="flowlet_timeout", **cfg), ttrace,
                        device="cpu", **ops)
    ecmp, _ = ts.run_one(ttopo, te.SimConfig(scheme="ecmp", **cfg), ttrace, device="cpu", **ops)
    _finish_close(got.finish, want.finish)
    assert got.ff_steps == int(want.ff_steps)
    assert not np.array_equal(got.finish, ecmp.finish)
    if cfg["adaptive"]:
        assert ecmp.ff_steps > got.ff_steps


@pytest.mark.parametrize("scheme", ["seqbalance", "ecmp", "flowlet_timeout"])
def test_dense_matches_compact(scheme):
    """The port's dense oracle against its compact engine on the reference's
    cases (tests/test_flowcell_properties.py:214-251): a flowcell ring with
    the reorder operand live (on hosts 0, 1, 4 and 5: the reference's
    16 and 17 lie outside its 8-host fabric, which JAX's gathers clamp and
    torch refuses), and the WCMP flowlet scheme on a hetero fabric;
    identical finish times."""
    if scheme == "flowlet_timeout":
        topo = tt.hetero_leaf_spine(2, 4, 4, 40e9, 160e9, n_fast_spines=1, device="cpu")
        trace = tw.poisson_trace(tw.TraceConfig(
            workload="alistorage", load=0.5, duration_s=0.8e-3, n_hosts=topo.n_hosts,
            host_bw=40e9, seed=2, hosts_per_leaf=topo.hosts_per_leaf,
            load_base_bw=2 * 4 * 40e9))
        cfg, reorder = te.SimConfig(scheme=scheme, duration_s=3e-3), None
    else:
        topo = tt.leaf_spine(2, 4, 4, 100e9, device="cpu")
        trace = tw.collective_trace(_plan(t_col, 3), [0, 1, 4, 5], 2e6, link_bw=100e9,
                                    round_gap_s=2e-4, seed=1, steer_paths=topo.n_paths)
        cfg, reorder = te.SimConfig(scheme=scheme, duration_s=2e-3), 2.0
    dense, _ = te.simulate(topo, cfg, trace, reorder=reorder, device="cpu")
    comp, _ = tc.simulate_compact(topo, cfg, trace, reorder=reorder, device="cpu")
    assert comp.spill_steps == 0
    fd = dense.finish.numpy()
    assert np.isfinite(fd).any()
    np.testing.assert_array_equal(comp.finish, fd)


def test_reorder_refuses_drill_and_three_tier():
    topo = _fabric("torch", "symmetric")
    trace = _ring("torch", topo, 4, size=1e6)
    with pytest.raises(ValueError, match="DRILL"):
        ts.run_one(topo, te.SimConfig(scheme="drill", duration_s=1e-4), trace, reorder=1.0,
                   device="cpu")
    with pytest.raises(ValueError, match="DRILL"):
        te.simulate(topo, te.SimConfig(scheme="drill", duration_s=1e-4), trace, reorder=1.0,
                    device="cpu")
    three = tt.three_tier(4, 2, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="2-tier"):
        ts.run_one(three, te.SimConfig(scheme="ecmp", duration_s=1e-4), trace, reorder=1.0,
                   device="cpu")


# ------------------------------------------------ the chip_smoke reference
BUDGETS = (0, 4, 16)
GRID_ARMS = ("seqbalance", "ecmp", "flowlet_timeout", "flowcell_free") + tuple(
    f"flowcell_b{b}" for b in BUDGETS)
SIM2TIER_ARMS = ("seqbalance", "flowlet_timeout", "flowcell_free", "flowcell_b0",
                 "flowcell_b16")


def _arm(name):
    """(scheme, flowcell trace?, reorder) of a bench_flowcell arm."""
    if name.startswith("flowcell_"):
        return "ecmp", True, None if name == "flowcell_free" else float(name[len("flowcell_b"):])
    return name, False, None


def test_flowcell_reference_covers_the_cases():
    """The file chip_smoke.py phase 9 holds the card to: every arm of both
    fabrics and of sim_2tier with finite censored percentiles, the
    degenerate pairs bit-identical, and the reference's two acceptance
    facts recorded."""
    ref = json.loads(REFERENCE.read_text())
    assert ref["backend"] == "cpu"
    cases = ref["cases"]
    for fabric in ("symmetric", "hetero"):
        assert sorted(cases["flowcell_grid"]["runs"][fabric]) == sorted(GRID_ARMS)
    assert sorted(cases["flowcell_sim2tier"]["runs"]) == sorted(SIM2TIER_ARMS)
    runs = [r for f in cases["flowcell_grid"]["runs"].values() for r in f.values()]
    for r in runs + list(cases["flowcell_sim2tier"]["runs"].values()):
        assert np.isfinite(r["p99_us"]) and np.isfinite(r["p50_us"])
        assert 0.0 <= r["completion"] <= 1.0
    assert cases["flowcell_sim2tier"]["runs"]["seqbalance"]["ff_steps"] > 0
    assert cases["flowcell_degenerate"]["bit_identical"] == {"flowcells_1": True,
                                                            "reorder_0": True}
    assert set(cases["flowcell_grid"]["facts"]) == {"free_wins", "gbn_loses"}
    redraw = cases["flowlet_redraw"]["runs"]
    assert sorted(redraw) == sorted(REDRAW)
    for r in redraw.values():
        assert len(r["finish_s"]) == r["flows"] and any(f is not None for f in r["finish_s"])


def _censored(res, trace, horizon_s):
    """bench_flowcell._censored_p99: (p99 us, p50 us, completion) with the
    unfinished flows censored at the horizon."""
    f, completion = jm.fct_samples(res, trace, horizon_s=horizon_s)
    return float(np.percentile(f, 99) * 1e6), float(np.percentile(f, 50) * 1e6), completion


def write_flowcell_reference() -> None:
    """Run the JAX package on chip_smoke.py phase 9's cases and record the
    censored p99, p50, completion and ff_steps of each arm, and the finish
    times and ff_steps of the re-draw cases."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    size, gap, horizon = (chip_smoke.FLOWCELL_GRID[k] for k in ("size", "gap_s", "horizon_s"))

    def row(res, trace, horizon_s):
        p99, p50, completion = _censored(res, trace, horizon_s)
        return dict(p99_us=p99, p50_us=p50, completion=completion,
                    ff_steps=int(res.ff_steps), flows=int(np.asarray(trace.valid).sum()))

    def run(topo, cfg_kw, name, traces, horizon_s):
        scheme, cells, reorder = _arm(name)
        trace = traces[cells]
        res, _ = _jax_run(topo, je.SimConfig(scheme=scheme, **cfg_kw), trace, reorder=reorder)
        out = row(res, trace, horizon_s)
        print(name, out, flush=True)
        return out, res

    grid_kw = dict(duration_s=horizon)
    grid = {}
    for fabric in ("symmetric", "hetero"):
        topo = _fabric("jax", fabric)
        traces = {False: _ring("jax", topo, size=size, gap=gap),
                  True: _ring("jax", topo, 4, size=size, gap=gap)}
        grid[fabric] = {a: run(topo, grid_kw, a, traces, horizon)[0] for a in GRID_ARMS}
    sym = grid["symmetric"]
    facts = {"free_wins": sym["flowcell_free"]["p99_us"] <= sym["seqbalance"]["p99_us"],
             "gbn_loses": sym["flowcell_b0"]["p99_us"] >= sym["seqbalance"]["p99_us"]}

    topo = _fabric("jax", "symmetric")
    classic = _ring("jax", topo, size=size, gap=gap)
    plan1 = _ring("jax", topo, 1, size=size, budget=9.0, gap=gap)
    cfg = je.SimConfig(scheme="seqbalance", **grid_kw)
    base, _ = _jax_run(topo, cfg, classic)
    one, _ = _jax_run(topo, cfg, plan1)
    zero, _ = _jax_run(topo, cfg, classic, reorder=0.0)
    degenerate = dict(
        seqbalance=row(base, classic, horizon),
        bit_identical={"flowcells_1": bool(np.array_equal(np.asarray(one.finish),
                                                          np.asarray(base.finish))),
                       "reorder_0": bool(np.array_equal(np.asarray(zero.finish),
                                                        np.asarray(base.finish)))})

    sim2 = jt.sim_2tier()
    plan, plan_fc = _plan(j_col), _plan(j_col, 4)
    kw = dict(link_bw=100e9, round_gap_s=800e-6, seed=0, steer_paths=sim2.n_paths)
    hosts = j_cos.ring_hosts(sim2, 8)
    traces = {False: jw.collective_trace(plan, hosts, 8e6, **kw),
              True: jw.collective_trace(plan_fc, hosts, 8e6, **kw)}
    s2_kw = dict(duration_s=14e-3, adaptive=True, uplink_sample_every=10)
    sim2tier = {a: run(sim2, s2_kw, a, traces, 14e-3)[0] for a in SIM2TIER_ARMS}

    redraw = {}
    for name in sorted(REDRAW):
        topo, cfg_kw, trace, ops = _redraw("jax", name)
        res, _ = _jax_run(topo, je.SimConfig(scheme="flowlet_timeout", **cfg_kw), trace, **ops)
        finish = np.asarray(res.finish, np.float64)
        redraw[name] = dict(finish_s=[float(f) if np.isfinite(f) else None for f in finish],
                            ff_steps=int(res.ff_steps), flows=int(finish.size))
        print(name, {k: v for k, v in redraw[name].items() if k != "finish_s"}, flush=True)

    cases = {
        "flowcell_grid": dict(config=dict(grid_kw, size=size, round_gap_s=gap, flowcells=4,
                                          budgets=list(BUDGETS)),
                              runs=grid, facts=facts),
        "flowcell_degenerate": degenerate,
        "flowcell_sim2tier": dict(config=dict(s2_kw, size=8e6, round_gap_s=800e-6,
                                              flowcells=4), runs=sim2tier),
        "flowlet_redraw": dict(config={n: dict(flowlet_timeout=t, adaptive=a, schedule=c)
                                       for n, (_, t, a, c) in REDRAW.items()}, runs=redraw),
    }
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip()
    REFERENCE.write_text(json.dumps({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_flowcell.py "
                   "--write-flowcell-reference",
        "source": "JAX package, netsim.sweep.run_one per arm from an empty executable "
                  "cache; censored percentiles as "
                  "benchmarks/bench_flowcell.py::_censored_p99 at full precision",
        "commit": commit, "backend": "cpu", "cases": cases,
    }, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-flowcell-reference"]:
        write_flowcell_reference()
    else:
        sys.exit("usage: test_torch_flowcell.py --write-flowcell-reference")
