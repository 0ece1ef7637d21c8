"""The port's adaptive dt against the JAX package's: the closed forms
(``dcqcn.fast_forward``, ``dataplane.queue_fast_forward``), the planners
(``event_grid``, ``plan_chunks``), the collective trace's plan, and whole
runs: the sparse collective of ``benchmarks/paper_benches.py::
bench_adaptive_dt`` fast-forwards as the reference does, an event-dense
trace never does, and a batch that mixes both ends each simulation as it
ends alone.

Run as a script to regenerate ``src/repro_torch/netsim/adaptive_reference.json``,
the JAX package's results for ``chip_smoke.py`` phases 7 and 8 (a few
minutes on 8 cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_adaptive.py --write-adaptive-reference
"""
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.dist import collectives as j_col, cosim as j_cos  # noqa: E402
from repro.netsim import compact as jc, dataplane as jdp, dcqcn as jd  # noqa: E402
from repro.netsim import engine as je, sweep as js, topology as jt, workloads as jw  # noqa: E402
from repro_torch.dist import collectives as t_col, cosim as t_cos  # noqa: E402
from repro_torch.netsim import compact as tc, dataplane as tdp, dcqcn as td  # noqa: E402
from repro_torch.netsim import engine as te, sweep as ts, topology as tt  # noqa: E402
from repro_torch.netsim import workloads as tw  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "src" / "repro_torch" / "netsim" / "adaptive_reference.json"
DT = 10e-6
COLLECTIVE_CFG = dict(scheme="seqbalance", duration_s=14e-3, uplink_sample_every=10)


def _collective(wl, col, cos, topo, size=4e6):
    """bench_adaptive_dt's trace: a 4-chunk bidirectional ring of 8 with
    800 us compute gaps between rounds."""
    plan = col.PathPlan(n_chunks=4, directions=(1, -1, 1, -1))
    return wl.collective_trace(plan, cos.ring_hosts(topo, 8), size, link_bw=100e9,
                               round_gap_s=800e-6, seed=0, steer_paths=topo.n_paths)


def _poisson(wl, topo, load=0.6, dur=1.2e-3, seed=0):
    return wl.poisson_trace(wl.TraceConfig(
        workload="alistorage", load=load, duration_s=dur, n_hosts=topo.n_hosts,
        host_bw=100e9, seed=seed, hosts_per_leaf=topo.hosts_per_leaf,
        load_base_bw=topo.n_leaf * topo.n_paths * 100e9))


def _finish_close(a, b, dt=DT):
    """The same finished flows, every finish time within one dt."""
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    done = np.isfinite(a)
    assert np.all(np.abs(a[done] - b[done]) <= dt + 1e-9), np.abs(a[done] - b[done]).max()


@functools.lru_cache(maxsize=None)
def _ls444_runs():
    """collective_ls444 fixed and adaptive in both packages:
    {(package, adaptive): (result, outs)}."""
    jtopo = jt.leaf_spine(4, 4, 4, 100e9)
    ttopo = tt.leaf_spine(4, 4, 4, 100e9, device="cpu")
    jtr = _collective(jw, j_col, j_cos, jtopo)
    ttr = _collective(tw, t_col, t_cos, ttopo)
    runs = {}
    for adaptive in (False, True):
        runs["jax", adaptive] = js.run_one(
            jtopo, je.SimConfig(adaptive=adaptive, **COLLECTIVE_CFG), jtr)
        runs["torch", adaptive] = ts.run_one(
            ttopo, te.SimConfig(adaptive=adaptive, **COLLECTIVE_CFG), ttr, device="cpu")
    return runs, ttr


@pytest.mark.parametrize("n_steps", [1, 5, 6, 17, 64])
def test_dcqcn_fast_forward_matches_reference_and_steps(n_steps):
    """The closed form against the reference's and against n iterated
    zero-mark steps, from the reference test's states (rate timers before,
    at and past their first firing; an inactive sub-flow)."""
    p = td.DCQCNParams()
    line = float(np.float32(100e9))
    raw = dict(rc=np.full(3, line), rt=np.full(3, line), alpha=np.ones(3),
               t_since_cnp=np.ones(3), t_since_rate=np.array([0.0, 30e-6, 54e-6]),
               recovery_stage=np.array([0.0, 2.0, 7.0]))
    raw = {k: v.astype(np.float32) for k, v in raw.items()}
    active = np.array([True, True, False])
    st0 = td.DCQCNState(*(torch.as_tensor(raw[f]) for f in td.DCQCNState._fields))
    it = st0
    for _ in range(n_steps):
        it, _ = td.step(it, torch.zeros(3), torch.as_tensor(active), DT, line, p)
    ff = td.fast_forward(st0, torch.as_tensor(active), n_steps, DT, p)
    j_ff = jd.fast_forward(jd.DCQCNState(*(jnp.asarray(raw[f]) for f in jd.DCQCNState._fields)),
                           jnp.asarray(active), n_steps, DT, jd.DCQCNParams())
    for f in td.DCQCNState._fields:
        got = getattr(ff, f).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(j_ff, f)), rtol=1e-6, atol=0.0,
                                   err_msg=f"{f} vs the reference, n={n_steps}")
        np.testing.assert_allclose(got, getattr(it, f).numpy(), rtol=1e-6, atol=0.0,
                                   err_msg=f"{f} vs iterated steps, n={n_steps}")


@pytest.mark.parametrize("seed", [0, 1])
def test_queue_fast_forward_matches_reference(seed):
    """The clipped linear queue trajectory on a batch of two against the
    reference's on each row (queues that drain to 0 and fill to qmax)."""
    rng = np.random.default_rng(seed)
    L, n = 16, 9
    q0 = rng.uniform(0, 2e6, (2, L + 1)).astype(np.float32)
    arr = rng.uniform(0, 2e11, (2, L + 1)).astype(np.float32)
    cap = np.full(L + 1, 1e11, np.float32)
    qmask = np.ones(L + 1, np.float32)
    qmask[L] = 0.0
    q, mq = tdp.queue_fast_forward(torch.as_tensor(q0), torch.as_tensor(arr),
                                   torch.as_tensor(cap), torch.as_tensor(qmask), dt=DT,
                                   n_steps=n, qmax_bytes=8e6, n_links=L)
    for b in range(2):
        jq, jmq = jdp.queue_fast_forward(jnp.asarray(q0[b]), jnp.asarray(arr[b]),
                                         jnp.asarray(cap), jnp.asarray(qmask), dt=DT,
                                         n_steps=n, qmax_bytes=8e6, n_links=L)
        np.testing.assert_allclose(q[b].numpy(), np.asarray(jq), rtol=1e-6, atol=0.0)
        np.testing.assert_allclose(mq[b].numpy(), np.asarray(jmq), rtol=1e-6, atol=0.0)


def test_event_grid_and_plan_chunks_match_reference():
    for chunk, s, n in [(32, 10, 1000), (32, 1, 1000), (20, 10, 1400), (32, 8, 1000),
                        (7, 3, 21), (32, 10, 995), (16, 5, 1005), (32, 32, 64), (1, 1, 7)]:
        jcfg = je.SimConfig(chunk_steps=chunk, uplink_sample_every=s)
        tcfg = te.SimConfig(chunk_steps=chunk, uplink_sample_every=s)
        assert tc.plan_chunks(tcfg, n) == jc.plan_chunks(jcfg, n)
    rng = np.random.default_rng(3)
    arrivals = np.concatenate([rng.uniform(0, 6e-3, 40), [2.0, np.inf]]).astype(np.float32)
    valid = np.ones(arrivals.size, bool)
    valid[3] = False
    for seg in (0, 125, 140):
        cfg = dict(dt=DT, uplink_sample_every=10)
        got = tc.event_grid(te.SimConfig(**cfg), 500, arrivals=arrivals, valid=valid,
                            cap_seg_steps=seg)
        want = jc.event_grid(je.SimConfig(**cfg), 500, arrivals=arrivals, valid=valid,
                             cap_seg_steps=seg)
        np.testing.assert_array_equal(got, want)


def test_collective_plan_and_ring_match_reference():
    """The port's copies of PathPlan and ring_hosts render the same trace."""
    for inactive in (None, (False, True, False, False), (True,) * 4):
        jp = j_col.PathPlan(n_chunks=6, directions=(1, -1, 1, -1), inactive=inactive)
        tp = t_col.PathPlan(n_chunks=6, directions=(1, -1, 1, -1), inactive=inactive)
        assert tp.chunk_paths() == jp.chunk_paths() and tp.n_paths == jp.n_paths
    topo = tt.sim_2tier(device="cpu")
    for n in (2, 8, 9, 128):
        assert t_cos.ring_hosts(topo, n) == j_cos.ring_hosts(jt.sim_2tier(), n)
    ttr = _collective(tw, t_col, t_cos, tt.leaf_spine(4, 4, 4, 100e9, device="cpu"))
    jtr = _collective(jw, j_col, j_cos, jt.leaf_spine(4, 4, 4, 100e9))
    for f in ("sizes", "arrivals", "src", "dst", "flow_id", "valid"):
        np.testing.assert_array_equal(getattr(ttr, f), getattr(jtr, f), err_msg=f)
    assert len(ttr.sizes) == 448 and float(ttr.arrivals.max()) == pytest.approx(10.4e-3)


def test_collective_ls444_fast_forwards_as_the_reference_does():
    """bench_adaptive_dt's cell: the port's adaptive run fast-forwards the
    compute gaps (the reference's count of steps; a predicate compare one
    ulp the other way would move it by a macro-step, which this would
    report), finishes the flows of the reference's run within one dt, and
    agrees with its own fixed-dt run as the reference's does
    (tests/test_adaptive_dt.py:91-103, :142-172)."""
    runs, trace = _ls444_runs()
    (j_fix, _), (j_ad, _) = runs["jax", False], runs["jax", True]
    (t_fix, _), (t_ad, _) = runs["torch", False], runs["torch", True]
    assert t_fix.ff_steps == 0 and int(j_ad.ff_steps) > 0
    assert t_ad.ff_steps == int(j_ad.ff_steps), (t_ad.ff_steps, int(j_ad.ff_steps))
    _finish_close(t_ad.finish, np.asarray(j_ad.finish))
    _finish_close(t_fix.finish, np.asarray(j_fix.finish))
    _finish_close(t_ad.finish, t_fix.finish)
    done = np.isfinite(t_ad.finish)
    assert done.all()
    sizes = np.asarray(trace.sizes)
    assert float(sizes[done].sum()) == float(sizes[np.isfinite(t_fix.finish)].sum())
    np.testing.assert_allclose(float(t_ad.cnp_pkts), float(t_fix.cnp_pkts), rtol=1e-6)


def test_adaptive_uplink_and_queue_outputs_match_fixed():
    """The fast-forward writes the uplink slab per sample window and
    max_queue per step: adaptive against fixed at the reference test's
    tolerance (tests/test_adaptive_dt.py:121-140), and against the
    reference's adaptive outputs."""
    runs, _ = _ls444_runs()
    outs_f, outs_a = runs["torch", False][1], runs["torch", True][1]
    j_outs_a = runs["jax", True][1]
    assert outs_a.uplink_load.shape == outs_f.uplink_load.shape == (140, 4, 4)
    for f in ("uplink_load", "max_queue", "goodput_total"):
        np.testing.assert_allclose(getattr(outs_a, f), getattr(outs_f, f), rtol=1e-5,
                                   atol=1.0, err_msg=f)
        np.testing.assert_allclose(getattr(outs_a, f), np.asarray(getattr(j_outs_a, f)),
                                   rtol=1e-5, atol=1.0, err_msg=f"{f} vs the reference")


def test_event_dense_trace_never_fast_forwards():
    """Loaded Poisson traffic (tests/test_adaptive_dt.py:105-119): no
    chunk is quiet while flows arrive, so adaptive equals fixed exactly,
    and no steady-state check runs while the host's arrival check rules
    the boundary out."""
    topo = tt.leaf_spine(2, 4, 4, 100e9, device="cpu")
    trace = _poisson(tw, topo)
    cfg = te.SimConfig(scheme="seqbalance", duration_s=4e-3, uplink_sample_every=10)
    fixed, _ = ts.run_one(topo, cfg, trace, device="cpu")
    before = dict(tc.run_core.counts)
    adaptive, _ = ts.run_one(topo, dataclasses.replace(cfg, adaptive=True), trace,
                             device="cpu")
    counts = {k: tc.run_core.counts[k] - before[k] for k in before}
    assert adaptive.ff_steps == 0 and counts["fast_forwards"] == 0
    assert counts["checks_ruled_out"] == 0
    K = tc.plan_chunks(cfg, 400)[0]
    last_arrival_chunk = int(np.ceil(trace.arrivals.max() / DT)) // K
    assert counts["steady_checks"] <= adaptive.steps // K - last_arrival_chunk
    np.testing.assert_array_equal(adaptive.finish, fixed.finish)
    assert float(adaptive.cnp_pkts) == float(fixed.cnp_pkts)


def test_mixed_batch_ends_each_simulation_as_alone():
    """B = 2: the collective (quiet in its gaps) beside a Poisson trace
    (busy until it drains).  At boundaries where only the collective is
    quiet, the batch steps and the collective takes the fast-forward's
    state and outputs: each simulation ends exactly as it does alone, and
    the steps stay in lockstep.  ff_macro_chunks > 1 runs such a batch one
    simulation at a time (run_core refuses it)."""
    topo = tt.leaf_spine(4, 4, 4, 100e9, device="cpu")
    traces = [_collective(tw, t_col, t_cos, topo), _poisson(tw, topo, load=0.5, dur=0.8e-3)]
    assert len(traces[1].sizes) <= ts.F_BUCKET  # one group
    cfg = te.SimConfig(adaptive=True, **COLLECTIVE_CFG)
    before = dict(tc.run_core.counts)
    batch, outs = ts.run_batch(topo, cfg, traces, window_slots=512, device="cpu")
    mixed = tc.run_core.counts["mixed_fast_forwards"] - before["mixed_fast_forwards"]
    assert mixed > 0
    assert batch[0].ff_steps > 0
    for r, o, trace in zip(batch, outs, traces):
        alone, alone_outs = ts.run_one(topo, cfg, trace, window_slots=512, device="cpu")
        assert r.ff_steps == alone.ff_steps and r.spill_steps == alone.spill_steps == 0
        np.testing.assert_array_equal(r.finish, alone.finish)
        assert float(r.cnp_pkts) == float(alone.cnp_pkts)
        for f in te.StepOutputs._fields:
            np.testing.assert_array_equal(getattr(o, f), getattr(alone_outs, f), err_msg=f)
    with pytest.raises(NotImplementedError, match="one at a time"):
        arrays = [tc.pad_trace_arrays(tc.sort_trace(t)[0], 2048) for t in traces]
        stacked = tuple(np.stack([a[i] for a in arrays]) for i in range(7))
        tc.run_core(topo, dataclasses.replace(cfg, ff_macro_chunks=2), 512, 2048, 64,
                    1400, tc.trace_tensors(stacked, "cpu"))


def test_macro_steps_of_two_chunks_run_one_at_a_time():
    """ff_macro_chunks = 2 through run_batch: each simulation alone, the
    collective still fast-forwarding, as the reference's per-simulation
    dispatch does."""
    topo = tt.leaf_spine(4, 4, 4, 100e9, device="cpu")
    jtopo = jt.leaf_spine(4, 4, 4, 100e9)
    trace = _collective(tw, t_col, t_cos, topo)
    cfg = dict(COLLECTIVE_CFG, adaptive=True, ff_macro_chunks=2)
    got, _ = ts.run_one(topo, te.SimConfig(**cfg), trace, device="cpu")
    want, _ = js.run_one(jtopo, je.SimConfig(**cfg), _collective(jw, j_col, j_cos, jtopo))
    assert got.ff_steps == int(want.ff_steps) > 0
    _finish_close(got.finish, np.asarray(want.finish))


def test_adaptive_reference_covers_the_cases():
    """The file chip_smoke.py phases 7 and 8 hold the card to: every case,
    scheme and mode, with finite stats and the collective cases
    fast-forwarding."""
    ref = json.loads(REFERENCE.read_text())
    assert ref["backend"] == "cpu"
    for name, schemes, traces in CASE_TABLE:
        runs = ref["cases"][name]["runs"]
        assert sorted(runs) == sorted(schemes)
        for scheme in schemes:
            for mode in ("fixed", "adaptive"):
                for t in traces:
                    s = runs[scheme][mode][t]
                    assert 0.0 < s["completion_rate"] <= 1.0
                    assert np.isfinite(s["avg_slowdown"]) and np.isfinite(s["p99_slowdown"])
                    if mode == "fixed":
                        assert s["ff_steps"] == 0
                    elif name.startswith("collective"):
                        assert s["ff_steps"] > 0


# ------------------------------------------------ the chip_smoke reference
FIG12_SCHEMES = ("drill", "ecmp", "seqbalance", "letflow", "conga")
FIG12_CASES = [f"{wl}_{load}" for wl in ("alistorage", "websearch") for load in (0.5, 0.8)]
CASE_TABLE = (
    ("collective_ls444", ("seqbalance",), ("collective",)),
    ("collective_sim2tier", ("seqbalance", "ecmp", "letflow"), ("collective",)),
    ("fig12_adaptive", FIG12_SCHEMES, tuple(FIG12_CASES)),
    ("faults", ("seqbalance", "ecmp"), ("alistorage_0.5",)),
)


def _fig12_traces(topo):
    fabric = topo.n_leaf * topo.n_paths * 100e9
    return [jw.poisson_trace(jw.TraceConfig(
        workload=c.rsplit("_", 1)[0], load=float(c.rsplit("_", 1)[1]), duration_s=2.5e-3,
        n_hosts=topo.n_hosts, host_bw=100e9, seed=1, hosts_per_leaf=topo.hosts_per_leaf,
        load_base_bw=fabric)) for c in FIG12_CASES]


def _fault_operands(topo, cfg):
    """Phase 8's operands: bench_cosim's draw for seed 0 and a ring of 8 at
    epoch 3, its stride aligned to the chunk, and 0.5 % loss on spine 0."""
    from repro.netsim import faults, topology

    n_steps = int(round(cfg.duration_s / cfg.dt))
    camp = faults.random_campaign(topo, seed=17, epochs=8, n_faults=3, n_ranks=8)
    loss = np.zeros(topo.n_links + 1, np.float32)
    loss[list(topology.spine_links(topo, 0))] = 0.005
    return dict(capacity=camp.capacity_schedule(topo, 3), loss=loss,
                cap_seg_steps=camp.seg_steps(n_steps, align=jc.plan_chunks(cfg, n_steps)[0]))


def write_adaptive_reference() -> None:
    """Run the JAX package on the four cases of chip_smoke.py phases 7-8,
    fixed and adaptive dt, and record FCT stats and ff_steps."""
    from repro.netsim import metrics

    def stats(res, trace, topo):
        s = metrics.fct_stats(res, trace, topo, 100e9)
        out = {k: s[k] for k in ("n", "completion_rate", "avg_slowdown", "p99_slowdown")}
        return dict(out, ff_steps=int(res.ff_steps))

    ls444, sim2 = jt.leaf_spine(4, 4, 4, 100e9), jt.sim_2tier()
    col = dict(uplink_sample_every=10, duration_s=14e-3)
    fig = dict(uplink_sample_every=10, duration_s=10e-3)
    setups = {
        "collective_ls444": (ls444, col, [_collective(jw, j_col, j_cos, ls444)], {}),
        "collective_sim2tier": (sim2, col, [_collective(jw, j_col, j_cos, sim2, size=8e6)], {}),
        "fig12_adaptive": (sim2, fig, _fig12_traces(sim2), {}),
        "faults": (sim2, fig, _fig12_traces(sim2)[:1], "faults"),
    }
    cases = {}
    for name, schemes, names in CASE_TABLE:
        topo, cfg_kw, traces, ops = setups[name]
        runs = {}
        for scheme in schemes:
            runs[scheme] = {}
            for mode in ("fixed", "adaptive"):
                cfg = je.SimConfig(scheme=scheme, adaptive=mode == "adaptive", **cfg_kw)
                kw = _fault_operands(topo, cfg) if ops == "faults" else {}
                results, _ = js.run_batch(topo, cfg, traces, **kw)
                runs[scheme][mode] = {t: stats(r, tr, topo)
                                      for t, r, tr in zip(names, results, traces)}
                print(name, scheme, mode, runs[scheme][mode], flush=True)
        cases[name] = dict(flows=[int(np.asarray(t.valid).sum()) for t in traces],
                           config=cfg_kw, runs=runs)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip()
    REFERENCE.write_text(json.dumps({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_adaptive.py "
                   "--write-adaptive-reference",
        "source": "JAX package, netsim.sweep.run_batch per (scheme, mode); "
                  "metrics.fct_stats at full precision",
        "commit": commit, "backend": "cpu", "cases": cases,
    }, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-adaptive-reference"]:
        write_adaptive_reference()
    else:
        sys.exit("usage: test_torch_adaptive.py --write-adaptive-reference")
