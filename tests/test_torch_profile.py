"""The port's per-phase profiler (``netsim/profile.py``) and the six step
closures of ``compact.build_compact_sim`` against the JAX package's:
a step composed from the closures is ``step_fn``'s bit for bit, the
quiescence predicate flags the same chunk boundaries of bench_adaptive_dt's
collective as the JAX package's replay, and ``profile_phases`` times every
phase."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.dist import collectives as j_col, cosim as j_cos  # noqa: E402
from repro.netsim import compact as jc, engine as je, profile as jp  # noqa: E402
from repro.netsim import topology as jt, workloads as jw  # noqa: E402
from repro_torch.dist import collectives as t_col, cosim as t_cos  # noqa: E402
from repro_torch.netsim import compact as tc, engine as te, profile as tp  # noqa: E402
from repro_torch.netsim import sweep as ts, topology as tt, workloads as tw  # noqa: E402

# bench_adaptive_dt's collective on leaf_spine(4, 4, 4), cut from 14 ms to
# 4 ms: the first two rounds of the ring, with the compute gaps between them
HORIZON = dict(scheme="seqbalance", duration_s=4e-3, uplink_sample_every=10)


def _collective(wl, col, cos, topo):
    """bench_adaptive_dt's trace: a 4-chunk bidirectional ring of 8, 4 MB,
    with 800 us compute gaps between rounds."""
    plan = col.PathPlan(n_chunks=4, directions=(1, -1, 1, -1))
    return wl.collective_trace(plan, cos.ring_hosts(topo, 8), 4e6, link_bw=100e9,
                               round_gap_s=800e-6, seed=0, steer_paths=topo.n_paths)


def _poisson(topo):
    return tw.poisson_trace(tw.TraceConfig(
        workload="alistorage", load=0.8, duration_s=0.6e-3, n_hosts=topo.n_hosts,
        host_bw=100e9, seed=3, hosts_per_leaf=topo.hosts_per_leaf,
        load_base_bw=topo.n_leaf * topo.n_paths * 100e9))


def _same(a, b) -> bool:
    """Two states or outputs (nested NamedTuples of tensors) bit for bit."""
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


@pytest.mark.parametrize("scheme", ["seqbalance", "conga"])
def test_step_composed_from_the_phases_is_step_fn(scheme):
    """admit, cascade, dcqcn and finish, composed as step_fn composes them,
    give its state and outputs bit for bit, on a mid-run state of a
    batch of two traces."""
    topo = tt.leaf_spine(2, 4, 4, 100e9, device="cpu")
    cfg = te.SimConfig(scheme=scheme, duration_s=1e-3)
    traces = [_poisson(topo), _collective(tw, t_col, t_cos, topo)]
    F_pad, W, A, padded = ts.plan_group(topo, cfg, [tc.sort_trace(t) for t in traces])
    init, step_fn, phases = tc.build_compact_sim(
        topo, cfg, ts.stack_group(padded, [0, 1], "cpu"), W, F_pad, A)
    assert sorted(phases) == sorted(["admit", "cascade", "dcqcn", "finish", "quiesce",
                                     "fast_forward"])
    st = init()
    for _ in range(30):
        st, _ = step_fn(st)
    want_state, want_out = step_fn(st)
    t = st.step.to(torch.float32) * cfg.dt
    sa = phases["admit"](st)
    arrival, new_queue, thr, p_sub, p_fab, rc, active = phases["cascade"](sa)
    cc = phases["dcqcn"](sa, p_sub, active)
    remaining, sub_done, cqe, slot_fid, finish, table, cong = phases["finish"](
        sa, t, thr, active, rc, p_fab)
    got_state = sa._replace(slot_fid=slot_fid, remaining=remaining, sub_done=sub_done, cc=cc,
                            cqe_bitmap=cqe, finish=finish, table=table, queue=new_queue,
                            cnp_pkts=sa.cnp_pkts + cong, step=sa.step + 1)
    uplink_ids = torch.as_tensor(topo.uplink_ids.astype(np.int64))
    got_out = te.StepOutputs(uplink_load=arrival[:, uplink_ids],
                             goodput_total=torch.where(active, thr, 0.0).sum((1, 2)),
                             cnp_rate=cong, max_queue=new_queue[:, :topo.n_links].amax(1))
    assert _same(got_state, want_state) and _same(got_out, want_out)


def _jax_flags(topo, cfg, trace):
    """The JAX package's quiescence_profile replay, keeping the flag of
    every chunk boundary (it returns only their aggregates)."""
    arrays, _, F = jc.sort_trace(trace)
    F_pad = max(F, 1)
    W, A = jc.plan_single_window(topo, cfg, arrays, F_pad)
    _, step_fn, phases = jc.build_compact_sim(topo, cfg, tuple(jnp.asarray(a) for a in arrays),
                                              W, F_pad, A)
    K, n_chunks, _ = jc.plan_chunks(cfg, int(round(cfg.duration_s / cfg.dt)))

    def one(st, _):
        quiet = phases["quiesce"](st, K)
        return jax.lax.scan(step_fn, st, None, length=K)[0], quiet

    st0 = jc.init_compact_state(topo, cfg, W, F_pad)
    return np.asarray(jax.jit(lambda s: jax.lax.scan(one, s, None, length=n_chunks)[1])(st0))


def _torch_flags(topo, cfg, trace):
    """The port's replay as quiescence_profile steps it, keeping the flag
    of every chunk boundary."""
    arrays, _, F = tc.sort_trace(trace)
    F_pad = max(F, 1)
    W, A = tc.plan_single_window(topo, cfg, arrays, F_pad)
    init, step_fn, phases = tc.build_compact_sim(
        topo, cfg, ts.stack_group([tc.pad_trace_arrays(arrays, F_pad)], [0], "cpu"), W,
        F_pad, A)
    K, n_chunks, _ = tc.plan_chunks(cfg, int(round(cfg.duration_s / cfg.dt)))
    st, flags = init(), []
    for _ in range(n_chunks):
        flags.append(bool(phases["quiesce"](st, K)[1][0]))
        for _ in range(K):
            st, _ = step_fn(st)
    return np.array(flags)


def test_quiescence_profile_matches_reference():
    """The flag of every chunk boundary of the collective equal to the JAX
    package's replay, and quiescence_profile's ff_fraction, macro_hist,
    chunk_steps and n_chunks equal to the JAX package's."""
    jtopo, ttopo = jt.leaf_spine(4, 4, 4, 100e9), tt.leaf_spine(4, 4, 4, 100e9, device="cpu")
    jtr = _collective(jw, j_col, j_cos, jtopo)
    ttr = _collective(tw, t_col, t_cos, ttopo)
    jcfg, tcfg = je.SimConfig(**HORIZON), te.SimConfig(**HORIZON)
    want = jp.quiescence_profile(jtopo, jcfg, jtr, iters=1)
    got = tp.quiescence_profile(ttopo, tcfg, ttr, iters=1, device="cpu")
    flags = _torch_flags(ttopo, tcfg, ttr)
    jflags = _jax_flags(jtopo, jcfg, jtr)
    assert flags.any() and not flags.all()
    np.testing.assert_array_equal(flags, jflags)
    assert got["ff_fraction"] == float(flags.mean())
    for k in ("ff_fraction", "macro_hist", "chunk_steps", "n_chunks"):
        assert got[k] == want[k], k
    assert got["predicate_us"] > 0.0 and len(got["predicate_us"].samples) == 1


def test_profile_phases_times_every_phase():
    """profile_phases returns every key of the JAX package's, each time
    positive with its samples, on one trace and on a batch of two."""
    topo = tt.leaf_spine(2, 4, 4, 100e9, device="cpu")
    cfg = te.SimConfig(scheme="seqbalance", duration_s=1e-3)
    trace = _poisson(topo)
    for arg in (trace, [trace, _collective(tw, t_col, t_cos, topo)]):
        out = tp.profile_phases(topo, cfg, arg, warm_steps=20, iters=3, device="cpu")
        assert sorted(out) == sorted(["admit", "cascade", "dcqcn", "finish", "step_fused",
                                      "quiesce", "phase_sum", "window_slots"])
        for k in ("admit", "cascade", "dcqcn", "finish", "step_fused", "quiesce"):
            assert out[k] > 0.0 and len(out[k].samples) == 3, k
            assert out[k].stats()["min_us"] == round(float(out[k]), 3)
        assert out["phase_sum"] == pytest.approx(sum(out[k] for k in ("admit", "cascade",
                                                                     "dcqcn", "finish")))
        assert isinstance(out["window_slots"], int) and out["window_slots"] >= 8
