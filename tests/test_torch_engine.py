"""The port's dense engine (``engine.simulate``) against the JAX package's,
and against the port's active-window engine.

* On leaf_spine(2, 4, 4) with a 6 ms horizon (the setup of
  tests/test_netsim_compact.py::test_compact_matches_dense_oracle): the
  same finished flows, every finish time on the same dt step (rtol 1e-6:
  the two sides round t + dt differently in the last bit), cnp_pkts
  within rtol 1e-5 (sums over every sub-flow in another order), at loads
  0.5 and 0.8.
* On a small three_tier, the same at load 0.6.
* Dense against compact in the port, at 0 spill (a window of every flow):
  the same finished flows, finish rtol 1e-6, cnp_pkts rtol 1e-5, at loads
  0.5 and 0.8.

One case cannot be held to the same step: DRILL at load 0.8.  There a
link runs at its capacity, its queue is a difference of nearly equal
float32 sums, and DRILL's inverse-queue spray weights carry a last-bit
change of a sum into a flow's rate, which can move the flow across the
DONE_EPS_BYTES cut a step early or late.  The JAX package's own two
engines, the same physics with the sums in another order (flows in trace
order against slots in admission order), move 4 of the 2,752 finish times
there.  That is the witness: the port is held to the reference's own
spread, no more finish times moved than the JAX dense engine and the JAX
active-window engine move against each other, and none further.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.netsim import compact as jc, engine as je, topology as jt  # noqa: E402
from repro.netsim import workloads as jw  # noqa: E402
from repro_torch.netsim import compact as tc, engine as te, topology as tt  # noqa: E402

SCHEMES = ("seqbalance", "ecmp", "letflow", "conga", "drill")


def _leaf_spine_trace(load):
    return jw.poisson_trace(jw.TraceConfig(
        workload="alistorage", load=load, duration_s=1.5e-3, n_hosts=8, host_bw=100e9,
        seed=0, hosts_per_leaf=4, load_base_bw=2 * 4 * 100e9))


@functools.cache
def _jax_dense(scheme, load):
    st, outs = je.simulate(jt.leaf_spine(2, 4, 4, 100e9),
                           je.SimConfig(scheme=scheme, duration_s=6e-3),
                           _leaf_spine_trace(load))
    return np.asarray(st.finish), float(st.cnp_pkts), {
        f: np.asarray(getattr(outs, f)) for f in je.StepOutputs._fields}


@functools.cache
def _torch_dense(scheme, load):
    st, outs = te.simulate(tt.leaf_spine(2, 4, 4, 100e9, device="cpu"),
                           te.SimConfig(scheme=scheme, duration_s=6e-3),
                           _leaf_spine_trace(load), device="cpu")
    return st.finish.numpy(), float(st.cnp_pkts), {
        f: getattr(outs, f).numpy() for f in te.StepOutputs._fields}


def _moved(want, got):
    """(how many finish times differ past rtol 1e-6, the largest difference)."""
    done = np.isfinite(want)
    diff = np.abs(got[done] - want[done])
    return int((diff > 1e-6 * want[done]).sum()), float(diff.max())


@functools.cache
def _reference_spread(scheme, load):
    """The JAX dense engine against the JAX active-window engine with a
    window of every flow: the finish times that the reference itself moves
    when only the order of its sums changes.  (0, ...) where it holds
    itself to the same step."""
    trace = _leaf_spine_trace(load)
    res, _ = jc.simulate_compact(jt.leaf_spine(2, 4, 4, 100e9),
                                 je.SimConfig(scheme=scheme, duration_s=6e-3), trace,
                                 window_slots=len(trace.sizes))
    assert res.spill_steps == 0
    return _moved(_jax_dense(scheme, load)[0], np.asarray(res.finish))


def _same_finishes(want, got, spread=None):
    """The same finished flows, each on the same dt step; or, given the
    reference's own ``spread``, no more finish times moved and none
    further."""
    np.testing.assert_array_equal(np.isfinite(want), np.isfinite(got))
    done = np.isfinite(want)
    assert done.sum() > 500
    if spread is None:
        np.testing.assert_allclose(got[done], want[done], rtol=1e-6, atol=0.0)
    else:
        n, worst = _moved(want, got)
        assert n <= spread[0] and worst <= spread[1] * (1 + 1e-6), (n, worst, spread)


def _drill_heavy_spread(scheme, load):
    """None, except for DRILL at load 0.8, where the reference's own
    spread is returned, and shown not to be empty (see the docstring)."""
    if (scheme, load) != ("drill", 0.8):
        return None
    spread = _reference_spread(scheme, load)
    assert spread[0] > 0
    return spread


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("load", [0.5, 0.8])
def test_dense_matches_reference(scheme, load):
    jf, jcnp, jouts = _jax_dense(scheme, load)
    tf, tcnp, touts = _torch_dense(scheme, load)
    _same_finishes(jf, tf, _drill_heavy_spread(scheme, load))
    np.testing.assert_allclose(tcnp, jcnp, rtol=1e-5, atol=1e-3)
    for f, a in jouts.items():
        assert touts[f].shape == a.shape == ((600, 2, 4) if f == "uplink_load" else (600,))
    if load == 0.5:  # the same flows in flight on every step
        np.testing.assert_allclose(touts["goodput_total"], jouts["goodput_total"],
                                   rtol=1e-4, atol=1e3)
        np.testing.assert_allclose(touts["max_queue"], jouts["max_queue"],
                                   rtol=1e-4, atol=1.0)


@pytest.mark.parametrize("scheme", ["seqbalance", "ecmp", "letflow"])
def test_dense_matches_reference_three_tier(scheme):
    """The 3-tier fabric (4 fabric hops, 24 paths), the trace of
    tests/test_torch_topology.py::test_simulate_compact_three_tier."""
    kw = dict(bw_tor_agg=400e9, bw_agg_core=100e9)
    jtopo = jt.three_tier(4, 4, 2, 3, **kw)
    trace = jw.poisson_trace(jw.TraceConfig(
        workload="alistorage", load=0.6, duration_s=1e-3, n_hosts=jtopo.n_hosts,
        host_bw=100e9, seed=3, hosts_per_leaf=jtopo.hosts_per_leaf,
        load_base_bw=4 * 4 * 2 * 100e9))
    js, _ = je.simulate(jtopo, je.SimConfig(scheme=scheme, duration_s=4e-3), trace)
    ts, _ = te.simulate(tt.three_tier(4, 4, 2, 3, device="cpu", **kw),
                        te.SimConfig(scheme=scheme, duration_s=4e-3), trace, device="cpu")
    _same_finishes(np.asarray(js.finish), ts.finish.numpy())
    np.testing.assert_allclose(float(ts.cnp_pkts), float(js.cnp_pkts), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("load", [0.5, 0.8])
def test_dense_matches_compact(scheme, load):
    """tests/test_netsim_compact.py::test_compact_matches_dense_oracle in
    the port: the two engines are the same physics over another state."""
    trace = _leaf_spine_trace(load)
    tf, tcnp, _ = _torch_dense(scheme, load)
    res, _ = tc.simulate_compact(tt.leaf_spine(2, 4, 4, 100e9, device="cpu"),
                                 te.SimConfig(scheme=scheme, duration_s=6e-3), trace,
                                 window_slots=len(trace.sizes), device="cpu")
    assert res.spill_steps == 0
    _same_finishes(tf, res.finish, _drill_heavy_spread(scheme, load))
    np.testing.assert_allclose(float(res.cnp_pkts), tcnp, rtol=1e-5, atol=1e-3)


def test_dense_state_and_refusals():
    topo = tt.leaf_spine(2, 4, 4, 100e9, device="cpu")
    trace = _leaf_spine_trace(0.5)
    cfg = te.SimConfig(scheme="seqbalance", duration_s=2e-4)
    st, outs = te.simulate(topo, cfg, trace, device="cpu")
    F = len(trace.sizes)
    assert st.remaining.shape == st.path.shape == st.sub_done.shape == (F, 4)
    assert st.finish.shape == st.assigned.shape == st.cqe.bitmap.shape == (F,)
    assert int(st.step) == 20 and outs.goodput_total.shape == (20,)
    assert st.table.inactive_until.shape == (2, 4) and st.queue.shape == (topo.n_links + 1,)
    with pytest.raises(ValueError, match="2-tier"):
        te.simulate(tt.three_tier(4, 4, 2, 3, device="cpu"), te.SimConfig(scheme="conga"),
                    trace, device="cpu")
