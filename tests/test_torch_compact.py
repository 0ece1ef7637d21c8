"""The port's active-window engine against the JAX package's.

* One step from a carried, congested mid-run state: integer, bitmap and
  path leaves exactly equal; float leaves to rtol 1e-5, plus 1e-5 of the
  leaf's largest magnitude where a subtraction cancels (one step of the
  same float32 arithmetic, with segment sums in another order).
* End to end on leaf_spine(2, 4, 4): the same finished flows, every
  finish time on the same dt step (rtol 1e-6: the two sides round
  t + dt differently in the last bit), and FCT stats within 0.1 %.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.netsim import compact as jc, engine as je, metrics as jm  # noqa: E402
from repro.netsim import topology as jt, workloads as jw  # noqa: E402
from repro_torch.netsim import carry, compact as tc, engine as te  # noqa: E402
from repro_torch.netsim import metrics as tm, sweep as tsweep, topology as tt  # noqa: E402

SCHEMES = ("seqbalance", "ecmp", "letflow", "conga", "drill")
CARRY_STEPS = 150
CARRY_CHUNK = 10


def _setup(load, dur=1.5e-3):
    jtopo = jt.leaf_spine(2, 4, 4, 100e9)
    ttopo = tt.leaf_spine(2, 4, 4, 100e9, device="cpu")
    trace = jw.poisson_trace(jw.TraceConfig(
        workload="alistorage", load=load, duration_s=dur, n_hosts=jtopo.n_hosts,
        host_bw=100e9, seed=0, hosts_per_leaf=jtopo.hosts_per_leaf,
        load_base_bw=2 * 4 * 100e9))
    return jtopo, ttopo, trace


def _leaves(state) -> dict:
    return {k: (v._asdict() if hasattr(v, "_asdict") else v)
            for k, v in state._asdict().items()}


def _compare_states(j, t):
    jl, n_int = _leaves(j), 0
    tl = _leaves(t)
    for k, tv in tl.items():
        pairs = [(f"{k}.{f}", jl[k][f], v) for f, v in tv.items()] if isinstance(tv, dict) \
            else [(k, jl[k], tv)]
        for name, a, b in pairs:
            a = np.asarray(a)
            b = b[0].numpy()
            assert a.shape == b.shape, name
            if a.dtype.kind == "f":
                # rtol 1e-5 elementwise, and 1e-5 of the leaf's scale where a
                # subtraction cancels (remaining bytes near zero)
                scale = np.abs(a[np.isfinite(a)]).max(initial=0.0)
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale + 1e-6,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                              err_msg=name)
                n_int += 1
    assert n_int >= 15


@pytest.mark.parametrize("scheme", SCHEMES)
def test_one_step_from_carried_congested_state(scheme):
    jtopo, ttopo, trace = _setup(load=0.8)
    jcfg = je.SimConfig(scheme=scheme, duration_s=6e-3)
    arrays, _, F = jc.sort_trace(trace)
    F_pad = F
    W, A = jc.plan_single_window(jtopo, jcfg, arrays, F_pad)
    init, step_fn, _ = jc.build_compact_sim(jtopo, jcfg, arrays, W, F_pad, A)
    run = jax.jit(lambda s: jax.lax.scan(step_fn, s, None, length=CARRY_CHUNK)[0])
    mid = init()
    # carry at the first chunk boundary with a queue above kmin: marks live
    for _ in range(CARRY_STEPS // CARRY_CHUNK):
        mid = run(mid)
        if int(mid.step) >= 50 and float(jnp.max(mid.queue)) > jcfg.dcqcn.kmin_bytes:
            break
    assert float(jnp.max(mid.queue)) > jcfg.dcqcn.kmin_bytes
    j_next, j_out = jax.jit(step_fn)(mid)

    cfg = carry.config_from_dict(
        {**dataclasses.asdict(jcfg), "dcqcn": jcfg.dcqcn._asdict()})
    t_arrays = tc.trace_tensors(tuple(a[None] for a in arrays), "cpu")
    _, t_step, _ = tc.build_compact_sim(ttopo, cfg, t_arrays, W, F_pad, A)
    state = carry.compact_state_from_numpy(
        jax.tree.map(np.asarray, _leaves(mid)), "cpu")
    _compare_states(mid, state)  # the carry itself is exact
    t_next, t_out = t_step(state)
    _compare_states(j_next, t_next)
    for f in te.StepOutputs._fields:
        np.testing.assert_allclose(np.asarray(getattr(j_out, f)), getattr(t_out, f)[0].numpy(),
                                   rtol=1e-5, atol=1e-3, err_msg=f)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_simulate_compact_end_to_end(scheme):
    jtopo, ttopo, trace = _setup(load=0.5)
    dt = 10e-6
    jr, _ = jc.simulate_compact(jtopo, je.SimConfig(scheme=scheme, duration_s=6e-3), trace)
    tr, outs = tc.simulate_compact(ttopo, te.SimConfig(scheme=scheme, duration_s=6e-3),
                                   trace, device="cpu")
    assert jr.spill_steps == 0 and tr.spill_steps == 0
    fj, ft = np.asarray(jr.finish), tr.finish
    np.testing.assert_array_equal(np.isfinite(fj), np.isfinite(ft))
    done = np.isfinite(fj)
    assert done.sum() > 1000
    # every finish lands on the same dt step (ulp-level differences in t + dt)
    np.testing.assert_allclose(ft[done], fj[done], rtol=1e-6, atol=0.0)
    assert np.all(np.abs(ft[done] - fj[done]) <= dt)
    js = jm.fct_stats(jr, trace, jtopo, 100e9)
    ts = tm.fct_stats(tr, trace, ttopo, 100e9)
    for k in ("avg_slowdown", "p99_slowdown"):
        assert ts[k] == pytest.approx(js[k], rel=1e-3), k
    assert ts["completion_rate"] == js["completion_rate"]
    np.testing.assert_allclose(float(tr.cnp_pkts), float(jr.cnp_pkts), rtol=1e-4, atol=1e-3)
    assert outs.goodput_total.shape == (600,) and outs.uplink_load.shape == (600, 2, 4)


def test_default_window_spills_as_the_reference_does():
    """At load 0.8 the default planner's window is too small for
    SeqBalance on this fabric, in both packages: the port spills on the
    same steps as the reference and finishes the same flows on the same
    dt step."""
    jtopo, ttopo, trace = _setup(load=0.8)
    jr, _ = jc.simulate_compact(jtopo, je.SimConfig(scheme="seqbalance", duration_s=6e-3),
                                trace)
    tr, _ = tc.simulate_compact(ttopo, te.SimConfig(scheme="seqbalance", duration_s=6e-3),
                                trace, device="cpu")
    assert tr.window_slots == jr.window_slots
    assert tr.spill_steps == int(jr.spill_steps) > 0
    fj, ft = np.asarray(jr.finish), tr.finish
    np.testing.assert_array_equal(np.isfinite(fj), np.isfinite(ft))
    done = np.isfinite(fj)
    assert np.all(np.abs(ft[done] - fj[done]) <= 10e-6)


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas", "pallas_interpret"])
def test_carried_config_lets_the_device_pick_the_dataplane(backend):
    cfg = carry.config_from_dict({**dataclasses.asdict(je.SimConfig(dataplane=backend)),
                                  "dcqcn": je.SimConfig().dcqcn._asdict()})
    assert cfg.dataplane == "auto"


def test_unported_features_raise():
    """The features that raised until the single-run engine was whole now
    run: the flowlet_timeout scheme (carried configurations too), the dense
    engine's reorder cost and the sweep's recorder."""
    from repro_torch.obs import RecordSpec

    assert te.SimConfig(scheme="flowlet_timeout").n_sub == 1
    assert carry.config_from_dict({"scheme": "flowlet_timeout"}).scheme == "flowlet_timeout"
    _, ttopo, trace = _setup(0.5, dur=1e-4)
    st, _ = te.simulate(ttopo, te.SimConfig(duration_s=1e-4), trace, reorder=1.0, device="cpu")
    assert int(st.step) == 10
    res, _ = tsweep.run_one(ttopo, te.SimConfig(duration_s=1e-4), trace, device="cpu",
                            record=RecordSpec())
    assert int(res.ring.count[0]) > 0


def test_carried_adaptive_config_comes_across_whole():
    """An adaptive configuration of the JAX package, margins and macro-step
    included, becomes the port's field for field (but for the dataplane
    backend and the reference's mark salt)."""
    jcfg = je.SimConfig(scheme="ecmp", adaptive=True, ff_macro_chunks=3, ff_kmin_frac=0.75,
                        ff_margin_steps=5, chunk_steps=20, uplink_sample_every=10)
    cfg = carry.config_from_dict({**dataclasses.asdict(jcfg), "dcqcn": jcfg.dcqcn._asdict()})
    for f in dataclasses.fields(cfg):
        want = getattr(jcfg, f.name)
        want = tuple(want) if f.name == "dcqcn" else want
        got = tuple(cfg.dcqcn) if f.name == "dcqcn" else getattr(cfg, f.name)
        assert got == ("auto" if f.name == "dataplane" else want), f.name
    assert cfg.adaptive and cfg.ff_macro_chunks == 3
    with pytest.raises(ValueError):
        carry.config_from_dict({**dataclasses.asdict(jcfg), "ff_kmin_frac": 0.0,
                                "dcqcn": jcfg.dcqcn._asdict()})
