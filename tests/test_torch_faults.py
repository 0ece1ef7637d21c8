"""The port's fault layer against the JAX package's: ``netsim/faults.py``
(a numpy copy: the same seed draws the same campaign, bit for bit), the
topology's fault maps, and the compact engine's traced ``capacity``
(vector or wall-clock schedule) and ``loss`` operands end to end."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.netsim import dataplane as jdp, engine as je, faults as jf  # noqa: E402
from repro.netsim import sweep as js, topology as jt, workloads as jw  # noqa: E402
from repro_torch.kernels import cascade_tiered as ct  # noqa: E402
from repro_torch.netsim import compact as tc, dataplane as tdp, engine as te  # noqa: E402
from repro_torch.netsim import faults as tf, sweep as ts, topology as tt  # noqa: E402

DT = 10e-6


def _events(camp):
    return [(type(ev).__name__, dataclasses.asdict(ev)) for ev in camp.events]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_campaign_matches_reference(seed):
    """The same draw, and per epoch the same capacity schedule, loss vector,
    stragglers and mid-epoch onset, exactly."""
    jtopo, ttopo = jt.sim_2tier(), tt.sim_2tier(device="cpu")
    kw = dict(seed=seed, epochs=8, n_faults=4, n_ranks=8)
    jc, tc_ = jf.random_campaign(jtopo, **kw), tf.random_campaign(ttopo, **kw)
    assert _events(tc_) == _events(jc)
    assert tc_.summary() == jc.summary() and tc_.has_loss() == jc.has_loss()
    for epoch in range(8):
        np.testing.assert_array_equal(tc_.capacity_schedule(ttopo, epoch),
                                      jc.capacity_schedule(jtopo, epoch))
        np.testing.assert_array_equal(tc_.loss_at(ttopo, epoch), jc.loss_at(jtopo, epoch))
        assert tc_.straggler_slowdowns(epoch) == jc.straggler_slowdowns(epoch)
        assert tc_.midepoch_onset(ttopo, epoch) == jc.midepoch_onset(jtopo, epoch)
    for n, align in ((100, 1), (3, 1), (100, 20), (1000, 20), (1000, 1), (1400, 20)):
        assert tc_.seg_steps(n, align=align) == jc.seg_steps(n, align=align)


@pytest.mark.parametrize("kind", ["leaf_spine", "three_tier"])
def test_spine_links_and_paths_for_link_match_reference(kind):
    if kind == "leaf_spine":
        jtopo, ttopo = jt.leaf_spine(4, 6, 2, 100e9), tt.leaf_spine(4, 6, 2, 100e9, device="cpu")
    else:
        args = dict(n_tor=4, n_agg=3, n_core=2, hosts_per_tor=2)
        jtopo, ttopo = jt.three_tier(**args), tt.three_tier(**args, device="cpu")
    for spine in range(ttopo.uplink_ids.shape[1]):
        assert tt.spine_links(ttopo, spine) == jt.spine_links(jtopo, spine)
    for link in range(ttopo.n_links + 1):
        assert tt.paths_for_link(ttopo, link) == jt.paths_for_link(jtopo, link)
    camp = dict(seed=5, epochs=6, n_faults=3)
    assert _events(tf.random_campaign(ttopo, **camp)) == _events(jf.random_campaign(jtopo, **camp))


def test_telemetry_channel_matches_reference():
    """A degraded control plane (loss, delay with jitter, duplicates,
    reordering, a blackout): the same deliveries epoch by epoch."""
    kw = dict(loss=0.2, delay_epochs=1, jitter_epochs=2, dup=0.3, reorder=True, seed=7,
              blackout=(5, 7))
    jch, tch = jf.TelemetryChannel(**kw), tf.TelemetryChannel(**kw)
    for epoch in range(12):
        for i in range(5):
            for ch in (jch, tch):
                ch.send(("slow", (epoch * 5 + i) % 12), epoch)
        assert tch.deliver(epoch) == jch.deliver(epoch)
    assert (tch.sent, tch.dropped, tch.delivered) == (jch.sent, jch.dropped, jch.delivered)


def test_lossy_gbn_factor_matches_reference():
    """Per-hop loss composed along each sub-flow's path, host hops shared,
    absent (-1) hops loss-free, on a batch of two against each row."""
    rng = np.random.default_rng(0)
    nl, W, N, hf = 24, 10, 4, 2
    fab = rng.integers(0, 16, (2, W, N, hf)).astype(np.int32)
    fab[rng.uniform(size=fab.shape) < 0.2] = -1
    tx = rng.integers(16, 20, (2, W)).astype(np.int32)
    rx = rng.integers(20, 24, (2, W)).astype(np.int32)
    loss = rng.uniform(0, 0.05, nl + 1).astype(np.float32)
    loss[nl] = 0.0
    got = tdp.lossy_gbn_factor(torch.as_tensor(fab), torch.as_tensor(tx), torch.as_tensor(rx),
                               torch.as_tensor(loss), n_links=nl, window_pkts=16.0)
    for b in range(2):
        want = jdp.lossy_gbn_factor(jnp.asarray(fab[b]), jnp.asarray(tx[b]),
                                    jnp.asarray(rx[b]), jnp.asarray(loss), n_links=nl,
                                    window_pkts=16.0)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=1e-6, atol=0.0)


def _small():
    """tests/test_faults.py:199-229's setup: leaf_spine(2, 4, 2, 40e9) under
    fixed 500 KB flows at load 0.3."""
    jtopo, ttopo = jt.leaf_spine(2, 4, 2, 40e9), tt.leaf_spine(2, 4, 2, 40e9, device="cpu")
    trace = jw.poisson_trace(jw.TraceConfig(
        workload="fixed:5e5", load=0.3, duration_s=1e-3, n_hosts=jtopo.n_hosts,
        host_bw=40e9, seed=5, hosts_per_leaf=2))
    return jtopo, ttopo, trace


def _finish_close(got, want):
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    done = np.isfinite(want)
    assert np.all(np.abs(got[done] - want[done]) <= DT + 1e-9)


@pytest.mark.parametrize("scheme", ["seqbalance", "drill"])
def test_topology_capacity_as_operand_is_no_operand(scheme):
    _, topo, trace = _small()
    cfg = te.SimConfig(scheme=scheme, duration_s=1.5e-3)
    plain, _ = ts.run_one(topo, cfg, trace, device="cpu")
    given, _ = ts.run_one(topo, cfg, trace, device="cpu", capacity=topo.capacity.numpy())
    np.testing.assert_array_equal(given.finish, plain.finish)
    assert float(given.cnp_pkts) == float(plain.cnp_pkts)


@pytest.mark.parametrize("scheme,adaptive", [("seqbalance", False), ("ecmp", True),
                                             ("drill", False)])
def test_schedule_and_loss_match_reference(scheme, adaptive):
    """A wall-clock schedule that pauses spine 1 for one of four segments,
    and (but for DRILL) 0.5 % loss on spine 0: the JAX package's finish
    times within one dt, and other finish times than the healthy fabric's."""
    jtopo, ttopo, trace = _small()
    n_steps = 150
    camp = tf.FaultCampaign(events=(
        tf.PauseWindow(links=tt.spine_links(ttopo, 1), start_epoch=0, onset_frac=0.25,
                       width_frac=0.25),
        tf.LossyLink(links=tt.spine_links(ttopo, 0), loss_rate=0.005, start_epoch=0)),
        n_segments=4)
    cap = camp.capacity_schedule(ttopo, 0)
    assert (cap[1] == 0).sum() == 4 and (cap[0] == 0).sum() == 0  # 2 uplinks, 2 downlinks
    ops = dict(capacity=cap, cap_seg_steps=camp.seg_steps(n_steps, align=10))
    if scheme != "drill":
        ops["loss"] = camp.loss_at(ttopo, 0)
    kw = dict(scheme=scheme, duration_s=n_steps * DT, adaptive=adaptive)
    want, _ = js.run_one(jtopo, je.SimConfig(**kw), trace, **ops)
    got, _ = ts.run_one(ttopo, te.SimConfig(**kw), trace, device="cpu", **ops)
    _finish_close(got.finish, np.asarray(want.finish))
    assert got.ff_steps == int(want.ff_steps)
    healthy, _ = ts.run_one(ttopo, te.SimConfig(**kw), trace, device="cpu")
    assert not np.array_equal(healthy.finish, got.finish)


def test_lossy_link_inflates_fct():
    """tests/test_faults.py:199-229 on the port: go-back-N rewinds stretch
    finish times, never shorten them, and a zero-loss vector is no loss
    operand at all."""
    _, topo, trace = _small()
    cfg = te.SimConfig(scheme="ecmp", duration_s=1e-3)
    cap = topo.capacity.numpy().copy()
    zeros = np.zeros(topo.n_links + 1, np.float32)
    lossy = zeros.copy()
    lossy[:2 * 4] = 0.005  # every leaf->spine link drops 0.5 %
    clean, _ = ts.run_one(topo, cfg, trace, device="cpu", capacity=cap, loss=zeros)
    lossy_r, _ = ts.run_one(topo, cfg, trace, device="cpu", capacity=cap, loss=lossy)
    fin_c, fin_l = clean.finish, lossy_r.finish
    done = np.isfinite(fin_c) & np.isfinite(fin_l)
    assert done.sum() >= 10
    assert fin_l[done].mean() > 1.02 * fin_c[done].mean()
    assert (fin_l[done] >= fin_c[done] - 1e-9).all()
    assert np.isfinite(fin_l).sum() <= np.isfinite(fin_c).sum()
    none, _ = ts.run_one(topo, cfg, trace, device="cpu", capacity=cap)
    np.testing.assert_array_equal(none.finish, fin_c)


def test_zero_capacity_row_fills_queues_without_nan():
    """A paused link (capacity 0): the cascade scales its flows to 0, its
    queue grows to qmax and its mark reaches 1, with no NaN, in the
    kernel's plain version and in integrate_queue; a run whose schedule
    pauses every uplink for a segment stays finite and matches the JAX
    package within one dt."""
    topo = tt.leaf_spine(2, 4, 2, 40e9, device="cpu")
    nl, L1 = topo.n_links, topo.n_links + 1
    cap = topo.capacity.clone()
    cap[:8] = 0.0
    qmask = tdp.queue_mask_for(topo)
    fab = topo.fabric_links(torch.zeros(1, 3, 1, dtype=torch.int64),
                            torch.ones(1, 3, 1, dtype=torch.int64),
                            torch.arange(3).reshape(1, 3, 1))
    tx, rx = topo.nic_links(torch.zeros(1, 3, dtype=torch.int64),
                            torch.full((1, 3), 2, dtype=torch.int64))
    rates = torch.full((1, 3, 1), 40e9)
    queue = torch.zeros(1, L1)
    dp = te.SimConfig().dcqcn
    for _ in range(600):  # 3 flows share a 40G NIC: 16.7 KB a step into each paused link
        arrival, queue, mark, thr = ct.cascade_tiered_torch(
            fab.to(torch.int32), tx, rx, rates, queue, cap, qmask, kmin=dp.kmin_bytes,
            kmax=dp.kmax_bytes, pmax=dp.pmax, dt=DT, qmax_bytes=8e6)
        for x in (arrival, queue, mark, thr):
            assert torch.isfinite(x).all()
    assert (thr == 0).all() and float(queue[0, :8].max()) == 8e6
    assert float(mark[0, :8].max()) == 1.0
    q2, m2 = tdp.integrate_queue(torch.zeros(1, L1), arrival, cap, qmask, dp, dt=DT,
                                 qmax_bytes=8e6, n_links=nl)
    assert torch.isfinite(q2).all() and torch.isfinite(m2).all()

    jtopo, _, trace = _small()
    sched = np.repeat(topo.capacity.numpy()[None], 3, 0)
    sched[1, :8] = 0.0
    ops = dict(capacity=sched, cap_seg_steps=40)
    kw = dict(scheme="seqbalance", duration_s=1.5e-3)
    got, outs = ts.run_one(topo, te.SimConfig(**kw), trace, device="cpu", **ops)
    want, _ = js.run_one(jtopo, je.SimConfig(**kw), trace, **ops)
    for f in te.StepOutputs._fields:
        assert np.isfinite(getattr(outs, f)).all(), f
    assert outs.max_queue[40:80].max() > dp.kmin_bytes  # the paused segment marks
    _finish_close(got.finish, np.asarray(want.finish))


def test_loss_operand_rules():
    """As in the reference: the engine needs an explicit capacity beside
    ``loss`` and refuses it with DRILL; the sweep supplies the topology's
    capacity when ``loss`` comes alone."""
    _, topo, trace = _small()
    arrays, _, F = tc.sort_trace(trace)
    t_arrays = tc.trace_tensors(tuple(a[None] for a in arrays), "cpu")
    loss = torch.full((topo.n_links + 1,), 0.01)
    with pytest.raises(ValueError, match="capacity"):
        tc.build_compact_sim(topo, te.SimConfig(), t_arrays, 64, F, 32, loss=loss)
    with pytest.raises(ValueError, match="DRILL"):
        tc.build_compact_sim(topo, te.SimConfig(scheme="drill"), t_arrays, 64, F, 32,
                             capacity=topo.capacity, loss=loss)
    with pytest.raises(ValueError, match="DRILL"):
        ts.run_one(topo, te.SimConfig(scheme="drill"), trace, device="cpu", loss=loss)
    cfg = te.SimConfig(scheme="ecmp", duration_s=1e-3)
    alone, _ = ts.run_one(topo, cfg, trace, device="cpu", loss=loss)
    both, _ = ts.run_one(topo, cfg, trace, device="cpu", loss=loss, capacity=topo.capacity)
    np.testing.assert_array_equal(alone.finish, both.finish)
    with pytest.raises(ValueError, match="n_links"):
        ts.run_one(topo, cfg, trace, device="cpu", capacity=np.ones(5, np.float32))
