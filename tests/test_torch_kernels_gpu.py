"""Tests of the port that need the card: each CUDA kernel against its plain
version, and the engines on the card against the engines on the CPU.  They
import neither JAX nor the JAX package, so they run on a GPU machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Elsewhere they skip.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cascade_tiered as ct, flash_attention as fa  # noqa: E402
from repro_torch.kernels import linkload as ll, ops  # noqa: E402
from repro_torch.netsim import compact, dataplane, engine, topology, workloads  # noqa: E402

# tests/test_netsim_compact.py:182-185: arrival, queue, mark, thr
TOLS = [dict(rtol=2e-5, atol=1e-3), dict(rtol=1e-4, atol=1.0), dict(atol=1e-6),
        dict(rtol=2e-5, atol=1e-2)]
KW = dict(kmin=400e3, kmax=1600e3, pmax=0.2, dt=10e-6, qmax_bytes=8e6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_sub,hf,L", [(100, 4, 2, 50), (1000, 4, 4, 2080)])
def test_cascade_kernel_matches_plain_on_the_card(cuda, n, n_sub, hf, L):
    """The CUDA kernel against its plain version on the same CUDA inputs
    (its fixed-point sums against the plain float ones: the tolerances
    above); each call counts one launch."""
    rng = np.random.default_rng(n)
    B = 2

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    fab = t(rng.integers(-1, L, (B, n, n_sub, hf)), torch.int32)
    tx = t(rng.integers(0, L, (B, n)), torch.int32)
    rx = t(rng.integers(0, L, (B, n)), torch.int32)
    rates = t(rng.random((B, n, n_sub)) * 1e9, torch.float32)
    queue = t(rng.random((B, L + 1)) * 2e6, torch.float32)
    cap = torch.full((L + 1,), 4e9, device=cuda)
    cap[L] = 1e30
    qmask = torch.ones(L + 1, device=cuda)
    qmask[:2] = 0.0
    qmask[L] = 0.0
    before = ct.cascade_tiered.launches
    got = ct.cascade_tiered(fab, tx, rx, rates, queue, cap, qmask, **KW)
    assert ct.cascade_tiered.launches == before + 1
    want = ct.cascade_tiered_torch(fab, tx, rx, rates, queue, cap, qmask, **KW)
    for w, g, tol in zip(want, got, TOLS):
        np.testing.assert_allclose(w.cpu().numpy(), g.cpu().numpy(), **tol)
    assert float(got[0][:, L].abs().max()) == 0.0 and float(got[2][:, L].abs().max()) == 0.0


@pytest.mark.gpu
def test_plain_backend_refuses_cuda_tensors(cuda):
    topo = topology.leaf_spine(2, 4, 4, 100e9, device=cuda)
    fab = torch.zeros((1, 8, 1, 2), dtype=torch.int32, device=cuda)
    tx = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    before = ct.cascade_tiered.launches
    with pytest.raises(ValueError, match="torch"):
        dataplane.cascade_nic(fab, tx, tx, torch.ones((1, 8, 1), device=cuda),
                              torch.zeros((1, topo.n_links + 1), device=cuda),
                              topo.capacity, dataplane.queue_mask_for(topo),
                              n_links=topo.n_links, backend="torch", **KW)
    assert ct.cascade_tiered.launches == before
    before = ll.linkload_cascade.launches
    with pytest.raises(ValueError, match="torch"):
        dataplane.cascade(fab[..., 0, :], torch.ones((1, 8), device=cuda),
                          torch.zeros((1, topo.n_links + 1), device=cuda),
                          topo.capacity, dataplane.queue_mask_for(topo),
                          n_links=topo.n_links, backend="torch", **KW)
    assert ll.linkload_cascade.launches == before


def _close(want, got, tols):
    for w, g, tol in zip(want, got, tols):
        np.testing.assert_allclose(w.cpu().numpy(), g.cpu().numpy(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,H,L", [(1, 100, 2, 5), (2, 1000, 4, 50), (3, 4097, 6, 2080)])
def test_flat_cascade_kernel_matches_plain_on_the_card(cuda, B, n, H, L):
    """csrc/cascade_flat.cu against its plain version, with -1 hops and a
    ragged n (not a multiple of the block)."""
    rng = np.random.default_rng(n)
    lid = torch.as_tensor(rng.integers(-1, L, (B, n, H)), dtype=torch.int32, device=cuda)
    rates = torch.as_tensor(rng.random((B, n)) * 1e9, dtype=torch.float32, device=cuda)
    queue = torch.as_tensor(rng.random((B, L + 1)) * 2e6, dtype=torch.float32, device=cuda)
    cap = torch.full((L + 1,), 4e9, device=cuda)
    cap[L] = 1e30
    qmask = torch.ones(L + 1, device=cuda)
    qmask[:2] = 0.0
    qmask[L] = 0.0
    before = ll.linkload_cascade.launches
    got = ll.linkload_cascade(lid, rates, queue, cap, qmask, **KW)
    assert ll.linkload_cascade.launches == before + 1
    _close(ll.linkload_cascade_torch(lid, rates, queue, cap, qmask, **KW), got, TOLS)
    assert float(got[0][:, L].abs().max()) == 0.0 and float(got[2][:, L].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("n,hops,L", [(100, 2, 50), (8192, 6, 512), (513, 4, 300)])
def test_linkload_kernel_matches_plain_on_the_card(cuda, n, hops, L):
    """csrc/linkload.cu against its plain version; ids of -1 and past L are
    dropped (tests/test_kernels.py tolerances)."""
    rng = np.random.default_rng(n)
    lid = rng.integers(-1, L + 5, (n, hops)).astype(np.int32)
    rates = (rng.random(n) * 1e9).astype(np.float32)
    queue = (rng.random(L) * 2e6).astype(np.float32)
    cap = np.full(L, 4e10, np.float32)
    before = ll.linkload.launches
    got = ops.linkload(lid, rates, queue, cap, n_links=L, device=cuda)
    assert ll.linkload.launches == before + 1
    want = ops.linkload(lid, rates, queue, cap, n_links=L, device="cpu")
    _close(want, got, [dict(rtol=1e-5), dict(rtol=1e-4, atol=1.0), dict(atol=1e-6)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,S,H,K,hd,kw", [
    ("float32", 128, 4, 4, 32, {}),
    ("float32", 200, 4, 2, 64, dict(window=48, softcap=30.0)),
    ("float32", 256, 8, 1, 128, dict(causal=False)),
    ("bfloat16", 256, 4, 2, 64, {}),
    ("bfloat16", 192, 8, 4, 256, dict(window=100, softcap=50.0)),
])
def test_flash_kernel_matches_plain_on_the_card(cuda, dtype, S, H, K, hd, kw):
    """csrc/flash_attention.cu against its plain version (true float32
    products) in the working type: fp32 2e-5 (3e-5 with a softcap), bf16
    2e-2, the tolerances of tests/test_kernels.py."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((2, S, h, hd), generator=g, device=cuda).to(dt)
               for h in (H, K, K))
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = fa.flash_attention_torch(q, k, v, **kw)
    tol = 2e-2 if dtype == "bfloat16" else (3e-5 if kw.get("softcap") else 2e-5)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


def _row_rel_err(got, want):
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,limit", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_flash_kernel_peaked_scores_on_the_card(cuda, dtype, limit):
    """Scores of standard deviation 10 (q scaled), so the softmax is peaked
    and the softcap matters: every output row within ``limit`` of the plain
    version relative to its norm, a limit that the plain version with the
    window one 64-key block short, or without the softcap, breaks."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(5)
    S, H, K, hd = 512, 4, 2, 128
    q, k, v = (torch.randn((1, S, h, hd), generator=g, device=cuda) for h in (H, K, K))
    q, k, v = (q * 10.0).to(dt), k.to(dt), v.to(dt)
    kw = dict(causal=True, window=256, softcap=50.0)
    want = fa.flash_attention_torch(q, k, v, **kw)
    assert _row_rel_err(ops.flash_attention(q, k, v, **kw), want) <= limit
    for fault in (dict(kw, window=192), dict(kw, softcap=0.0)):
        assert _row_rel_err(fa.flash_attention_torch(q, k, v, **fault), want) > limit


def _route_delta(before):
    now = fa.flash_attention.route_launches
    return {k: now[k] - before.get(k, 0) for k in now if now[k] != before.get(k, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,K,hd,kw", [
    (200, 8, 8, 64, dict(causal=False)),
    (333, 8, 1, 64, {}),
    (200, 8, 1, 128, dict(window=77)),
    (333, 4, 4, 128, dict(causal=False, softcap=50.0)),
    (333, 8, 1, 256, dict(window=100, softcap=50.0)),
    (200, 2, 2, 256, dict(causal=False, window=150)),
    (512, 16, 2, 128, dict(window=300, softcap=50.0)),
])
def test_flash_wgmma_route_matches_plain_on_the_card(cuda, S, H, K, hd, kw):
    """csrc/flash_attention_sm90.cu (bf16 at the model widths) against its
    plain version: S not a multiple of 64 or 128, causal and not, windows
    that end inside a key tile, softcap 50, G = H / K of 1 and 8.  2e-2
    elementwise at unit scores, and every output row within 1e-2 at peaked
    scores (q scaled by 10), the limits of the tests above."""
    assert fa.flash_route(torch.bfloat16, hd) == "wgmma"
    g = torch.Generator(device=cuda).manual_seed(S + hd)
    q, k, v = (torch.randn((2, S, h, hd), generator=g, device=cuda) for h in (H, K, K))
    for q_scale, check in ((1.0, "elementwise"), (10.0, "rows")):
        qq, kk, vv = (q * q_scale).bfloat16(), k.bfloat16(), v.bfloat16()
        before = dict(fa.flash_attention.route_launches)
        got = ops.flash_attention(qq, kk, vv, **kw)
        assert _route_delta(before) == {"wgmma": 1}
        assert got.dtype == torch.bfloat16 and got.shape == qq.shape
        want = fa.flash_attention_torch(qq, kk, vv, **kw)
        if check == "elementwise":
            np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                       atol=2e-2, rtol=2e-2)
        else:
            assert _row_rel_err(got, want) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd", [("float32", 64), ("float32", 256), ("bfloat16", 32)])
def test_flash_simt_route_on_the_card(cuda, dtype, hd):
    """float32 at any head dim, and bf16 below 64, stay on
    csrc/flash_attention.cu."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn((1, 130, h, hd), generator=g, device=cuda).to(dt) for h in (4, 2, 2))
    before = dict(fa.flash_attention.route_launches)
    got = ops.flash_attention(q, k, v, window=40)
    assert _route_delta(before) == {"simt": 1}
    want = fa.flash_attention_torch(q, k, v, window=40)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,W,N,L,C", [
    (2, 5, 4, 50, 1),         # C = 1
    (2, 101, 4, 50, 4),       # an intermediate C, W not a multiple of it
    (1, 3001, 4, 50, 16),     # the largest C, W not a multiple of it
    (3, 3, 200, 50, 8),       # W < C: some CTAs own no flow
    (2, 2049, 4, 2080, 4),    # three_tier's link count
])
def test_tiered_cluster_sizes_on_the_card(cuda, B, W, N, L, C):
    """The tiered kernel over clusters of 1 to 16 CTAs against its plain
    version, with absent hops; the wrapper launches the cluster size that
    cluster_size gives and counts it."""
    assert ct.cluster_size(W, N, L + 1) == C
    rng = np.random.default_rng(W)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    fab = t(rng.integers(-1, L, (B, W, N, 2)), torch.int32)
    tx = t(rng.integers(0, L, (B, W)), torch.int32)
    rx = t(rng.integers(0, L, (B, W)), torch.int32)
    rates = t(rng.random((B, W, N)) * 1e9, torch.float32)
    queue = t(rng.random((B, L + 1)) * 2e6, torch.float32)
    cap = torch.full((L + 1,), 4e9, device=cuda)
    cap[L] = 1e30
    qmask = torch.ones(L + 1, device=cuda)
    qmask[L] = 0.0
    before = dict(ct.cascade_tiered.cluster_launches)
    got = ct.cascade_tiered(fab, tx, rx, rates, queue, cap, qmask, **KW)
    assert _tally_delta(ct.cascade_tiered.cluster_launches, before) == {C: 1}
    _close(ct.cascade_tiered_torch(fab, tx, rx, rates, queue, cap, qmask, **KW), got, TOLS)
    assert float(got[0][:, L].abs().max()) == 0.0 and float(got[2][:, L].abs().max()) == 0.0


def _tally_delta(tally, before):
    return {k: tally[k] - before.get(k, 0) for k in tally if tally[k] != before.get(k, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("B,n,H,L,C", [
    (2, 20, 4, 50, 1),        # C = 1
    (2, 203, 4, 50, 4),       # an intermediate C, n not a multiple of it
    (1, 5001, 4, 50, 16),     # the largest C, n not a multiple of it
    (2, 3, 4, 0, 4),          # n < C: a CTA owns no sub-flow (every hop absent)
    (2, 8193, 6, 2080, 4),    # three_tier's link count
])
def test_flat_cluster_sizes_on_the_card(cuda, B, n, H, L, C):
    """The flat kernel over clusters of 1 to 16 CTAs against its plain
    version, with absent hops; the wrapper launches the cluster size that
    cluster_size gives and counts it."""
    assert ct.cluster_size(n, 1, L + 1) == C
    rng = np.random.default_rng(n)
    lid = torch.as_tensor(rng.integers(-1, L, (B, n, H)), dtype=torch.int32, device=cuda)
    rates = torch.as_tensor(rng.random((B, n)) * 1e9, dtype=torch.float32, device=cuda)
    queue = torch.as_tensor(rng.random((B, L + 1)) * 2e6, dtype=torch.float32, device=cuda)
    cap = torch.full((L + 1,), 4e9, device=cuda)
    cap[L] = 1e30
    qmask = torch.ones(L + 1, device=cuda)
    qmask[L] = 0.0
    before = dict(ll.linkload_cascade.cluster_launches)
    got = ll.linkload_cascade(lid, rates, queue, cap, qmask, **KW)
    assert _tally_delta(ll.linkload_cascade.cluster_launches, before) == {C: 1}
    _close(ll.linkload_cascade_torch(lid, rates, queue, cap, qmask, **KW), got, TOLS)
    assert float(got[0][:, L].abs().max()) == 0.0 and float(got[2][:, L].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("n,hops,L,C", [
    (10, 2, 50, 1),           # C = 1
    (51, 4, 50, 4),           # an intermediate C, n not a multiple of it
    (8193, 6, 512, 16),       # the largest C, n not a multiple of it
    (3, 200, 50, 8),          # n < C: CTAs that own no row
    (8191, 4, 2080, 8),       # three_tier's link count
])
def test_linkload_cluster_sizes_on_the_card(cuda, n, hops, L, C):
    """The linkload kernel over clusters of 1 to 16 CTAs against its plain
    version, with ids of -1 and past L (dropped); the wrapper launches the
    cluster size that cluster_size gives and counts it."""
    assert ct.cluster_size(n, hops, L) == C
    rng = np.random.default_rng(n + hops)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    lid = t(rng.integers(-1, L + 5, (n, hops)), torch.int32)
    rates = t(rng.random(n) * 1e9, torch.float32)
    queue = t(rng.random(L) * 2e6, torch.float32)
    cap = torch.full((L,), 4e10, device=cuda)
    kw = dict(kmin=400e3, kmax=1600e3, pmax=0.2, dt=10e-6)
    before = dict(ll.linkload.cluster_launches)
    got = ll.linkload(lid, rates, queue, cap, **kw)
    assert _tally_delta(ll.linkload.cluster_launches, before) == {C: 1}
    _close(ll.linkload_torch(lid, rates, queue, cap, **kw), got,
           [dict(rtol=1e-5), dict(rtol=1e-4, atol=1.0), dict(atol=1e-6)])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["leaf_spine", "three_tier"])
def test_tiered_kernel_matches_flat_kernel_on_the_card(cuda, kind):
    """The two cascade kernels on the same routes in both layouts."""
    topo = (topology.leaf_spine(2, 4, 4, 100e9, device=cuda) if kind == "leaf_spine"
            else topology.three_tier(device=cuda))
    rng = np.random.default_rng(7)
    n, N = 3000, 4
    src = torch.as_tensor(rng.integers(0, topo.n_hosts, n), device=cuda)
    dst = torch.as_tensor(rng.integers(0, topo.n_hosts, n), device=cuda)
    path = torch.as_tensor(rng.integers(0, topo.n_paths, (n, N)), device=cuda)
    hpl = topo.hosts_per_leaf
    links = topo.subflow_links(src[:, None], dst[:, None], path)
    tx, rx = topo.nic_links(src, dst)
    fab = topo.fabric_links((src // hpl)[:, None], (dst // hpl)[:, None], path)
    rates = torch.as_tensor(rng.random((1, n, N)) * 50e9, dtype=torch.float32, device=cuda)
    queue = torch.as_tensor(rng.random((1, topo.n_links + 1)) * 2e6, dtype=torch.float32,
                            device=cuda)
    args = (queue, topo.capacity, dataplane.queue_mask_for(topo))
    kw = dict(n_links=topo.n_links, backend="cuda", **KW)
    flat = dataplane.cascade(links[None], rates, *args, **kw)
    tiered = dataplane.cascade_nic(fab[None], tx[None], rx[None], rates, *args, **kw)
    _close(flat, tiered, TOLS)


def _trace(topo):
    return workloads.poisson_trace(workloads.TraceConfig(
        workload="alistorage", load=0.8, duration_s=1.5e-3, n_hosts=topo.n_hosts,
        host_bw=100e9, seed=0, hosts_per_leaf=topo.hosts_per_leaf,
        load_base_bw=2 * 4 * 100e9))


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["seqbalance", "ecmp", "letflow", "conga", "drill"])
def test_engine_on_the_card_matches_the_cpu(cuda, scheme):
    """simulate_compact on the card (CUDA kernel, float atomics) against the
    plain path on the CPU: the same finished flows, and at least 99 % of
    finish times on the same dt step."""
    topo = topology.leaf_spine(2, 4, 4, 100e9, device="cpu")
    trace = _trace(topo)
    cfg = engine.SimConfig(scheme=scheme, duration_s=6e-3)
    # a window of every flow: at load 0.8 the default planner's window is
    # too small for SeqBalance (in the JAX package too; see the next test)
    F = len(trace.sizes)
    before = ct.cascade_tiered.launches
    gpu, _ = compact.simulate_compact(topo, cfg, trace, window_slots=F, device=cuda)
    cpu, _ = compact.simulate_compact(topo, cfg, trace, window_slots=F, device="cpu")
    launched = ct.cascade_tiered.launches - before
    assert launched == (0 if scheme == "drill" else gpu.steps)
    assert gpu.spill_steps == 0 and cpu.spill_steps == 0
    np.testing.assert_array_equal(np.isfinite(gpu.finish), np.isfinite(cpu.finish))
    done = np.isfinite(cpu.finish)
    same_step = np.abs(gpu.finish[done] - cpu.finish[done]) <= 1e-6
    assert same_step.mean() >= 0.99


@pytest.mark.gpu
def test_default_window_spills_on_the_card_as_on_the_cpu(cuda):
    """SeqBalance at load 0.8 with the planner's own window spills, as the
    JAX package's planner does on the same trace; the card spills on as
    many steps as the CPU and finishes the same flows."""
    topo = topology.leaf_spine(2, 4, 4, 100e9, device="cpu")
    trace = _trace(topo)
    cfg = engine.SimConfig(scheme="seqbalance", duration_s=6e-3)
    gpu, _ = compact.simulate_compact(topo, cfg, trace, device=cuda)
    cpu, _ = compact.simulate_compact(topo, cfg, trace, device="cpu")
    assert gpu.window_slots == cpu.window_slots
    assert gpu.spill_steps == cpu.spill_steps > 0
    np.testing.assert_array_equal(np.isfinite(gpu.finish), np.isfinite(cpu.finish))


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["seqbalance", "ecmp", "drill"])
def test_dense_engine_on_the_card_matches_the_cpu(cuda, scheme):
    """engine.simulate on the card (the tiered CUDA kernel every step but
    for DRILL) against the CPU: the same finished flows, and at least 99 %
    of finish times on the same dt step."""
    topo = topology.leaf_spine(2, 4, 4, 100e9, device="cpu")
    trace = _trace(topo)
    cfg = engine.SimConfig(scheme=scheme, duration_s=6e-3)
    before = ct.cascade_tiered.launches
    gpu, outs = engine.simulate(topo, cfg, trace, device=cuda)
    assert ct.cascade_tiered.launches - before == (0 if scheme == "drill" else 600)
    cpu, _ = engine.simulate(topo, cfg, trace, device="cpu")
    assert outs.goodput_total.shape == (600,) and outs.goodput_total.is_cuda
    gf, cf = gpu.finish.cpu().numpy(), cpu.finish.numpy()
    np.testing.assert_array_equal(np.isfinite(gf), np.isfinite(cf))
    done = np.isfinite(cf)
    assert done.sum() > 500
    assert (np.abs(gf[done] - cf[done]) <= 1e-6).mean() >= 0.99


@pytest.mark.gpu
def test_adaptive_collective_on_the_card_matches_the_cpu(cuda):
    """bench_adaptive_dt's collective on leaf_spine(4, 4, 4) with adaptive
    dt, on the card against the CPU: it fast-forwards the compute gaps
    (ff_steps may sit one macro-step apart where a float compare at the
    quiescence check's edge lands the other way), finishes the same flows
    within one dt, and launches the tiered kernel once a stepped step and
    once a steady-state check."""
    from repro_torch.dist import collectives, cosim
    from repro_torch.netsim import sweep

    topo = topology.leaf_spine(4, 4, 4, 100e9, device="cpu")
    plan = collectives.PathPlan(n_chunks=4, directions=(1, -1, 1, -1))
    trace = workloads.collective_trace(plan, cosim.ring_hosts(topo, 8), 4e6, link_bw=100e9,
                                       round_gap_s=800e-6, seed=0, steer_paths=topo.n_paths)
    cfg = engine.SimConfig(scheme="seqbalance", duration_s=14e-3, uplink_sample_every=10,
                           adaptive=True)
    before, loop0 = ct.cascade_tiered.launches, dict(compact.run_core.counts)
    gpu, outs = sweep.run_one(topo, cfg, trace, device=cuda)
    loop = {k: compact.run_core.counts[k] - loop0[k] for k in loop0}
    assert ct.cascade_tiered.launches - before == loop["scanned_steps"] + loop["steady_checks"]
    cpu, _ = sweep.run_one(topo, cfg, trace, device="cpu")
    K = compact.plan_chunks(cfg, 1400)[0]
    assert gpu.ff_steps > 0 and abs(gpu.ff_steps - cpu.ff_steps) <= K
    np.testing.assert_array_equal(np.isfinite(gpu.finish), np.isfinite(cpu.finish))
    done = np.isfinite(cpu.finish)
    assert done.all() and np.all(np.abs(gpu.finish[done] - cpu.finish[done]) <= 10e-6 + 1e-9)
    assert np.isfinite(outs.max_queue).all() and outs.uplink_load.shape == (140, 4, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,flowcells,reorder", [("ecmp", 4, 2.0),
                                                      ("flowlet_timeout", 1, None)])
def test_flowcells_and_the_recorder_on_the_card_match_the_cpu(cuda, scheme, flowcells,
                                                               reorder):
    """bench_flowcell's ring (4 MB) on its hetero fabric, recorded: a
    flowcell trace under the reorder cost, and the WCMP flowlet scheme.  On
    the card against the CPU: the same finished flows, 99 % of them within
    one dt, the same chunks in the ring, and one tiered launch a step."""
    from repro_torch import obs
    from repro_torch.dist import collectives, cosim
    from repro_torch.netsim import sweep

    topo = topology.hetero_leaf_spine(4, 4, 4, 25e9, 100e9, n_fast_spines=1, host_bw=100e9,
                                      device="cpu")
    plan = collectives.PathPlan(n_chunks=4, directions=(1, -1, 1, -1), flowcells=flowcells)
    trace = workloads.collective_trace(plan, cosim.ring_hosts(topo, 8), 4e6, link_bw=25e9,
                                       round_gap_s=3e-4, seed=0, steer_paths=topo.n_paths)
    cfg = engine.SimConfig(scheme=scheme, duration_s=4e-3, uplink_sample_every=10)
    spec = obs.RecordSpec(ring_chunks=16)
    before, loop0 = ct.cascade_tiered.launches, dict(compact.run_core.counts)
    gpu, _ = sweep.run_one(topo, cfg, trace, reorder=reorder, record=spec, device=cuda)
    loop = {k: compact.run_core.counts[k] - loop0[k] for k in loop0}
    assert ct.cascade_tiered.launches - before == loop["scanned_steps"]
    cpu, _ = sweep.run_one(topo, cfg, trace, reorder=reorder, record=spec, device="cpu")
    np.testing.assert_array_equal(np.isfinite(gpu.finish), np.isfinite(cpu.finish))
    done = np.isfinite(cpu.finish)
    assert done.any() and (np.abs(gpu.finish[done] - cpu.finish[done]) <= 10e-6 + 1e-9).mean() >= 0.99
    g, c = obs.drain(spec, gpu.ring), obs.drain(spec, cpu.ring)
    assert g["chunks_recorded"] == c["chunks_recorded"] > 0
    np.testing.assert_array_equal(g["meta"][:, :3], c["meta"][:, :3])  # step0, steps, ff


def _tiered_inputs(cuda, B, W, N, hf, L, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=cuda).contiguous()

    cap = torch.full((L + 1,), 100e9, device=cuda)
    cap[L] = 1e30
    return (t(rng.integers(-1, L, (B, W, N, hf)), torch.int32),
            t(rng.integers(0, L, (B, W)), torch.int32), t(rng.integers(0, L, (B, W)), torch.int32),
            t(rng.random((B, W, N)) * 50e9, torch.float32),
            t(rng.random((B, L + 1)) * 2e6, torch.float32), cap, torch.ones(L + 1, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("B,W,N,hf,L", [(2, 5376, 4, 2, 448), (1, 56116, 4, 2, 448),
                                        (3, 1000, 4, 4, 2080)])
def test_cascade_kernels_repeat_bit_for_bit(cuda, B, W, N, hf, L):
    """The tiered and flat kernels sum their link loads in fixed point, so
    two launches on the same inputs give bitwise-equal outputs (float
    atomics would add in another order each time)."""
    args = _tiered_inputs(cuda, B, W, N, hf, L)
    first, second = (ct.cascade_tiered(*args, **KW) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    fab, tx, rx, rates, queue, cap, qmask = args
    lid = torch.cat([tx[:, :, None, None].expand(B, W, N, 1), fab,
                     rx[:, :, None, None].expand(B, W, N, 1)], -1).reshape(B, W * N, hf + 2)
    flat = [ll.linkload_cascade(lid.contiguous(), rates.reshape(B, -1).contiguous(), queue,
                                cap, qmask, **KW) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*flat))
    # linkload on the first simulation's routes, as many rows as its
    # fixed-point bound takes (its sums in fixed point too)
    rows = min(W * N, 2**16)
    one = [ops.linkload(lid[0, :rows].contiguous(), rates[0].reshape(-1)[:rows].contiguous(),
                        queue[0, :L].contiguous(), cap[:L].contiguous(), n_links=L,
                        **{k: KW[k] for k in ("kmin", "kmax", "pmax", "dt")})
           for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*one))


@pytest.mark.gpu
def test_fixed_point_overflow_check_raises_past_its_bound(cuda):
    """400,000 sub-flows at up to 400 Gb/s could overflow the int64 link
    loads: both cascades raise before they launch; SeqBalance's intensity
    raises past its own bound."""
    args = _tiered_inputs(cuda, 1, 100000, 4, 2, 64)
    before = (ct.cascade_tiered.launches, ll.linkload_cascade.launches)
    with pytest.raises(ValueError, match="overflow"):
        ct.cascade_tiered(*args, **KW)
    lid = torch.zeros((1, 400000, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="overflow"):
        ll.linkload_cascade(lid, args[3].reshape(1, -1), args[4], args[5], args[6], **KW)
    assert (ct.cascade_tiered.launches, ll.linkload_cascade.launches) == before
    before = ll.linkload.launches
    with pytest.raises(ValueError, match="overflow"):
        ll.linkload(torch.zeros((100000, 4), dtype=torch.int32, device=cuda),
                    torch.ones(100000, device=cuda), torch.zeros(64, device=cuda),
                    torch.ones(64, device=cuda), kmin=400e3, kmax=1600e3, pmax=0.2, dt=1e-5)
    assert ll.linkload.launches == before
    marked = torch.ones(1000, device=cuda)
    cell = torch.zeros(1000, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="overflow"):
        dataplane.congestion_intensity(cell, marked, 4, max_pkts=1e7)
    got = [dataplane.congestion_intensity(cell, marked, 4, max_pkts=1.0) for _ in range(2)]
    assert torch.equal(*got) and float(got[0][0]) == 1000.0


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["seqbalance", "drill"])
def test_engine_repeats_bit_for_bit_on_the_card(cuda, scheme):
    """Two runs of one program on the card give the same finish times and
    per-step outputs, bit for bit (the cascade's sums, SeqBalance's
    intensity and DRILL's NIC loads do not depend on the order of their
    additions)."""
    topo = topology.leaf_spine(2, 4, 4, 100e9, device=cuda)
    trace = workloads.poisson_trace(workloads.TraceConfig(
        workload="alistorage", load=0.8, duration_s=1.5e-3, n_hosts=8, host_bw=100e9,
        hosts_per_leaf=4, seed=0))
    cfg = engine.SimConfig(scheme=scheme, duration_s=6e-3)
    runs = [compact.simulate_compact(topo, cfg, trace, window_slots=len(trace.sizes),
                                     device=cuda) for _ in range(2)]
    (r1, o1), (r2, o2) = runs
    np.testing.assert_array_equal(r1.finish, r2.finish)
    assert all(np.array_equal(a, b) for a, b in zip(o1, o2))


@pytest.mark.gpu
def test_cosim_on_the_card_matches_the_cpu(cuda):
    """The epoch driver on the card: tests/test_torch_cosim.py's killed-spine
    scenario gives the CPU's quarantined sets, reports and plans, and
    p99 within one dt in every epoch; a second run on the card repeats it
    bit for bit."""
    from repro_torch.dist import cosim

    def run(device):
        topo = topology.leaf_spine(4, 4, 4, 100e9, device=device)
        return cosim.run_cosim(topo, cosim.ring_hosts(topo, 8), 4e6, scheme="seqbalance",
                               epochs=4, phi_steps=2, n_chunks=4, seed=0, device=device,
                               faults=(cosim.kill_spine(topo, 2, epoch=1, recover_epoch=3),))
    cpu, card, again = run("cpu"), run(cuda), run(cuda)
    for c, g, a in zip(cpu.records, card.records, again.records):
        assert (g.quarantined, g.reported_slow, g.plan_version) == \
            (c.quarantined, c.reported_slow, c.plan_version)
        assert abs(g.fct_p99_s - c.fct_p99_s) <= 10e-6 + 1e-9
        np.testing.assert_array_equal(g.fct, a.fct)
    assert card.convergence_epoch(1) == cpu.convergence_epoch(1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,route", [("float32", "simt"), ("bfloat16", "wgmma")])
def test_reduced_gemma2_served_on_the_card(cuda, dtype, route):
    """gemma2-2b's program (local/global alternation, window, both
    softcaps) at hd 64, 4 layers, ragged prompts past the window (the local
    caches take the ring roll): ServeEngine on the card runs every
    attention layer's prefill through the kernel of ``route``; with the
    plain attention on the same weights the teacher-forced logits agree
    within SERVE_TOL of the row's RMS and the greedy tokens are equal up to
    the first near-tie (repro_torch.serve.compare); a second run repeats bit
    for bit."""
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.serve import compare, engine

    cfg = registry.get_config("gemma2-2b", reduced=True).replace(
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, vocab=1000,
        local_window=32, dtype=dtype)
    params = model.init_params(cfg, seed=3, device=cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, cfg.vocab, n).astype(np.int32) for n in (70, 90, 81)]
    max_len, steps = 110, 12
    runs = []
    for _ in range(2):
        before = dict(fa.flash_attention.route_launches)
        eng = engine.ServeEngine(cfg, params, batch_size=3, max_len=max_len, device=cuda)
        eng.admit([engine.Request(i, p, steps) for i, p in enumerate(prompts)])
        runs.append([r.out_tokens for r in eng.run()])
        assert _route_delta(before) == {route: cfg.n_layers}
    assert runs[0] == runs[1]
    before = dict(fa.flash_attention.route_launches)
    ref_tokens, ref_logits = compare.serve_steps(params, cfg, prompts, max_len, steps,
                                                 plain=True)
    assert _route_delta(before) == {}
    _, got = compare.serve_steps(params, cfg, prompts, max_len, steps, forced=ref_tokens)
    _, again = compare.serve_steps(params, cfg, prompts, max_len, steps, forced=ref_tokens)
    assert torch.equal(got, again)
    tol = compare.SERVE_TOL[dtype]
    err, rms = compare.logit_agreement(got, ref_logits, ref_tokens, top=None)
    assert err <= tol
    upto = compare.tokens_before_near_tie(compare.margins(ref_logits), rms, tol)
    for i, (toks, n) in enumerate(zip(runs[0], upto)):
        assert toks[:n] == ref_tokens[:n, i].tolist()



@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "recurrentgemma-9b"])
def test_reduced_families_served_on_the_card(cuda, arch):
    """A REDUCED moe and hybrid config (float32, weights from numpy_params)
    served on the card against the CPU: ServeEngine runs every
    self-attention layer's prefill through the kernel, the card's
    teacher-forced logits lie within SERVE_TOL of the CPU's row RMS and its
    greedy tokens equal the CPU's up to the first near-tie; a second run
    repeats bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer, weights
    from repro_torch.serve import compare, engine

    cfg = registry.get_config(arch, reduced=True).replace(dtype="float32")
    tree = weights.numpy_params(cfg, 5)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, cfg.vocab, n).astype(np.int32) for n in (30, 45, 37)]
    max_len, steps = 60, 10
    ref_tokens, ref_logits = compare.serve_steps(
        weights.from_jax_params(tree, cfg, device="cpu"), cfg, prompts, max_len, steps)
    params = weights.from_jax_params(tree, cfg, device=cuda)
    prelude, sb, n_super, trailing = transformer.block_program(cfg)
    n_attn = (n_super * sum(u.kind == "attn" for u in sb)
              + sum(u.kind == "attn" for u in prelude + trailing))
    runs = []
    for _ in range(2):
        before = dict(fa.flash_attention.route_launches)
        eng = engine.ServeEngine(cfg, params, batch_size=3, max_len=max_len, device=cuda)
        eng.admit([engine.Request(i, p, steps) for i, p in enumerate(prompts)])
        runs.append([r.out_tokens for r in eng.run()])
        assert _route_delta(before) == {"simt": n_attn}
    assert runs[0] == runs[1]
    _, got = compare.serve_steps(params, cfg, prompts, max_len, steps, forced=ref_tokens)
    tol = compare.SERVE_TOL["float32"]
    err, rms = compare.logit_agreement(got.cpu(), ref_logits, ref_tokens, top=None)
    assert err <= tol
    upto = compare.tokens_before_near_tie(compare.margins(ref_logits), rms, tol)
    for i, (toks, n) in enumerate(zip(runs[0], upto)):
        assert toks[:n] == ref_tokens[:n, i].tolist()


@pytest.mark.gpu
def test_moe_apply_repeats_bit_for_bit_on_the_card(cuda):
    """moe.apply on the card, twice on the same inputs, bit-identical (the
    combine gathers each token's slots and adds them in expert order; no
    atomics), with replicas dropped; and its routing the CPU's."""
    from repro_torch.configs import registry
    from repro_torch.models import moe, transformer, weights

    cfg = registry.get_config("deepseek-moe-16b", reduced=True).replace(
        d_model=256, dtype="bfloat16")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))  # drops
    fields = {k: v[0] for k, v in weights.numpy_params(cfg, 7)["main"][1].items()}
    u = transformer.Unit("moe")
    p_cpu = transformer.unit_params(cfg, u, fields, torch.bfloat16)
    p = transformer.unit_params(cfg, u, fields, torch.bfloat16, cuda)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((4, 512, 256),
                                                                 dtype=np.float32))
    x = x.to(torch.bfloat16)
    first, _ = moe.apply(p, x.to(cuda), cfg)
    second, _ = moe.apply(p, x.to(cuda), cfg)
    assert torch.equal(first, second)
    r, r_cpu = moe.routing(p, x.to(cuda), cfg), moe.routing(p_cpu, x, cfg)
    assert int(r.dropped) > 0
    assert torch.equal(r.gate_idx.cpu(), r_cpu.gate_idx) and torch.equal(r.slot.cpu(), r_cpu.slot)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ("float32", "bfloat16", "int8"))
def test_local_ring_on_the_card_equals_the_cpu_bit_for_bit(cuda, wire):
    """dist.collectives' ring over a LocalAxis on the card against the same
    ring on the CPU, rings of 2, 4 and 8 members, each plan of chip_smoke's
    phase 19: the same float32 sums, roundings and roll, bit for bit."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke
    from repro_torch.dist import collectives as coll

    for n in (2, 4, 8):
        for plan in ("default", "inactive", "pinned"):
            x = torch.from_numpy(chip_smoke.ring_inputs(n, 1001, n))
            p = chip_smoke.ring_plan(coll, plan, wire)
            coll.permute_rounds = 0
            got = coll.seqbalance_all_reduce(x.to(cuda), coll.LocalAxis(n, cuda), p).cpu()
            assert coll.permute_rounds == 2 * (n - 1) * p.n_chunks
            want = coll.seqbalance_all_reduce(x, coll.LocalAxis(n, "cpu"), p)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (n, plan)
