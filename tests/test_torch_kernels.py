"""The plain PyTorch versions of the port's kernels against the JAX
package's oracles, on the same numpy inputs.

The JAX package's Pallas kernels that use ``pl.load`` do not run in
interpret mode on the installed JAX, so the cascades and flash attention
are held against ``repro.kernels.ref`` and ``dataplane`` ``backend="xla"``;
the ``pl.load``-free ``linkload`` kernel runs in interpret mode too.
Tolerances: the linkload and flash attention ones of tests/test_kernels.py
(load rtol 1e-5, queue rtol 1e-4 / atol 1, mark atol 1e-6; flash fp32
2e-5, softcap 3e-5, bf16 2e-2), the cascade ones of
tests/test_netsim_compact.py:182-185 (segment sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import linkload as jll, ref as jref  # noqa: E402
from repro.netsim import dataplane as jd, topology as jt  # noqa: E402
from repro_torch.kernels import flash_attention as tfa, linkload as tll  # noqa: E402
from repro_torch.kernels import ops, ref as tref  # noqa: E402
from repro_torch.netsim import dataplane as td, topology as tt  # noqa: E402

CASCADE_TOLS = [dict(rtol=2e-5, atol=1e-3), dict(rtol=1e-4, atol=1.0), dict(atol=1e-6),
                dict(rtol=2e-5, atol=1e-2)]
LINKLOAD_TOLS = [dict(rtol=1e-5), dict(rtol=1e-4, atol=1.0), dict(atol=1e-6)]
RED = (400e3, 1600e3, 0.2)


def _close(want, got, tols):
    assert len(want) == len(got)
    for w, g, tol in zip(want, got, tols):
        np.testing.assert_allclose(np.asarray(w), np.asarray(g), **tol)


# ------------------------------------------------------------- linkload
@pytest.mark.parametrize("n,hops,L", [(100, 2, 50), (1000, 6, 200), (513, 4, 300)])
def test_linkload_plain_matches_reference(n, hops, L):
    """The shapes of tests/test_kernels.py::test_linkload_sweep, with ids up
    to L + 4: ids at or past L are dropped, as -1 is."""
    rng = np.random.default_rng(n)
    lid = rng.integers(-1, L + 5, (n, hops)).astype(np.int32)
    rates = (rng.random(n) * 1e9).astype(np.float32)
    queue = (rng.random(L) * 2e6).astype(np.float32)
    cap = np.full(L, 4e10, np.float32)
    j = jnp.asarray
    want = jref.linkload_ref(j(lid), j(rates), L, *RED, j(queue), j(cap), 10e-6)
    interp = jll.linkload(j(lid), j(rates), j(queue), j(cap), n_links=L, interpret=True)
    got = tref.linkload_ref(torch.as_tensor(lid), torch.as_tensor(rates), L, *RED,
                            torch.as_tensor(queue), torch.as_tensor(cap), 10e-6)
    _close(want, got, LINKLOAD_TOLS)
    _close(interp, got, LINKLOAD_TOLS)
    # the entry point with numpy arguments on the CPU, and the wrapper
    entry = ops.linkload(lid, rates, queue, cap, n_links=L, device="cpu")
    wrapped = tll.linkload(torch.as_tensor(lid), torch.as_tensor(rates),
                           torch.as_tensor(queue), torch.as_tensor(cap),
                           kmin=RED[0], kmax=RED[1], pmax=RED[2], dt=10e-6)
    for a, b, c in zip(got, entry, wrapped):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), c.numpy())


def test_linkload_drops_absent_hops():
    """tests/test_kernels.py::test_linkload_drop_sentinel: -1 hops add
    nothing anywhere."""
    load, _, _ = ops.linkload(np.array([[0, -1], [1, -1]], np.int32),
                              np.array([5.0, 7.0], np.float32), np.zeros(3, np.float32),
                              np.full(3, 1e12, np.float32), n_links=3, device="cpu")
    np.testing.assert_allclose(load.numpy(), [5.0, 7.0, 0.0], atol=1e-6)


# --------------------------------------------------------- flat cascade
@pytest.mark.parametrize("n,hops,L", [(100, 6, 50), (513, 4, 30), (64, 2, 5)])
def test_flat_cascade_plain_matches_reference(n, hops, L):
    """The shapes of tests/test_netsim_compact.py::
    test_linkload_cascade_kernel_vs_ref."""
    rng = np.random.default_rng(n)
    lid = rng.integers(-1, L, (n, hops)).astype(np.int32)
    rates = (rng.random(n) * 1e9).astype(np.float32)
    queue = (rng.random(L) * 2e6).astype(np.float32)
    cap = np.full(L, 4e9, np.float32)
    qmask = np.ones(L, np.float32)
    qmask[:2] = 0.0
    j = jnp.asarray
    want = jref.linkload_cascade_ref(j(lid), j(rates), L, *RED, j(queue), j(cap),
                                     j(qmask), 10e-6)
    got = tref.linkload_cascade_ref(torch.as_tensor(lid), torch.as_tensor(rates), L, *RED,
                                    torch.as_tensor(queue), torch.as_tensor(cap),
                                    torch.as_tensor(qmask), 10e-6)
    _close(want, got, CASCADE_TOLS)
    # the dataplane's flat cascade in the sentinel layout, against the
    # reference's backend="xla"
    q1 = np.append(queue, 0.0).astype(np.float32)
    c1 = np.append(cap, 1e30).astype(np.float32)
    m1 = np.append(qmask, 0.0).astype(np.float32)
    kw = dict(n_links=L, kmin=RED[0], kmax=RED[1], pmax=RED[2], dt=10e-6, qmax_bytes=8e6)
    xla = jd.cascade(j(lid), j(rates), j(q1), j(c1), j(m1), backend="xla", **kw)
    flat = td.cascade(torch.as_tensor(lid)[None], torch.as_tensor(rates)[None],
                      torch.as_tensor(q1)[None], torch.as_tensor(c1), torch.as_tensor(m1),
                      backend="torch", **kw)
    _close(xla, [f[0] for f in flat], CASCADE_TOLS)
    assert float(flat[0][0, L]) == 0.0 and float(flat[2][0, L]) == 0.0


def _topos(kind):
    if kind == "leaf_spine":
        return jt.leaf_spine(2, 4, 4, 100e9), tt.leaf_spine(2, 4, 4, 100e9, device="cpu")
    kw = dict(bw_tor_agg=400e9, bw_agg_core=100e9)
    return jt.three_tier(4, 4, 2, 3, **kw), tt.three_tier(4, 4, 2, 3, device="cpu", **kw)


@pytest.mark.parametrize("kind,seed", [("leaf_spine", 0), ("three_tier", 1)])
def test_tiered_matches_flat_on_routes(kind, seed):
    """The two cascade layouts on the same routes, in the port (tiered and
    flat plain versions, mark probabilities of both layouts) and against the
    reference's flat oracle; same-leaf flows give absent fabric hops."""
    jtopo, topo = _topos(kind)
    rng = np.random.default_rng(seed)
    n, N = 256, 4
    src = rng.integers(0, topo.n_hosts, n)
    dst = rng.integers(0, topo.n_hosts, n)
    path = rng.integers(0, topo.n_paths, (n, N))
    hpl = topo.hosts_per_leaf
    links = topo.subflow_links(torch.as_tensor(src)[:, None], torch.as_tensor(dst)[:, None],
                               torch.as_tensor(path))
    tx, rx = topo.nic_links(torch.as_tensor(src), torch.as_tensor(dst))
    fab = topo.fabric_links(torch.as_tensor(src // hpl)[:, None],
                            torch.as_tensor(dst // hpl)[:, None], torch.as_tensor(path))
    assert bool((fab < 0).any())
    rates = (rng.random((n, N)) * 50e9).astype(np.float32)
    queue = (rng.random(topo.n_links) * 2e6).astype(np.float32)
    cap = topo.capacity[:-1]
    qmask = td.queue_mask_for(topo)[:-1]
    args = (topo.n_links, *RED, torch.as_tensor(queue), cap, qmask, 10e-6)
    flat = tref.linkload_cascade_ref(links.reshape(n * N, -1),
                                     torch.as_tensor(rates).reshape(-1), *args)
    tiered = tref.linkload_cascade_tiered_ref(fab, tx, rx, torch.as_tensor(rates), *args)
    _close(flat[:3] + (flat[3].reshape(n, N),), tiered, CASCADE_TOLS)
    jflat = jref.linkload_cascade_ref(
        jnp.asarray(links.reshape(n * N, -1).numpy()), jnp.asarray(rates.reshape(-1)),
        topo.n_links, *RED, jnp.asarray(queue), jtopo.capacity[:-1],
        jd.queue_mask_for(jtopo)[:-1], 10e-6)
    _close(jflat, flat, CASCADE_TOLS)
    pm = torch.as_tensor(np.append(rng.random(topo.n_links) * 0.3, 0.0).astype(np.float32))
    ps_flat = td.subflow_mark_probs(links[None], pm[None], topo.n_links)
    ps_nic = td.subflow_mark_probs_nic(fab[None], tx[None], rx[None], pm[None],
                                       topo.n_links)
    jps = jd.subflow_mark_probs(jnp.asarray(links.numpy()), jnp.asarray(pm.numpy()),
                                topo.n_links)
    for a, b, c in zip(ps_flat, ps_nic, jps):
        np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.asarray(c), a[0].numpy(), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------ flash attention
def _qkv(seed, B, S, H, K, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, h, hd)).astype(np.float32)
                 for h in (H, K, K))


def _flash_pair(arrays, dtype, **kw):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jref.flash_attention_ref(*(jnp.asarray(a).astype(jdt) for a in arrays), **kw)
    got = tfa.flash_attention(*(torch.as_tensor(a).to(tdt) for a in arrays), **kw)
    assert got.dtype == tdt
    return np.asarray(want, np.float32), got.to(torch.float32).numpy()


@pytest.mark.parametrize("S,H,K,hd", [(128, 4, 4, 32), (256, 4, 2, 64), (256, 8, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_shapes_dtypes(S, H, K, hd, dtype):
    want, got = _flash_pair(_qkv(0, 2, S, H, K, hd), dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [0, 32, 100])
def test_flash_plain_window(window):
    want, got = _flash_pair(_qkv(1, 1, 256, 2, 2, 32), "float32", window=window)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("softcap", [0.0, 10.0, 50.0])
def test_flash_plain_softcap(softcap):
    want, got = _flash_pair(_qkv(2, 1, 128, 2, 2, 32), "float32", softcap=softcap)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


def test_flash_entry_point_on_the_cpu():
    """ops.flash_attention with numpy arguments and device="cpu", on a
    ragged length (S not a multiple of the kernel's 64) with a window, a
    softcap and non-causal GQA."""
    arrays = _qkv(3, 1, 200, 4, 2, 16)
    for kw in (dict(window=48, softcap=30.0), dict(causal=False)):
        want = jref.flash_attention_ref(*(jnp.asarray(a) for a in arrays), **kw)
        got = ops.flash_attention(*arrays, device="cpu", **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-5)


OFFSET_CASES = [  # (B, Sk, H, K, hd, q_offset, Sq, kw)
    (1, 256, 2, 2, 32, 64, 64, {}), (2, 256, 4, 1, 16, 192, 64, {}),
    (1, 256, 2, 2, 32, 100, 100, dict(window=48)), (1, 200, 4, 2, 16, 136, 64, dict(window=32)),
    (1, 256, 2, 1, 32, 128, 128, dict(softcap=30.0)),
    (2, 192, 4, 2, 16, 40, 100, dict(window=64, softcap=10.0)),
    (1, 128, 2, 2, 32, 32, 64, dict(causal=False))]


@pytest.mark.parametrize("case", OFFSET_CASES, ids=lambda c: f"{c[5]}+{c[6]}of{c[1]}")
def test_flash_plain_at_an_offset_is_the_reference_rows(case):
    """The plain flash with a query block at an offset: rows [q_offset,
    q_offset + Sq) of ``repro.kernels.ref.flash_attention_ref`` over the
    whole sequence, float32 to 1e-5 (causal, windowed, softcapped and not
    causal; the key range longer than the block)."""
    B, Sk, H, K, hd, off, Sq, kw = case
    q, k, v = _qkv(10 + off, B, Sk, H, K, hd)
    want = np.asarray(jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), **kw))
    got = tfa.flash_attention(torch.as_tensor(q[:, off:off + Sq]), torch.as_tensor(k),
                              torch.as_tensor(v), q_offset=off, **kw).numpy()
    np.testing.assert_allclose(got, want[:, off:off + Sq], atol=1e-5, rtol=1e-5)
    through_op = ops.flash_attention(q[:, off:off + Sq], k, v, q_offset=off, device="cpu", **kw)
    np.testing.assert_array_equal(through_op.numpy(), got)


@pytest.mark.parametrize("off,Sq,Sk", [(-1, 8, 16), (9, 8, 16), (0, 17, 16)])
def test_flash_refuses_a_block_outside_the_keys(off, Sq, Sk):
    q, k = torch.zeros((1, Sq, 2, 16)), torch.zeros((1, Sk, 2, 16))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, k, q_offset=off)


# ------------------------------------------------- routes and cluster sizes
@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_route_by_dtype_and_head_dim(dtype, hd):
    """bf16 at the model widths goes to the wgmma kernel, the rest to the
    simt one; the route depends on nothing else."""
    route = tfa.flash_route(getattr(torch, dtype), hd)
    want = "wgmma" if dtype == "bfloat16" and hd in (64, 128, 256) else "simt"
    assert route == want
    assert tfa._ENTRIES[route][0] in ("flash_attention_sm90", "flash_attention")


@pytest.mark.parametrize("dtype,hd,err", [
    (torch.float16, 128, TypeError), (torch.float64, 64, TypeError),
    (torch.bfloat16, 48, ValueError), (torch.float32, 512, ValueError),
    (torch.bfloat16, 8, ValueError)])
def test_flash_route_refuses_what_neither_kernel_takes(dtype, hd, err):
    with pytest.raises(err):
        tfa.flash_route(dtype, hd)


def test_flash_on_the_cpu_counts_no_launch():
    """CPU tensors take the plain version: no route's count moves."""
    before = dict(tfa.flash_attention.route_launches), tfa.flash_attention.launches
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    tfa.flash_attention(q, q, q)
    assert (tfa.flash_attention.route_launches, tfa.flash_attention.launches) == before


@pytest.mark.parametrize("n_links", [51, 449, 2081])
def test_cluster_size_monotone_and_bounded(n_links):
    """cluster_size grows with W * N on a fixed link count and stays in
    [1, MAX_CLUSTER]; the fig12 shapes get the sizes PERF.md measured."""
    from repro_torch.kernels import cascade_tiered as tct

    sizes = [tct.cluster_size(W, N, n_links) for W in (1, 3, 10, 100, 1000, 5376, 56116)
             for N in (1, 4)]
    products = [W * N for W in (1, 3, 10, 100, 1000, 5376, 56116) for N in (1, 4)]
    order = np.argsort(products, kind="stable")
    ranked = [sizes[i] for i in order]
    assert ranked == sorted(ranked)
    assert all(1 <= c <= tct.MAX_CLUSTER for c in sizes)
    assert all(c & (c - 1) == 0 for c in sizes)  # powers of two
    if n_links == 449:
        assert tct.cluster_size(5376, 4, 449) == 16  # the fig12 batch
        assert tct.cluster_size(56116, 4, 449) == 16  # the dense engine
        assert tct.cluster_size(1000, 4, 449) == 8


def test_cluster_size_balances_links():
    """More link slots to sum over the cluster mean fewer CTAs."""
    from repro_torch.kernels import cascade_tiered as tct

    assert tct.cluster_size(2048, 4, 2081) == 4
    assert tct.cluster_size(2048, 4, 449) == 8
    assert tct.cluster_size(5, 4, 51) == 1


@pytest.mark.parametrize("kernel,rows,per_row,n_links,C", [
    ("flat", 21504, 1, 449, 16),        # fig12: B=2, W=5376 x N=4, sim_2tier
    ("flat", 224464, 1, 449, 16),       # the dense engine's shape
    ("flat", 8192, 1, 2081, 4),         # three_tier
    ("flat", 4000, 1, 449, 8),          # ragged: W=1000 x N=4
    ("linkload", 21504, 4, 448, 16),    # the fig12 flat shape
    ("linkload", 8192, 6, 512, 16),     # bench_kernels
])
def test_flat_and_linkload_cluster_sizes_at_the_smoke_shapes(kernel, rows, per_row, n_links, C):
    """The cluster size the flat cascade's wrapper (cluster_size(n, 1,
    L + 1)) and linkload's (cluster_size(n, hops, L)) ask for at the shapes
    chip_smoke.py times them at."""
    from repro_torch.kernels import cascade_common as tcc

    assert tcc.cluster_size(rows, per_row, n_links) == C
    if kernel == "flat":
        topo = tt.three_tier(device="cpu") if n_links == 2081 else tt.sim_2tier(device="cpu")
        assert topo.n_links + 1 == n_links


# ------------------------------------------- fixed-point (order-free) sums
@pytest.mark.parametrize("units,scale", [(64.0, 1e11), (2.0 ** 32, 125.0)],
                         ids=["link_load_bps", "intensity_pkts"])
def test_fixed_point_sum_equals_index_add_and_ignores_order(units, scale):
    """``cascade_common.fixed_point_index_add`` (the cascades' link-load
    quantum, and SeqBalance's intensity quantum) against a float64 sum:
    within half a quantum an entry plus one float32 rounding of the sum,
    so within float32 round-off of ``index_add_``; and bitwise the same
    when its (index, value) pairs come in another order."""
    from repro_torch.kernels import cascade_common as cc

    rng = np.random.default_rng(int(units) % 97)
    n, size = 20000, 37
    idx = rng.integers(0, size, n)
    vals = (rng.random(n) * scale * (rng.random(n) < 0.9)).astype(np.float32)
    got = cc.fixed_point_index_add(torch.as_tensor(idx), torch.as_tensor(vals), size, units)
    exact = np.zeros(size)
    np.add.at(exact, idx, vals.astype(np.float64))
    per_cell = np.bincount(idx, minlength=size)
    bound = per_cell * 0.5 / units + np.spacing(np.abs(exact).astype(np.float32))
    assert (np.abs(got.numpy().astype(np.float64) - exact) <= bound).all()
    plain = torch.zeros(size).index_add_(0, torch.as_tensor(idx), torch.as_tensor(vals))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-3 / units * n)
    for seed in range(3):
        perm = np.random.default_rng(seed).permutation(n)
        again = cc.fixed_point_index_add(torch.as_tensor(idx[perm]), torch.as_tensor(vals[perm]),
                                         size, units)
        assert torch.equal(again, got)


def test_intensity_and_link_sums_on_the_cpu_keep_index_add():
    """On CPU tensors ``dataplane.congestion_intensity`` and
    ``cascade_common.link_segment_sum`` are the plain in-order float sums
    (as the JAX package's segment sums)."""
    from repro_torch.kernels import cascade_common as cc

    rng = np.random.default_rng(4)
    cell = torch.as_tensor(rng.integers(0, 16, (2, 50, 4)))
    marked = torch.as_tensor(rng.random((2, 50, 4)).astype(np.float32))
    want = torch.zeros(16).index_add_(0, cell.reshape(-1), marked.reshape(-1))
    assert torch.equal(td.congestion_intensity(cell, marked, 16, max_pkts=1.0), want)
    vals = torch.as_tensor(rng.random((2, 30)).astype(np.float32) * 1e10)
    idx = torch.as_tensor(rng.integers(0, 7, (2, 30)))
    assert torch.equal(cc.link_segment_sum(vals, idx, 7), cc.segment_sum(vals, idx, 7))


def test_fixed_point_bound_at_the_dense_shape():
    """The dense engine's W = 56,116 flows of N = 4 sub-flows fit the
    cascades' int64 link loads at 400 Gb/s a sub-flow; 400,000 do not."""
    from repro_torch.kernels import cascade_common as cc

    cc.check_fixed_point("cascade_tiered", 56116 * 4)
    with pytest.raises(ValueError, match="overflow"):
        cc.check_fixed_point("cascade_tiered", 100000 * 4)
