"""Datacenter topologies for the fluid simulator (paper §IV), mirroring
``repro.netsim.topology`` for ``leaf_spine`` (with per-link capacity
overrides), the paper's testbed fabrics ``testbed_symmetric`` and
``testbed_asymmetric`` (Fig. 8), ``hetero_leaf_spine``, ``sim_2tier`` and
``three_tier``, and the fault layer's link maps ``spine_links`` and
``paths_for_link``.

Links live in one flat capacity vector with a sentinel slot last
(capacity 1e30), onto which absent (-1) hops land.  The link-id builders
are methods that return tensors on the topology's device; the static
tables ``uplink_ids`` and ``path_link_table`` stay in numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device

MAX_HOPS = 6


@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
    """Static topology description.

    ``kind`` is ``"leaf_spine"`` (a path is a spine) or ``"three_tier"``
    (a path is ``agg * n_core + core``).  ``layout`` holds the first link
    id of each link block (see the builders)."""

    kind: str
    n_leaf: int
    n_paths: int
    hosts_per_leaf: int
    n_links: int
    capacity: torch.Tensor  # f32[n_links + 1] bps; last slot = sentinel
    n_fabric_hops: int
    uplink_ids: np.ndarray  # int32[n_leaf, n_uplinks] ToR uplink link ids
    base_rtt_s: float
    path_link_table: np.ndarray  # int32[n_leaf, n_leaf, n_paths, MAX_HOPS-2]
    layout: dict
    device: torch.device

    @property
    def n_hosts(self) -> int:
        return self.n_leaf * self.hosts_per_leaf

    def to(self, device) -> "Topology":
        device = resolve_device(device)
        return dataclasses.replace(self, capacity=self.capacity.to(device), device=device)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.int64)

    def nic_links(self, src_host, dst_host) -> tuple[torch.Tensor, torch.Tensor]:
        """(host_tx, host_rx) link ids, int32, shared by a flow's sub-flows."""
        src_host, dst_host = torch.broadcast_tensors(self._t(src_host), self._t(dst_host))
        tx = self.layout["tx0"] + src_host
        rx = self.layout["rx0"] + dst_host
        return tx.to(torch.int32), rx.to(torch.int32)

    def fabric_links(self, src_leaf, dst_leaf, path) -> torch.Tensor:
        """int32[..., n_fabric_hops] fabric link ids (-1 = hop absent)."""
        src_leaf, dst_leaf, path = torch.broadcast_tensors(
            self._t(src_leaf), self._t(dst_leaf), self._t(path))
        inter = src_leaf != dst_leaf
        lay = self.layout
        none = torch.full_like(path, -1)
        if self.kind == "leaf_spine":
            S, L = self.n_paths, self.n_leaf
            hops = [lay["up0"] + src_leaf * S + path, lay["dn0"] + path * L + dst_leaf]
        else:
            A, C, T = lay["A"], lay["C"], self.n_leaf
            agg, core = path // C, path % C
            hops = [lay["ta0"] + src_leaf * A + agg, lay["ac0"] + agg * C + core,
                    lay["ca0"] + core * A + agg, lay["at0"] + agg * T + dst_leaf]
        return torch.stack([torch.where(inter, h, none) for h in hops], -1).to(torch.int32)

    def subflow_links(self, src_host, dst_host, path) -> torch.Tensor:
        """int32[..., 2 + n_fabric_hops]: [host_tx, fabric hops..., host_rx]."""
        src_host, dst_host, path = torch.broadcast_tensors(
            self._t(src_host), self._t(dst_host), self._t(path))
        tx, rx = self.nic_links(src_host, dst_host)
        hpl = self.hosts_per_leaf
        fab = self.fabric_links(src_host // hpl, dst_host // hpl, path)
        return torch.cat([tx[..., None], fab, rx[..., None]], -1)


def _apply_overrides(cap: np.ndarray, overrides) -> np.ndarray:
    for link_id, new_cap in (overrides or {}).items():
        cap[link_id] = new_cap
    return cap


def leaf_spine(n_leaf: int, n_spine: int, hosts_per_leaf: int, link_bw: float,
               host_bw: float | None = None, base_rtt_s: float = 4e-6,
               capacity_overrides: dict[int, float] | None = None,
               device=None) -> Topology:
    """2-tier Clos.  Link layout:
    up[l,s] = l*S + s;  down[s,l] = L*S + s*L + l;
    host_tx[h] = 2*L*S + h;  host_rx[h] = 2*L*S + H + h.
    ``capacity_overrides`` maps link ids to their own bandwidth."""
    device = resolve_device(device)
    L, S, H = n_leaf, n_spine, n_leaf * hosts_per_leaf
    host_bw = link_bw if host_bw is None else host_bw
    n_links = L * S + S * L + 2 * H
    cap = np.zeros(n_links + 1, np.float32)
    cap[: L * S] = link_bw
    cap[L * S: 2 * L * S] = link_bw
    cap[2 * L * S: 2 * L * S + 2 * H] = host_bw
    cap[-1] = np.float32(1e30)
    cap = _apply_overrides(cap, capacity_overrides)
    up0, dn0, tx0, rx0 = 0, L * S, 2 * L * S, 2 * L * S + H

    uplink_ids = (np.arange(L)[:, None] * S + np.arange(S)[None, :]).astype(np.int32)
    plt = np.full((L, L, S, MAX_HOPS - 2), -1, np.int32)
    for sl in range(L):
        for dl in range(L):
            if sl == dl:
                continue
            for p in range(S):
                plt[sl, dl, p, 0] = up0 + sl * S + p
                plt[sl, dl, p, 3] = dn0 + p * L + dl
    return Topology(
        kind="leaf_spine", n_leaf=L, n_paths=S, hosts_per_leaf=hosts_per_leaf,
        n_links=n_links, capacity=torch.as_tensor(cap, device=device),
        n_fabric_hops=2, uplink_ids=uplink_ids, base_rtt_s=base_rtt_s,
        path_link_table=plt,
        layout=dict(up0=up0, dn0=dn0, tx0=tx0, rx0=rx0), device=device,
    )


def three_tier(n_tor: int = 20, n_agg: int = 20, n_core: int = 16,
               hosts_per_tor: int = 16, bw_tor_agg: float = 400e9,
               bw_agg_core: float = 100e9, host_bw: float = 100e9,
               base_rtt_s: float = 8e-6, device=None) -> Topology:
    """3-tier folded Clos (paper Fig. 14 setup).  Path id = agg*n_core+core.
    Link layout: ta_up[t,a] = t*A + a;  ac_up[a,c] = T*A + a*C + c;
    ca_dn[c,a] = T*A + A*C + c*A + a;  at_dn[a,t] = T*A + 2*A*C + a*T + t;
    host_tx[h], host_rx[h] appended."""
    device = resolve_device(device)
    T, A, C = n_tor, n_agg, n_core
    H = T * hosts_per_tor
    n_links = T * A + 2 * A * C + A * T + 2 * H
    cap = np.zeros(n_links + 1, np.float32)
    ta0, ac0 = 0, T * A
    ca0 = T * A + A * C
    at0 = T * A + 2 * A * C
    tx0 = T * A + 2 * A * C + A * T
    rx0 = tx0 + H
    cap[ta0: ta0 + T * A] = bw_tor_agg
    cap[ac0: ac0 + A * C] = bw_agg_core
    cap[ca0: ca0 + C * A] = bw_agg_core
    cap[at0: at0 + A * T] = bw_tor_agg
    cap[tx0: tx0 + 2 * H] = host_bw
    cap[-1] = np.float32(1e30)
    uplink_ids = (np.arange(T)[:, None] * A + np.arange(A)[None, :]).astype(np.int32)
    # the reference builds no path_link_table for three_tier (no scheme
    # that needs it runs there)
    plt = np.zeros((0,), np.int32)
    return Topology(
        kind="three_tier", n_leaf=T, n_paths=A * C, hosts_per_leaf=hosts_per_tor,
        n_links=n_links, capacity=torch.as_tensor(cap, device=device),
        n_fabric_hops=4, uplink_ids=uplink_ids, base_rtt_s=base_rtt_s,
        path_link_table=plt,
        layout=dict(ta0=ta0, ac0=ac0, ca0=ca0, at0=at0, tx0=tx0, rx0=rx0, A=A, C=C),
        device=device,
    )


def testbed_symmetric(device=None) -> Topology:
    """Paper Fig. 8(a): 2 leaves x 4 spines, 3 hosts a leaf, all 40G."""
    return leaf_spine(2, 4, 3, 40e9, base_rtt_s=4e-6, device=device)


def testbed_asymmetric(device=None) -> Topology:
    """Paper Fig. 8(b): one spine off and its links moved to a neighbour, so
    3 paths, the third at 80G (up[l, 2] and down[2, l]) and the rest at 40G.
    ECMP hashes uniformly over the 3 paths; SeqBalance's congestion
    feedback steers load to the fat one."""
    L, S = 2, 3
    overrides = {}
    for leaf in range(L):
        overrides[leaf * S + 2] = 80e9  # up[l, 2]
        overrides[L * S + 2 * L + leaf] = 80e9  # down[2, l]
    return leaf_spine(L, S, 3, 40e9, base_rtt_s=4e-6, capacity_overrides=overrides,
                      device=device)


def sim_2tier(device=None) -> Topology:
    """Paper §IV.B: 8 leaves x 12 spines x 16 hosts, 100G everywhere."""
    return leaf_spine(8, 12, 16, 100e9, base_rtt_s=4e-6, device=device)


def hetero_leaf_spine(n_leaf: int = 4, n_spine: int = 4, hosts_per_leaf: int = 4,
                      slow_bw: float = 100e9, fast_bw: float = 400e9,
                      n_fast_spines: int = 1, host_bw: float | None = None,
                      base_rtt_s: float = 4e-6, device=None) -> Topology:
    """Mixed-speed 2-tier Clos: the last ``n_fast_spines`` spine planes run
    at ``fast_bw`` (uplinks up[l, s] and downlinks down[s, l]), the rest at
    ``slow_bw``; hosts at ``slow_bw`` unless ``host_bw`` says otherwise.
    Hash-based schemes split uniformly over the planes; the capacity-
    weighted ``flowlet_timeout`` scheme sees the fast planes' headroom."""
    if not 0 <= n_fast_spines <= n_spine:
        raise ValueError(f"n_fast_spines {n_fast_spines} not in [0, {n_spine}]")
    L, S = n_leaf, n_spine
    overrides: dict[int, float] = {}
    for s in range(S - n_fast_spines, S):
        for leaf in range(L):
            overrides[leaf * S + s] = fast_bw  # up[l, s]
            overrides[L * S + s * L + leaf] = fast_bw  # down[s, l]
    return leaf_spine(L, S, hosts_per_leaf, slow_bw, host_bw=host_bw,
                      base_rtt_s=base_rtt_s, capacity_overrides=overrides, device=device)


def spine_links(topo: Topology, spine: int) -> tuple[int, ...]:
    """Flat link ids that die with one fabric switch, the unit of the fault
    schedules (``faults.random_campaign``).  ``leaf_spine``: spine switch
    ``spine``'s uplinks up[l, spine] and downlinks down[spine, l] for every
    leaf l.  ``three_tier``: aggregation switch ``spine``'s ToR uplinks,
    agg-core links both ways and ToR downlinks."""
    if topo.kind == "leaf_spine":
        L, S = topo.n_leaf, topo.n_paths
        if not 0 <= spine < S:
            raise ValueError(f"spine {spine} not in [0, {S})")
        return tuple(l * S + spine for l in range(L)) + tuple(
            L * S + spine * L + l for l in range(L))
    lay = topo.layout
    T, A, C = topo.n_leaf, lay["A"], lay["C"]
    if not 0 <= spine < A:
        raise ValueError(f"aggregation switch {spine} not in [0, {A})")
    return (tuple(lay["ta0"] + t * A + spine for t in range(T))
            + tuple(lay["ac0"] + spine * C + c for c in range(C))
            + tuple(lay["ca0"] + c * A + spine for c in range(C))
            + tuple(lay["at0"] + spine * T + t for t in range(T)))


def paths_for_link(topo: Topology, link: int) -> tuple[int, ...]:
    """The path ids that traverse flat link ``link`` (host links and the
    sentinel belong to none).  ``leaf_spine``: up[l, s] and down[s, l] map
    to path s.  ``three_tier`` (path = agg * C + core): a ToR up- or
    downlink of agg a covers the C paths (a, *), an agg-core link one."""
    if topo.kind == "leaf_spine":
        L, S = topo.n_leaf, topo.n_paths
        if link < L * S:
            return (link % S,)
        if link < 2 * L * S:
            return ((link - L * S) // L,)
        return ()
    lay = topo.layout
    T, A, C = topo.n_leaf, lay["A"], lay["C"]
    if link < lay["ac0"]:
        a = link % A
        return tuple(a * C + c for c in range(C))
    if link < lay["ca0"]:
        i = link - lay["ac0"]
        return ((i // C) * C + (i % C),)
    if link < lay["at0"]:
        i = link - lay["ca0"]
        return ((i % A) * C + i // A,)
    if link < lay["tx0"]:
        a = (link - lay["at0"]) // T
        return tuple(a * C + c for c in range(C))
    return ()
