"""Simulate the paper's large-scale setup (8 leaves x 12 spines x 128
hosts @100G) and compare SeqBalance against ECMP/LetFlow/CONGA/DRILL: the
twin of ``examples/simulate_datacenter.py`` on the port, its flags and its
printed lines.

Runs on the active-window engine (``netsim.sweep.run_jobs``, every step
but DRILL's through the tiered cascade kernel); pass --dense for the O(F)
oracle (``netsim.engine.simulate``).

Run: python -m repro_torch.examples.simulate_datacenter [--elephants] [--load L]
     [--dense] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.netsim import engine, metrics, sweep, topology, workloads

SCHEMES = ("ecmp", "letflow", "conga", "drill", "seqbalance")
TRACE_S, SIM_S = 4e-3, 16e-3


def trace_for(topo, elephants: bool = False, load: float = 0.6,
              duration_s: float = TRACE_S):
    """(workload name, the example's Poisson trace on ``topo``)."""
    wl = "fixed:10e6" if elephants else "websearch"
    n_spine = topo.uplink_ids.shape[-1]
    return wl, workloads.poisson_trace(workloads.TraceConfig(
        workload=wl, load=load, duration_s=duration_s, n_hosts=topo.n_hosts,
        host_bw=100e9, seed=1, hosts_per_leaf=topo.hosts_per_leaf,
        load_base_bw=topo.n_leaf * n_spine * 100e9,
    ))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def simulate(topo=None, elephants: bool = False, load: float = 0.6, dense: bool = False,
             duration_s: float = SIM_S, trace_s: float = TRACE_S, device=None) -> dict:
    """The five schemes on ``topo`` (``None``: ``topology.sim_2tier()``):
    {"workload", "flows", "stats": scheme -> ``metrics.fct_stats`` with
    "imbalance_median", "engine", "wall_s"}."""
    dev = resolve_device(device)
    topo = topology.sim_2tier(device=dev) if topo is None else topo.to(dev)
    wl, trace = trace_for(topo, elephants, load, trace_s)
    t0 = time.time()
    if dense:
        runs = {}
        for scheme in SCHEMES:
            st, outs = engine.simulate(topo, engine.SimConfig(scheme=scheme,
                                                              duration_s=duration_s),
                                       trace, device=dev)
            runs[scheme] = (st._replace(finish=_host(st.finish)),
                            outs._replace(uplink_load=_host(outs.uplink_load)))
    else:
        jobs = [(topo, engine.SimConfig(scheme=s, duration_s=duration_s), [trace])
                for s in SCHEMES]
        out = sweep.run_jobs(jobs, device=dev)
        runs = {s: (r[0], o[0]) for s, (r, o) in zip(SCHEMES, out)}
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.time() - t0
    stats = {}
    for scheme in SCHEMES:
        st, outs = runs[scheme]
        s = metrics.fct_stats(st, trace, topo, 100e9)
        imb = metrics.throughput_imbalance(outs)
        stats[scheme] = {**s, "imbalance_median": float(np.median(imb)) if len(imb) else -1.0}
    return {"workload": wl, "load": load, "flows": int(trace.valid.sum()), "stats": stats,
            "engine": "dense" if dense else "active-window", "wall_s": wall}


def lines(run: dict) -> list[str]:
    """The JAX example's printed lines for a ``simulate`` result."""
    out = [f"workload={run['workload']} load={run['load']} flows={run['flows']}"]
    for scheme in SCHEMES:
        s = run["stats"][scheme]
        out.append(f"{scheme:11s} avg_slowdown={s['avg_slowdown']:7.2f} "
                   f"p99={s['p99_slowdown']:8.2f} completion={s['completion_rate']:.3f} "
                   f"imbalance_median={s['imbalance_median']:.3f}")
    out.append(f"engine={run['engine']} wall={run['wall_s']:.1f}s")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--elephants", action="store_true",
                    help="AI-training traffic mode (few large flows)")
    ap.add_argument("--load", type=float, default=0.6)
    ap.add_argument("--dense", action="store_true",
                    help="use the dense O(F) oracle engine instead")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run = simulate(elephants=args.elephants, load=args.load, dense=args.dense,
                   device=args.device)
    print("\n".join(lines(run)))
    return run


if __name__ == "__main__":
    main()
