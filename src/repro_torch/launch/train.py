"""End-to-end training driver, mirroring ``repro.launch.train``: its flags,
its log lines and their order.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --reduced \
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu

Exercised: the deterministic restart-safe data pipeline, AdamW + cosine,
checkpoint/resume (atomic saves, periodic ones async), the straggler
watchdog, per-step metrics, and ``--cosim-epochs``: the co-simulation
plan run before any model state, each epoch simulated on the device
(``dist.cosim.run_cosim``, the tiered cascade kernel on the card).

Two flags the JAX driver lacks: ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path) and ``--remat``, which sets ``cfg.remat``
(the JAX config's own field) so that a published model's step fits on
one card.  ``--grad-sync seqbalance`` raises: the ring all-reduce, the
sharding rules and the mesh wait in ROADMAP.md's queue 1 item 2.
``main(argv)`` returns what it ran: the ``[cosim]`` lines, the final
plan and each step's metrics and wall.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.dist import collectives, elastic
from repro_torch.launch import steps
from repro_torch.train import checkpoint, optimizer as opt_mod


def _cosim_plan(args, device):
    """--cosim-epochs: the multi-epoch co-simulation loop on a pod fabric
    (one gateway host per pod, one pod per local card, at least two) whose
    converged PathPlan seeds the grad sync; with --cosim-kill-spine the
    failed spine is quarantined while down and released phi epochs after
    it recovers (the Fig. 11 round trip).  Returns (plan, its lines)."""
    from repro_torch.dist import cosim
    from repro_torch.netsim import topology

    n_ring = max(torch.cuda.device_count(), 2)
    topo = topology.leaf_spine(n_ring, 4, 1, 100e9, device=device)
    faults = ()
    if args.cosim_kill_spine >= 0:
        faults = (cosim.kill_spine(
            topo, args.cosim_kill_spine % topo.n_paths, epoch=1,
            recover_epoch=args.cosim_epochs // 2 + 1),)
    hist = cosim.run_cosim(
        topo, list(range(n_ring)), 8e6, scheme="ecmp", epochs=args.cosim_epochs,
        faults=faults, phi_steps=args.cosim_phi, n_chunks=args.n_chunks, device=device)
    rebuilds = sum(r.new_builds for r in hist.records[1:])
    lines = [f"[cosim] {line}" for line in hist.summary_lines()]
    lines.append(f"[cosim] final plan inactive={hist.final_plan.inactive} "
                 f"rebuilds_after_first={rebuilds}")
    for line in lines:
        print(line, flush=True)
    return hist.final_plan, lines


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-sync", default="xla", choices=["xla", "seqbalance"],
                    help="pod-axis gradient sync: one device ('xla'); 'seqbalance' "
                         "(the multipath chunk rings) is not ported yet and raises")
    ap.add_argument("--n-chunks", type=int, default=4,
                    help="seqbalance grad-sync chunk count")
    ap.add_argument("--cosim-epochs", type=int, default=0,
                    help="run this many plan->fluid-sim->health co-sim epochs "
                         "(dist.cosim) before training and seed the grad-sync "
                         "PathPlan from the converged plan")
    ap.add_argument("--cosim-kill-spine", type=int, default=1,
                    help="spine failed at co-sim epoch 1 (recovering at "
                         "epochs//2 + 1); -1 = healthy fabric")
    ap.add_argument("--cosim-phi", type=int, default=2,
                    help="co-sim quarantine window (planning epochs)")
    ap.add_argument("--cosim-only", action="store_true",
                    help="exit after the co-sim loop (CI smoke)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the co-simulation run ('cpu': the "
                         "plain PyTorch path)")
    ap.add_argument("--remat", default=None, choices=["none", "dots", "full"],
                    help="per-superblock recomputation (cfg.remat; default the "
                         "config's own)")
    return ap


def main(argv=None) -> dict:
    """Train as the CLI does; returns {"cosim": the [cosim] lines, "plan":
    the final PathPlan, "steps": each step's {"step", "loss", "nll",
    "grad_norm", "lr", "wall_s"}} (the wall from the end of the step
    before, as the JAX driver's)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, reduced=args.reduced)
    if args.reduced:
        cfg = cfg.replace(dtype="float32")
    if args.remat is not None:
        cfg = cfg.replace(remat=args.remat)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, global_batch=args.batch, seq_len=args.seq)
    ocfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                               total_steps=args.steps)

    # co-sim first: --cosim-only must exit before any model state (the
    # parameters and moments of a published model are tens of GB)
    out = {"cosim": [], "plan": collectives.PathPlan(n_chunks=args.n_chunks), "steps": []}
    if args.cosim_epochs > 0:
        out["plan"], out["cosim"] = _cosim_plan(args, dev)
        if args.cosim_only:
            return out
    step_fn = steps.make_train_step(cfg, ocfg, None, args.grad_sync, out["plan"])

    state = steps.init_state(cfg, 0, device=dev)
    start = 0
    if args.resume and args.ckpt_dir and (s := checkpoint.latest_step(args.ckpt_dir)) is not None:
        state = checkpoint.restore(args.ckpt_dir, s, state)
        start = s + 1
        print(f"[resume] from step {s}", flush=True)

    watchdog = elastic.StragglerPolicy(deadline_s=120.0)
    t_last = time.time()
    for i in range(start, args.steps):
        batch = pipeline.batch_at(dcfg, i, device=dev)
        state, m = step_fn(state, batch)
        m = {k: float(v) for k, v in m.items()}  # waits for the step
        dt = time.time() - t_last
        t_last = time.time()
        watchdog.observe(0, dt)
        out["steps"].append({"step": i, **m, "wall_s": dt})
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
                  f"lr {m['lr']:.2e} {dt:.2f}s", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, i, state, blocking=False)
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps - 1, state)
        print(f"[ckpt] final at {args.ckpt_dir}", flush=True)
    return out


if __name__ == "__main__":
    main()
