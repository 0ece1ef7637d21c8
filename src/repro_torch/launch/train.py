"""End-to-end training driver, mirroring ``repro.launch.train``: its flags,
its log lines and their order.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --reduced \
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu

Exercised: the deterministic restart-safe data pipeline, AdamW + cosine,
checkpoint/resume (atomic saves, periodic ones async), the straggler
watchdog, per-step metrics, and ``--cosim-epochs``: the co-simulation
plan run before any model state, each epoch simulated on the device
(``dist.cosim.run_cosim``, the tiered cascade kernel on the card), whose
converged plan the grad sync takes.

``--grad-sync seqbalance`` runs the pod step (``launch.steps``) over a
pod axis of ``members`` pods, the JAX driver's local device count: under
``torchrun`` the world size (one process a card, NCCL; each rank on
``cuda:LOCAL_RANK``), else ``--pods N``, N members on this one device
(the pod axis of ``launch.mesh.make_pod_mesh``'s "local" transport).  With
fewer than 2 members, or a batch they do not divide, it prints the JAX
driver's fallback line and trains on one device.  The co-simulation's ring
has ``max(members, 2)`` pods.

Three flags the JAX driver lacks: ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path), ``--remat``, which sets ``cfg.remat`` (the
JAX config's own field) so that a published model's step fits on one
card, and ``--pods``.  ``main(argv)`` returns what it ran: the ``[cosim]``
lines, the final plan, the pod count and each step's metrics and wall.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.dist import collectives, elastic
from repro_torch.launch import mesh as mesh_mod, steps
from repro_torch.train import checkpoint, optimizer as opt_mod


def _cosim_plan(args, device, members: int):
    """--cosim-epochs: the multi-epoch co-simulation loop on a pod fabric
    (one gateway host per pod, ``members`` pods, at least two) whose
    converged PathPlan seeds the grad sync; with --cosim-kill-spine the
    failed spine is quarantined while down and released phi epochs after
    it recovers (the Fig. 11 round trip).  Returns (plan, its lines)."""
    from repro_torch.dist import cosim
    from repro_torch.netsim import topology

    n_ring = max(members, 2)
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
        _say(line)
    return hist.final_plan, lines


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _say(line: str) -> None:
    """Print on the first rank only (every rank of a torchrun runs this)."""
    if not _rank():
        print(line, flush=True)


def _join_torchrun(device):
    """Under torchrun (WORLD_SIZE > 1 in the environment): join its process
    group (NCCL on CUDA, gloo on the CPU) and take this rank's card.
    Returns (the world size, this rank's device); else (None, device)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None, device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return dist.get_world_size(), device


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
                    help="pod-axis gradient sync: one device ('xla', the baseline) "
                         "or the SeqBalance multipath chunk rings over the pods")
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
    ap.add_argument("--pods", type=int, default=1,
                    help="pods of the seqbalance grad sync on this one device (the "
                         "JAX driver's forced host devices); under torchrun the world "
                         "size instead")
    ap.add_argument("--remat", default=None, choices=["none", "dots", "full"],
                    help="per-superblock recomputation (cfg.remat; default the "
                         "config's own)")
    return ap


def main(argv=None) -> dict:
    """Train as the CLI does; returns {"cosim": the [cosim] lines, "plan":
    the final PathPlan, "pods": the pod axis's members (1: one device),
    "steps": each step's {"step", "loss", "nll", "grad_norm", "lr",
    "wall_s"}} (the wall from the end of the step before, as the JAX
    driver's)."""
    args = parser().parse_args(argv)
    world, dev = _join_torchrun(resolve_device(args.device))
    members = world or args.pods
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
    out = {"cosim": [], "plan": collectives.PathPlan(n_chunks=args.n_chunks), "pods": 1,
           "steps": []}
    if args.cosim_epochs > 0:
        out["plan"], out["cosim"] = _cosim_plan(args, dev, members)
        if args.cosim_only:
            return out

    state = steps.init_state(cfg, 0, device=dev)
    start = 0
    if args.resume and args.ckpt_dir and (s := checkpoint.latest_step(args.ckpt_dir)) is not None:
        state = checkpoint.restore(args.ckpt_dir, s, state)
        start = s + 1
        _say(f"[resume] from step {s}")

    mesh = None
    if args.grad_sync == "seqbalance":
        if members > 1 and args.batch % members == 0:
            # every member is one pod gateway: the pod axis carries the grad
            # sync through dist.collectives
            mesh = mesh_mod.make_pod_mesh(members, device=dev)
            out["pods"] = members
            _say(f"[grad-sync] seqbalance over {members}-way pod axis")
        else:
            _say("[grad-sync] seqbalance needs >1 device and a batch the "
                 "device count divides — falling back to the XLA baseline")
    step_fn = steps.make_train_step(cfg, ocfg, mesh, args.grad_sync, out["plan"])

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
            _say(f"step {i:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
                 f"lr {m['lr']:.2e} {dt:.2f}s")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0 and not _rank():
            checkpoint.save(args.ckpt_dir, i, state, blocking=False)
    if args.ckpt_dir and not _rank():
        checkpoint.save(args.ckpt_dir, args.steps - 1, state)
        _say(f"[ckpt] final at {args.ckpt_dir}")
    return out


if __name__ == "__main__":
    main()
