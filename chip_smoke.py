#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --cluster-sweep

Phases, each printed as JSON lines:

  1. device   the card's name and power limit (nvidia-smi) and the time to
              build the CUDA kernel libraries from src/repro_torch/csrc/;
  2. kernel   each CUDA kernel against its plain PyTorch version on the
              card, with the kernel's time ("ms": back-to-back launches
              through its library's C entry, outputs allocated once,
              replayed from a CUDA graph, so no host work sets the pace),
              the same launches called from the host ("c_entry_ms"), the
              wrapper's ("wrapper_ms": its checks, allocations and
              launch), the plain version's and
              (where one PyTorch call computes the same function) the
              library call's times, and the bound:
              - cascade_tiered at the fig12 shapes (sim_2tier, W=5376,
                N=4, Hf=2, B=2), the default three_tier shapes (2,081
                links, Hf=4), a ragged case (W not a multiple of 32,
                -1 hops) and the dense engine's shape, each row with the
                cluster size C it ran with;
              - cascade_flat (the flat cascade) on the same routes in the
                flat layout (n = W * N sub-flows of H = Hf + 2 hops), and
                the tiered kernel held against it, each row with its C;
              - linkload at bench_kernels' n=8192, hops=6, L=512 and at
                the fig12 flat shape, each row with its C, each case
                launched twice (bitwise-equal: fixed-point sums);
              - flash_attention at the full width of qwen3-32b and
                gemma2-2b in bfloat16 with q scaled so that the scores
                reach the softcap's range (the "wgmma" route,
                csrc/flash_attention_sm90.cu), at phase 13's prefill shape
                (B = 4, S = 5,120) for a local layer (window 4,096) and a
                global one (no window), and at S = 4,999, and in
                float32 (the "simt" route, csrc/flash_attention.cu) with
                phase 12's prefill shape among them, each row with the
                route it ran on, checked against the case's: elementwise
                within tests/test_kernels.py's tolerances and every output
                row within FLASH_ROW_REL of the plain version, a limit that
                the plain version with the window one block short or
                without the softcap is shown to break; the cases without
                a softcap also against F.scaled_dot_product_attention,
                and the serving cases with one (FLEX_CASES) against
                torch.nn.attention.flex_attention compiled, each library
                call timed where it holds the case's tolerance; and a
                query block at an offset against a longer key range on
                both routes (gemma2-2b's last block of prefill_32k split
                32 ways, window and softcap; qwen3-32b's head split, four
                query heads on one KV head; phase 12's float32 shape),
                where the plain version at offset 0 is shown to break the
                row limit;
              each kernel is one Spec record driven by one loop; each new
              kernel's entry point (dataplane.cascade, ops.linkload,
              ops.flash_attention) is driven once with the launch counts
              set to 0 and read back;
  3. sweep    the fig12 fast sweep (5 schemes x 4 cases, sim_2tier, 10 ms
              horizon) through repro_torch.netsim.sweep.run_jobs, checking
              0 spill and that the kernel ran every step of the four
              schemes that use it; then its SeqBalance alistorage batch
              twice more with the recorder on: the three runs' finish
              arrays and per-step outputs and the two rings must be
              bit-identical (the kernels' sums do not depend on the order
              of their additions);
  4. agree    the sweep's FCT stats against the JAX package's, recorded in
              src/repro_torch/netsim/fig12_fast_reference.json;
  5. dense    the dense oracle repro_torch.netsim.engine.simulate on the
              sweep's two alistorage traces, through the tiered kernel:
              its FCT stats against the sweep's and the JAX package's
              under the gates of phase 4, its wall time, us per step and
              the speedup of the sweep over it on those traces;
  6. profile  32 steps of the SeqBalance alistorage batch of the compact
              sweep, and 32 steps of the dense engine on the alistorage
              0.8 trace, under torch.profiler: host ms per step (and per
              phase, compact), the device's busy and idle share, the
              kernels with the most device time; then
              repro_torch.netsim.profile.profile_phases on the compact
              batch: admit, cascade, dcqcn, finish, the whole step and the
              quiescence check, each timed alone (us, the card
              synchronized around each call), printed, not gated;
  7. adaptive fixed and adaptive dt (SimConfig(adaptive=True)), back to
              back per scheme, on three cases: bench_adaptive_dt's
              collective on leaf_spine(4, 4, 4) and on sim_2tier, and the
              fig12 sweep's two alistorage traces (the websearch ones left
              out for phases 9 and 10's time); each run against the JAX package's
              (src/repro_torch/netsim/adaptive_reference.json) under the
              gates of phase 4, adaptive against fixed too; ff_steps
              beside the JAX package's (the collectives must
              fast-forward), the walls and their ratio beside the
              reference's floors, and the tiered kernel's launches against
              the stepped steps plus the steady-state checks (none in fig12
              where the arrival check rules a boundary out);
  8. faults   the fig12 alistorage 0.5 trace under a drawn fault campaign's
              wall-clock capacity schedule and 0.5 % loss on spine 0,
              SeqBalance and ECMP, fixed and adaptive, against the JAX
              package's; a zero-loss vector against no loss operand, and
              the static capacity against the schedule;
  9. flowcell bench_flowcell's grid (a ring of 8 on leaf_spine(4, 4, 4) at
              25G with 100G hosts, and its hetero twin with one 100G spine;
              FLOWCELL_GRID: 8 MB, 150 us gaps, 5 ms, half the bench's):
              SeqBalance, ECMP, flowlet_timeout and ECMP over a 4-flowcell
              trace with the reordering cost free or at budgets 0, 4, 16;
              the censored p99/p50/completion of each against the JAX
              package's (src/repro_torch/netsim/flowcell_reference.json),
              and its two acceptance facts; flowcells=1 and reorder=0.0 on
              unsprayed traffic bit-identical to the classic run (the
              grid's SeqBalance arm; also on phase 3's SeqBalance
              alistorage batch); the ring at 8 MB on sim_2tier with
              adaptive dt, ff_steps beside the JAX package's; the grid's
              arms with a window of every flow, and its symmetric ECMP arm
              again at the planner's window, which spills: sweep's spill
              retry gives the full window's finishes;
 10. record   the flight recorder (RecordSpec(ring_chunks=64)) on
              bench_obs's collective, fixed and adaptive, and on phase 3's
              SeqBalance alistorage batch: finish times without and with
              the ring (alternated twice; each bit-identical to the first
              run without it, and the two rings to each other), the
              overhead beside the reference's 5 % floor, and the drained
              ring against the JAX package's
              (src/repro_torch/netsim/record_reference.json);
 11. cosim    the dist/ epoch driver (repro_torch.dist.cosim.run_cosim,
              each epoch simulated on the card) on bench_cosim.py's
              cases (cosim_cases: the three_tier acceptance row at full
              width, the leaf_spine grid through run_cosim_grid with the
              recorder and a flight log, the mixed chaos campaign with
              adaptive dt, the degraded telemetry and blackout cells; the
              leaf_spine rings at COSIM_RING_BYTES), each held per epoch
              against the JAX package's run of the same spec
              (src/repro_torch/netsim/cosim_reference.json), its wall and
              us per step printed.
 12. serve_ref gemma2-2b at full width cut to 4 layers and a 256-token
              window (weights from repro_torch.models.weights.numpy_params),
              two prompts of 384 and 600 tokens, 32 new tokens, served in
              float32 (flash route "simt") and bfloat16 ("wgmma"), each
              against the JAX package's serving of the same case
              (src/repro_torch/models/serve_reference.json): decode
              teacher-forced on its tokens, the logits at its top-8 ids
              within SERVE_TOL of the row's RMS, and ServeEngine's own
              tokens equal to its tokens up to the first near-tie (the
              rules of repro_torch.serve.compare);
 13. serve    the slice's main path: gemma2-2b as published (26 layers,
              window 4,096, bfloat16, weights from model.init_params on
              the card), 4 prompts of 4,500-5,120 tokens, 32 new tokens,
              through repro_torch.serve.engine.ServeEngine: 26 wgmma flash
              launches a prefill and none on simt, held against the same
              weights served with the plain attention, run twice (bit for
              bit); prefill and decode walls, tokens/s, peak memory, and
              one prefill and 8 decode ticks under torch.profiler;
 14. serve_families_ref
              phase 12's case for the moe, hybrid and ssm families at full
              width, cut in depth: deepseek-moe-16b and
              granite-moe-3b-a800m (2 layers), recurrentgemma-9b (one
              R, R, A superblock, window 256) and xlstm-1.3b (one 7:1
              superblock), prompts of 384 and 600 (xlstm 512) tokens,
              float32 and bfloat16, against the JAX package's runs
              (src/repro_torch/models/families_reference.json) by phase
              12's rules, a bfloat16 run against the JAX package's
              float32 run fed its tokens (the JAX package's own bfloat16
              runs lie up to 0.20 of the RMS from it); xlstm-1.3b's
              whole bfloat16 runs are noise (the JAX package's lies 1.8
              of the RMS from its float32 run) and are printed, not held:
              its first mLSTM and its sLSTM are held instead, fed one
              input on both sides, within compare.UNIT_TOL of the JAX
              package's float32 unit (in float32 and bfloat16); the MoE
              prefill's dropped replicas per layer equal to the JAX
              package's in float32 (and more than 0), and its tokens
              routed otherwise counted beside the JAX near-ties;
 15. serve_families
              the slice's main path: deepseek-moe-16b (28 wgmma flash
              launches a prefill), recurrentgemma-9b (12) and xlstm-1.3b
              (none) as published, bfloat16, 4 prompts each, 32 new
              tokens, one after another through ServeEngine, each as
              phase 13 runs gemma2-2b (for deepseek the plain reference
              is run again, fed the same tokens and routed to the kernel
              run's experts, and held at SERVE_TOL: a bf16 near-tie sends
              a token to other experts on one side only), with the MoE
              replicas dropped and the tokens routed otherwise than with
              the plain attention in each prefill layer, and the
              profile's device ms inside the model's ranges (MoE
              dispatch, experts and combine, the recurrent scans).
 16. testbed  Table I (core.gbn.table1_inflation on the card: 5.77x and
              2.83x), then the paper's testbed results at the paper's scale
              (benchmarks/paper_benches.py:99-156, copied): Fig. 10 on
              topology.testbed_symmetric() and Fig. 11 on
              testbed_asymmetric(), ECMP and SeqBalance, 15 ms of three
              pairs of 4 QPs starting at 0, 5 and 10 ms, leaf 0's per-path
              uplink load over steps 1,000-1,500 (total, spread, the fat
              path and its gain); Table II, SeqBalance with 1, 2 and 3
              senders for 10 ms in one batch (congestion-packet bandwidth,
              mean goodput); each reading against the JAX package's
              (src/repro_torch/netsim/testbed_reference.json) within
              TESTBED_REL, the paper's facts as the JAX package reads
              them, and the tiered kernel launched on every step of every
              run (that each TESTBED_PLANTED fault fails these gates is
              shown by tests/test_torch_testbed.py).
 17. train_ref TRAIN_CASE: gemma2-2b at full width (d_model 2,304, vocab
              256,000, 8/4 heads of 256, d_ff 9,216) cut to a local and a
              global layer, window 128, weights from
              weights.numpy_params, batches from data.pipeline.batch_at
              (B 2, S 256), 3 steps of launch.steps.make_train_step
              (AdamW lr 1e-3, warmup 1, total 8), in float32 and in
              bfloat16 on float32 masters, against the JAX package's
              float32 run (src/repro_torch/launch/train_reference.json):
              loss, nll, grad norm, lr, each leaf's grad norm and 64
              sampled grad entries per step, each leaf's update after
              step 3; float32 within TRAIN_TOL, bfloat16 within
              BF16_SPREAD_FACTOR times the JAX package's own bfloat16
              spread (bf16_limits); then the restart check (REDUCED
              gemma2-2b, 6 steps straight against 3, a checkpoint, a
              restore into a fresh state and 3 more, bit for bit under
              torch.use_deterministic_algorithms) and the chunked
              attention against the whole score matrix at S 2,048; no
              kernel launches (training runs the plain attention);
 18. train    the slice's main path: repro_torch.launch.train as its CLI
              runs (TRAIN_ARGV): gemma2-2b as published (26 layers, window
              4,096, bfloat16 compute on float32 masters, remat "full"),
              B 2, S 2,048 (the chunked attention), 10 steps, after 4
              co-simulation epochs on the card (--cosim-epochs 4, each a
              sweep.run_one through the tiered kernel): the [cosim] lines
              (but their build counts) and the final plan's inactive set
              equal to the JAX driver's, one tiered launch a stepped
              step, no flash launch, every loss finite; each step's wall,
              tokens/s, the model FLOPs of a step, peak memory and the
              loss curve printed.
 19. grad_sync the ring all-reduce (repro_torch.dist.collectives.
              seqbalance_all_reduce over a LocalAxis: every member a row
              of one tensor on the card): rings of 2, 4 and 8 members on
              the float32, bfloat16 and int8 wires under three plans (the
              default (1, -1), one path quarantined, a PinnedPlan from
              replan_chunk_paths), GRAD_SYNC_MEMBER entries a member, each
              against the port's CPU run and the JAX package's sampled
              outputs (src/repro_torch/dist/grad_sync_reference.json) bit
              for bit, within its wire's error of the exact sum, and
              2 (n - 1) rounds a chunk (collectives.permute_rounds); then
              gemma2-2b's embedding gradient (256,000 x 2,304, float32) at
              2 and 4 members, the ring and baseline_all_reduce timed
              against the bytes bound;
 20. train_sync_ref GRAD_SYNC_CASE: phase 17's case at B 4 through the pod
              step (launch.steps.make_train_step on a pod mesh,
              "seqbalance", 4 chunks) over 2 pods on the float32 and the
              int8 wire, and at REDUCED width over 4 pods on the int8
              wire, each against the JAX package's pod step on forced
              host devices (grad_sync_reference.json) within TRAIN_TOL
              (its norms only on the int8 wire: grad_sync_limits), with
              the rounds the ring ran; the float32-wire run's loss
              also against the port's single-device step on the same
              batches;
 21. train_sync gemma2-2b as published over 2 pods on the card
              (TRAIN_SYNC_ARGV: phase 18's run with --grad-sync
              seqbalance --pods 2, 5 steps, one row a member): every loss
              finite, step 0's loss within phase 17's bfloat16 loss limit
              of phase 18's, the [cosim] lines and plan the JAX driver's,
              the ring's rounds; step walls, tokens/s, the grad sync's
              synchronized share of a step and the peak memory printed.
 22. dryrun   repro_torch.launch.dryrun on both production meshes (16 x 16
              and 2 x 16 x 16, this process one rank of a fake group of
              256 or 512) for DRYRUN_CELLS (gemma2-2b train_4k,
              prefill_32k and decode_32k, deepseek-moe-16b train_4k,
              recurrentgemma-9b train_4k, xlstm-1.3b prefill_32k: its
              sLSTM loop traced one step and counted for all,
              qwen3-32b prefill_32k), on
              fake tensors on "cuda" (nothing allocated on the card:
              checked), against the JAX package's run_cell of the same
              cells (src/repro_torch/launch/dryrun_reference.json): each
              record's argument bytes equal to the count from shapes,
              specs and dtypes and the JAX package's to its own layout's
              (so the two differ by the listed stacked-dim leaves alone),
              every cell's FLOPs (less the flash kernel's) within
              DRYRUN_FLOPS_LIMIT of the JAX package's (qwen3-32b
              prefill_32k's, whose JAX count XLA takes from one layer,
              within DRYRUN_PREFILL_RECKONING_LIMIT of the model's own
              count, prefill_flops, instead), an MoE train
              cell's within DRYRUN_MOE_RECKONING_LIMIT of the model's own
              count (train_flops) a device, printed for every train cell;
              a prefill cell's flash FLOPs on rank 0 and on its last
              rank (traced apart) within DRYRUN_FLASH_LIMIT of the
              model's own attention count (attention_flops) a device;
              every cell's collective bytes within DRYRUN_COLL_LIMIT of
              the JAX package's coll_x; every cell's collective
              ratio beside its FLOPs ratio, and its peak beside the
              card's memory, printed; every cell's peak within the
              card's memory less SHARD_RANK_MARGIN; peak and
              collective bytes by kind printed beside the JAX package's;
              each trace's wall printed;
 23. shard_rank one rank of gemma2-2b train_4k as published at the 16 x 16
              sharding (the FSDP + TP step of launch.steps on DTensors
              over a fake group of 256: real tensors on the card, the
              collectives moving nothing), remat "dots", 3 steps: each
              step's wall (one rank's compute, communication left out),
              torch.cuda.max_memory_allocated of the steps beside phase
              22's peak_bytes of that cell and the card's memory (it must
              fit), the launches by kernel; its loss is not checked (the
              fake collectives leave garbage in it).  Then the same for
              each train_4k cell of SHARD_RANK_ARCHS (deepseek-moe-16b,
              then recurrentgemma-9b; 16 x 16, 2 x 16 x 16) whose
              phase-22 peak leaves SHARD_RANK_MARGIN of the card free (a
              line with the excess for one that does not), the rank's
              masters built leaf by leaf (rank_params: deepseek's whole
              float32 masters are 66 GB).  Then rank 0 of qwen3-32b
              prefill_32k at 16 x 16 (SHARD_RANK_PREFILL; its masters
              131 GB whole, built leaf by leaf): one prefill step, its
              cache made as shards and its flash attention split by the
              query heads, its peak memory within
              SHARD_RANK_PREFILL_SLACK of phase 22's count and under the
              card's, the flash kernel launched.
 24. examples the examples' twins as their CLIs run on the card
              (EXAMPLES_REFERENCE, written from the JAX examples' own code
              path on the CPU): repro_torch.examples.simulate_datacenter,
              default and --elephants, the five schemes' FCT stats at
              GATES and the tiered kernel launched; serve_decode for
              EXAMPLES_DECODE_ARCHS, its tokens equal to a plain-attention
              run on the same weights up to each row's first near-tie and
              the float32 flash kernel (simt) launched; quickstart's lines
              the JAX example's; and, run inside phase 11 on the flight
              log it writes, repro_torch.obs.report with an epoch row for
              each of its epochs.

Phases 1, 2 and 6 run first, alone on the card.  The others but 21 and
23 run in the six processes of WORKERS at once, on the same card
(python3 chip_smoke.py --worker NAME): the simulator's steps are host
work on a device that idles most of a step (phase 6), so their walls
overlap; phase 22 traces on the host alone, in two of them
(DRYRUN_SPLIT).  Phases 12-15 and 17-20 load
the card and share one process, one model at a time.  Phases 21 and 23
run last, in that order, in a process of their own (LAST_WORKERS): each
holds most of the card.  Each process runs its
phases in order, prints their lines and, last, a {"worker": ...} line
with the launch counts of each phase (set to 0 before the phase, read
after it); the script prints each worker's lines once all have ended.
Their walls are taken with the others running.

Each phase's wall is printed after it.  Then a "kernels" line and, last,
{"ok": true, "device": {...}}.  Any failure exits non-zero before that
line, and stops the workers still running; so does a machine without
CUDA or a directory without the repository.

With --cluster-sweep it runs only the measurement behind
kernels/cascade_common.py::cluster_size instead: the three cluster
kernels (tiered and flat cascades, linkload) at each of their phase 2
shapes launched on clusters of 1, 2, 4, 8 and 16 CTAs through the
library's C entry (past the wrapper, so these launches are not counted;
timed as phase 2's "ms"), each held against the plain version, with the card's cluster occupancy
for each size, the size cluster_size picks and the fastest.

With --planted-faults DIR it shows what the serving checks catch: for
each fault of PLANTED it copies this checkout to DIR/<fault>, plants the
fault in the copy's csrc/flash_attention_sm90.cu, and runs there phase
2's bf16 serving rows, phase 12 and phase 13, printing what each check
read against its limit; it fails if a fault passes every check.  DIR
must lie outside the checkout.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np

START = time.time()
ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = "cuda"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense bf16 on the tensor cores
# tests/test_netsim_compact.py:182-185, in the order arrival, queue, mark, thr
TOLS = ({"rtol": 2e-5, "atol": 1e-3}, {"rtol": 1e-4, "atol": 1.0},
        {"rtol": 0.0, "atol": 1e-6}, {"rtol": 2e-5, "atol": 1e-2})
OUTPUTS = ("arrival", "queue", "mark", "thr")
# agreement gates against the JAX package's fig12 stats (see PERF.md)
GATES = {"completion_rate": 1e-3, "avg_slowdown": 5e-3, "p99_slowdown": 2e-2}
FIG12_SCHEMES = ("drill", "ecmp", "seqbalance", "letflow", "conga")
FIG12_CASES = [(wl, load) for wl in ("alistorage", "websearch") for load in (0.5, 0.8)]
# the dense oracle (phase 5) runs the alistorage cases, the largest, alone:
# phases 7 and 8 took its time for the websearch ones
DENSE_CASES = 2
# the target of ROADMAP.md for the port against the oracle, reported beside the gates
TARGET = 1e-4
# tests/test_kernels.py: flash attention fp32 2e-5, with a softcap 3e-5, bf16 2e-2
FLASH_TOL = {"float32": 2e-5, "float32_softcap": 3e-5, "bfloat16": 2e-2}
# the largest ||got - want|| / ||want|| of an output row: bf16 output rounding
# alone gives up to about 2e-3; the kernel's float32 arithmetic adds little
FLASH_ROW_REL = {"bfloat16": 1e-2, "float32": 1e-4}
# tests/test_kernels.py::test_linkload_sweep, in the order load, queue, mark
LINKLOAD_TOLS = ({"rtol": 1e-5, "atol": 0.0}, {"rtol": 1e-4, "atol": 1.0},
                 {"rtol": 0.0, "atol": 1e-6})
KW = dict(kmin=400e3, kmax=1600e3, pmax=0.2, dt=10e-6)


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = 20, rounds: int = 7, warmup: int = 5) -> float:
    """Per-call time: CUDA events around ``reps`` back-to-back calls, the
    median over ``rounds``, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def kernel_ms(launch, reps: int = 20, rounds: int = 7, warmup: int = 5) -> float:
    """Per-launch time of a kernel alone: ``reps`` back-to-back calls of
    ``launch`` (one launch through the library's C entry each) captured
    in a CUDA graph, whose replays time_ms times, so that the host's work
    per launch (the ctypes call, the launch API) does not set the pace."""
    import torch

    graph = torch.cuda.CUDAGraph()
    # relaxed: a launch sets its kernel's attributes, which global capture refuses
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            launch()
    return time_ms(graph.replay, reps=1, rounds=rounds, warmup=warmup) / reps


def kernel_wrappers():
    """name -> the wrapper that counts the kernel's launches."""
    from repro_torch.kernels import cascade_tiered as ct, flash_attention as fa, linkload as ll

    return {"cascade_tiered": ct.cascade_tiered, "cascade_flat": ll.linkload_cascade,
            "linkload": ll.linkload, "flash_attention": fa.flash_attention}


def tallies() -> dict:
    """name -> the launch counts a wrapper keeps by route or cluster size."""
    from repro_torch.kernels import cascade_tiered as ct, flash_attention as fa, linkload as ll

    return {"cascade_tiered": ct.cascade_tiered.cluster_launches,
            "cascade_flat": ll.linkload_cascade.cluster_launches,
            "linkload": ll.linkload.cluster_launches,
            "flash_attention": fa.flash_attention.route_launches}


def reset_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0
    for t in tallies().values():
        for key in t:
            t[key] = 0


def read_counts() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items()}


def read_tallies() -> dict:
    return {k: {key: n for key, n in t.items() if n} for k, t in tallies().items()}


def close_enough(name: str, outs, got, want, tols) -> dict:
    """Max abs error per output; fails unless |got - want| <= atol + rtol |want|."""
    errs = {}
    for out, g, w, tol in zip(outs, got, want, tols):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        errs[out] = float(err.max())
        ok = bool((err <= tol["atol"] + tol["rtol"] * w.abs()).all())
        check(ok, f"{name}: {out} disagrees (max abs err {errs[out]}, tolerance {tol})")
    return errs


def card_name() -> str:
    """nvidia-smi's name and power limit of the first card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def load_kernels() -> None:
    from repro_torch.kernels import build

    for k in build.KERNELS:
        build.load(k)


def phase_device():
    from repro_torch.kernels import build

    card = card_name()
    print(card, flush=True)
    t0 = time.time()
    missing = [k for k in build.KERNELS if not build.library_path(k).exists()]
    build.build_many(build.KERNELS)  # one nvcc per source, all at once
    load_kernels()
    emit({"phase": "device", "nvidia_smi": card, "build_s": time.time() - t0,
          "built": missing})


def kernel_inputs(topo, B: int, W: int, N: int, seed: int, absent_frac: float = 0.0):
    """Random inputs for the cascade at the given shapes, from numpy."""
    import torch

    from repro_torch.netsim import dataplane

    rng = np.random.default_rng(seed)
    dev = topo.device
    src = rng.integers(0, topo.n_hosts, (B, W))
    dst = (src + 1 + rng.integers(0, topo.n_hosts - 1, (B, W))) % topo.n_hosts
    path = rng.integers(0, topo.n_paths, (B, W, N))
    hpl = topo.hosts_per_leaf
    fab = topo.fabric_links(torch.as_tensor(src // hpl)[..., None],
                            torch.as_tensor(dst // hpl)[..., None], torch.as_tensor(path))
    if absent_frac:
        drop = torch.as_tensor(rng.random(tuple(fab.shape)) < absent_frac, device=dev)
        fab = torch.where(drop, torch.full_like(fab, -1), fab)
    tx, rx = topo.nic_links(src, dst)
    rates = torch.as_tensor(rng.uniform(0, 50e9, (B, W, N)), dtype=torch.float32, device=dev)
    queue = torch.as_tensor(rng.uniform(0, 2e6, (B, topo.n_links + 1)),
                            dtype=torch.float32, device=dev)
    return (fab.contiguous(), tx.contiguous(), rx.contiguous(), rates, queue,
            topo.capacity, dataplane.queue_mask_for(topo))


def flat_layout(args):
    """The tiered inputs' routes in the flat layout: lid [B, W * N, Hf + 2]
    of [host_tx, fabric hops..., host_rx] per sub-flow, rates [B, W * N]."""
    import torch

    fab, tx, rx, rates, queue, cap, qmask = args
    B, W, N, hf = fab.shape
    lid = torch.cat([tx[:, :, None, None].expand(B, W, N, 1), fab,
                     rx[:, :, None, None].expand(B, W, N, 1)], -1)
    return (lid.reshape(B, W * N, hf + 2).contiguous(), rates.reshape(B, W * N).contiguous(),
            queue, cap, qmask)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float, flop_per_s: float = FP32_FLOP_PER_S):
    """Least time in ms for one call on an H100: the bytes each input read
    once and each output written once at the HBM rate, against the
    operations at the peak for their type; the larger wins."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tiered_bound(case):
    fab, tx, rx, rates, queue, cap, qmask = case.args
    B, W, N, hf = fab.shape
    L1 = queue.shape[-1]
    # per sub-flow: the tx/rx adds and multiplies plus an add and a multiply
    # per fabric hop; per link and pass: max, divide, min and the arrival
    # add; per link once: the queue update and the RED ramp (about 10)
    ops = B * (W * N * (4 + 2 * hf) + L1 * (4 * (hf + 2) + 10))
    return bound(nbytes(*case.args) + 3 * B * L1 * 4 + rates.numel() * 4, ops)


def flat_bound(case):
    lid, rates, queue, cap, qmask = case.args
    B, n, H = lid.shape
    L1 = queue.shape[-1]
    # per sub-flow and hop an add and a multiply; per link and hop max,
    # divide, min and the arrival add; per link once about 10
    ops = B * (n * 2 * H + L1 * (4 * H + 10))
    return bound(nbytes(*case.args) + 3 * B * L1 * 4 + rates.numel() * 4, ops)


def linkload_bound(case):
    lid, rates, queue, cap = case.args
    L = queue.shape[0]
    return bound(nbytes(*case.args) + 3 * L * 4, lid.numel() + 10 * L)


def flash_pairs(S: int, causal: bool, window: int, Sk: int | None = None,
                q_offset: int = 0) -> int:
    """(query, key) pairs that the mask keeps, in one head: S query rows at
    positions ``q_offset`` on against ``Sk`` keys (S where not given)."""
    Sk = S if Sk is None else Sk
    i = q_offset + np.arange(S)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, np.int64)
    hi = np.minimum(i + 1, Sk) if causal else np.full(S, Sk)
    return int((hi - lo).sum())


def flash_bound(case):
    """Two products of 2 * hd operations per kept (query, key) pair, at
    the bf16 tensor-core peak for bf16 inputs and the float32 peak
    (outside the tensor cores) for float32 inputs."""
    import torch

    q, k, v = case.args
    B, S, H, hd = q.shape
    ops = 4 * hd * B * H * flash_pairs(S, case.kw["causal"], case.kw.get("window", 0),
                                       k.shape[1], case.kw.get("q_offset", 0))
    bf16 = q.dtype == torch.bfloat16
    ms, by = bound(nbytes(q, k, v, q), ops, BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)
    return ms, by, "bf16 tensor-core peak" if bf16 else "float32 non-tensor peak", ops


class Case(NamedTuple):
    """One input of a kernel."""

    name: str
    args: tuple  # to the kernel and its plain version, with kw
    kw: dict
    info: dict  # shapes, into the printed row
    main: bool = False  # the entry point is driven here; the "kernels" line reports it
    aux: object = None  # whatever a further check needs
    library: str = ""  # the csrc library that serves the case, where a kernel has several
    ran_as: object = None  # the key the wrapper's tally must show for the case


class Spec(NamedTuple):
    """A kernel as phase 2 drives it."""

    name: str  # its wrapper's key in kernel_wrappers() and its csrc/<name>.cu
    replaces: tuple  # (the JAX function, "file:line" of the TPU kernel)
    kernel: Callable  # the wrapper, which counts its launches
    plain: Callable  # its plain PyTorch version
    outputs: tuple  # the names of its outputs
    tols: Callable  # case -> one {"rtol", "atol"} per output
    cases: Callable  # () -> [Case], built on the card when the phase reaches it
    bound: Callable  # case -> (ms, "bytes" | "operations"[, the peak used, operations])
    # (name, case -> None): the entry point, driven once at the main case
    # with the counts at 0; None where the sweep is the entry point
    entry: tuple | None = None
    # case -> None, or (its name, a no-argument call, more row fields): one
    # PyTorch call that computes the same function, held against the plain
    # version at the case's tolerance and timed beside the kernel if it holds
    library: Callable | None = None
    more: Callable | None = None  # (case, got, want) -> more row fields; fails itself
    reps: tuple = ({}, {})  # time_ms's keywords: the kernel's, the plain version's
    # the row field for the key of the wrapper's tally (tallies()) that a
    # launch moved: "route" or "C"; None where the wrapper keeps no tally
    ran_as: str | None = None
    # (case, preallocated outputs, C) -> a no-argument call that launches the
    # kernel once through its library's C entry, past the wrapper (so not
    # counted): what the "ms" column times; C is the cluster size, None for
    # a kernel without clusters
    launch: Callable | None = None
    # case -> the cluster size the wrapper asks for; None without clusters
    cluster: Callable | None = None
    # the kernel's sums do not depend on the order of their additions: a
    # second launch on the same inputs must give bitwise-equal outputs
    repeats: bool = False


def cascade_shapes():
    """(name, topology, B, W, N, share of absent fabric hops, main)."""
    import torch

    from repro_torch.netsim import topology

    dev = torch.device(DEVICE)
    return [
        ("fig12", topology.sim_2tier(device=dev), 2, 5376, 4, 0.0, True),
        ("three_tier", topology.three_tier(device=dev), 2, 2048, 4, 0.0, False),
        ("ragged", topology.sim_2tier(device=dev), 3, 1000, 4, 0.1, False),
        # what the dense engine gives the kernel: every flow of the fig12
        # alistorage 0.8 trace in one simulation
        ("dense", topology.sim_2tier(device=dev), 1, 56116, 4, 0.0, False),
    ]


def tiered_cases():
    return [Case(name, kernel_inputs(topo, B, W, N, seed=i, absent_frac=absent),
                 dict(KW, qmax_bytes=8e6),
                 {"B": B, "W": W, "N": N, "Hf": topo.n_fabric_hops, "links": topo.n_links},
                 main)
            for i, (name, topo, B, W, N, absent, main) in enumerate(cascade_shapes())]


def flat_cases():
    """The tiered cases' routes in the flat layout; ``aux`` keeps the
    tiered inputs so that the tiered kernel is held against the flat one."""
    cases = []
    for c in tiered_cases():
        args = flat_layout(c.args)
        cases.append(c._replace(args=args, aux=c.args, info={
            "B": c.info["B"], "n": int(args[0].shape[1]), "H": int(args[0].shape[2]),
            "links": c.info["links"], "absent_hops": int((args[0] < 0).sum())}))
    return cases


def tiered_vs_flat(case, got, want):
    from repro_torch.kernels import cascade_tiered as ct

    B = case.info["B"]
    tiered = ct.cascade_tiered(*case.aux, **case.kw)
    return {"tiered_vs_flat_max_abs_err": close_enough(
        f"tiered vs flat {case.name}", OUTPUTS, tiered[:3] + (tiered[3].reshape(B, -1),),
        got, TOLS)}


def linkload_cases():
    """linkload at bench_kernels' shapes (ids in [-1, L)) and at the fig12
    flat shape (the first simulation's routes, with -1 and ids past L
    mixed in)."""
    import torch

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(12)
    n, L = 8192, 512
    bench = (rng.integers(-1, L, (n, 6)), rng.uniform(0, 1e9, n), np.zeros(L),
             np.full(L, 1e11))
    name, topo, B, W, N, absent, _ = cascade_shapes()[0]
    flat = flat_layout(kernel_inputs(topo, B, W, N, seed=0))
    lid = flat[0][0].cpu().numpy().copy()
    L12 = topo.n_links
    lid[rng.random(lid.shape) < 0.05] = -1
    lid[rng.random(lid.shape) < 0.01] = L12 + 3
    fig12 = (lid, flat[1][0].cpu().numpy(), rng.uniform(0, 2e6, L12), np.full(L12, 1e11))
    cases = []
    for name, raw in (("bench_kernels", bench), ("fig12_flat", fig12)):
        args = tuple(torch.as_tensor(a, dtype=d, device=dev).contiguous() for a, d in
                     zip(raw, (torch.int32, torch.float32, torch.float32, torch.float32)))
        cases.append(Case(name, args, dict(KW), {
            "n": int(args[0].shape[0]), "hops": int(args[0].shape[1]),
            "links": int(args[2].shape[0])}, main=name == "fig12_flat"))
    return cases


# full widths of the repo's configurations (src/repro/configs/), the
# factor q is scaled by (see flash_cases) and the route that must serve each;
# the serving phases' shapes: phase 13's prefill (gemma2-2b, 4 prompts
# padded to 5,120) for a local layer and for a global one (softcap, no
# window), the local one at a length that is not a multiple of a block, and
# phase 12's float32 prefill (2 prompts padded to 600, window 256); the
# local serving shapes are the main cases (the "kernels" line)
GEMMA2_LOCAL = dict(causal=True, window=4096, softcap=50.0)
FLASH_CASES = [
    ("qwen3-32b", 1, 4096, 64, 8, 128, "bfloat16", dict(causal=True), 10.0, "wgmma"),
    ("gemma2-2b", 1, 8192, 8, 4, 256, "bfloat16", GEMMA2_LOCAL, 10.0, "wgmma"),
    ("gemma2-2b-serve", 4, 5120, 8, 4, 256, "bfloat16", GEMMA2_LOCAL, 10.0, "wgmma"),
    ("gemma2-2b-serve-global", 4, 5120, 8, 4, 256, "bfloat16",
     dict(causal=True, softcap=50.0), 10.0, "wgmma"),
    ("gemma2-2b-ragged", 4, 4999, 8, 4, 256, "bfloat16", GEMMA2_LOCAL, 10.0, "wgmma"),
    ("float32", 1, 2048, 16, 4, 128, "float32", dict(causal=True), 1.0, "simt"),
    ("gemma2-2b-serve-ref", 2, 600, 8, 4, 256, "float32",
     dict(causal=True, window=256, softcap=50.0), 3.0, "simt"),
    # phase 15's prefills: deepseek-moe-16b's (MHA, a group of 1) and
    # recurrentgemma-9b's local layers (MQA, a group of 16, window 2,048);
    # phase 14's bfloat16 granite-moe-3b-a800m (hd 64 at B > 1, a group
    # of 3)
    ("deepseek-moe-16b-serve", 4, 4096, 16, 16, 128, "bfloat16", dict(causal=True), 10.0,
     "wgmma"),
    ("recurrentgemma-9b-serve", 4, 3072, 16, 1, 256, "bfloat16",
     dict(causal=True, window=2048), 10.0, "wgmma"),
    ("granite-moe-3b-a800m-ref", 2, 600, 24, 8, 64, "bfloat16", dict(causal=True), 10.0,
     "wgmma"),
    # a query block at an offset (S = (its rows, the keys)), as the sharded
    # prefill runs the flash kernel where the heads do not split over
    # "model" at 16: gemma2-2b prefill_32k's last of 32 blocks (rank 0's
    # second, its local layers), qwen3-32b's head split (4 query heads on
    # one KV head) at a block of 8,192 keys, and phase 12's float32 shape
    ("gemma2-2b-offset", 2, (1024, 32768), 8, 4, 256, "bfloat16",
     dict(GEMMA2_LOCAL, q_offset=31744), 10.0, "wgmma"),
    ("qwen3-32b-heads-offset", 2, (2048, 8192), 4, 1, 128, "bfloat16",
     dict(causal=True, q_offset=6144), 10.0, "wgmma"),
    ("gemma2-2b-offset-ref", 2, (300, 1200), 8, 4, 256, "float32",
     dict(causal=True, window=256, softcap=50.0, q_offset=600), 3.0, "simt"),
]
FLASH_MAIN = ("gemma2-2b-serve", "gemma2-2b-serve-ref")
FLASH_LIBRARY = {"wgmma": "flash_attention_sm90", "simt": "flash_attention"}


def flash_cases():
    """In bf16 q is scaled by 10, so the scores have a standard deviation
    of about 10 and reach the softcap's range: each row's softmax is
    peaked on a few keys and the outputs are of order 1, against which a
    bf16 limit means something.  The float32 case keeps unscaled scores:
    its elementwise limit (2e-5) is already 1e-3 of its typical output of
    0.05, and at scores of deviation 10 the float32 rounding of the scores
    alone moves an output by about 3e-5 (the plain version against
    float64), past that limit for any float32 kernel.  The float32 case
    with a softcap scales q by 3: at unit scores the softcap of 50 moves a
    row by about 1e-4, too little to show a kernel that drops it."""
    import torch

    dev = torch.device(DEVICE)
    cases = []
    for name, B, S, H, K, hd, dtype, kw, q_scale, route in FLASH_CASES:
        dt = getattr(torch, dtype)
        Sq, S = S if isinstance(S, tuple) else (S, S)
        g = torch.Generator(device=dev).manual_seed(S + H + kw.get("q_offset", 0))
        q, k, v = (torch.randn((B, n, h, hd), generator=g, device=dev)
                   for n, h in ((Sq, H), (S, K), (S, K)))
        cases.append(Case(name, ((q * q_scale).to(dt), k.to(dt), v.to(dt)),
                          dict(kw, window=kw.get("window", 0), softcap=kw.get("softcap", 0.0)),
                          {"dtype": dtype, "B": B, "S": S, "H": H, "K": K, "hd": hd,
                           "q_scale": q_scale, **({"Sq": Sq} if Sq != S else {})},
                          main=name in FLASH_MAIN,
                          library=FLASH_LIBRARY[route], ran_as=route))
    return cases


def flash_tols(case):
    dtype = case.info["dtype"]
    tol = FLASH_TOL[dtype + ("_softcap" if dtype == "float32" and case.kw["softcap"] else "")]
    return ({"rtol": tol, "atol": tol},)


def row_rel_err(got, want) -> float:
    """The largest ||got - want|| / ||want|| over the output rows (one
    query of one head)."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())


def flash_rows(case, got, want):
    """Each output row within FLASH_ROW_REL of the plain version's; and
    the plain version itself with the window one 64-key block short, or
    without the softcap, outside that limit, so that a kernel with either
    fault would fail here."""
    from repro_torch.kernels import flash_attention as fa

    limit = FLASH_ROW_REL[case.info["dtype"]]
    err = row_rel_err(got[0], want[0])
    check(err <= limit, f"flash_attention {case.name}: a row is {err} off (limit {limit})")
    faults = {}
    if case.kw.get("q_offset"):
        faults["offset 0"] = dict(case.kw, q_offset=0)
    if case.kw["window"]:
        faults["window one block short"] = dict(case.kw, window=case.kw["window"] - 64)
    if case.kw["softcap"]:
        faults["no softcap"] = dict(case.kw, softcap=0.0)
    seen = {}
    for what, kw in faults.items():
        seen[what] = row_rel_err(fa.flash_attention_torch(*case.args, **kw), want[0])
        check(seen[what] > limit, f"flash_attention {case.name}: {what} is only "
              f"{seen[what]} off, inside the limit {limit}")
    return {"row_rel_err": err, "row_rel_limit": limit, "faults_row_rel_err": seen}


def sdpa_call(case):
    """F.scaled_dot_product_attention in the kernel's layout, where it
    computes the same function: no softcap, no window; float32 products in
    full float32.  Where a softcap (gemma2-2b) rules it out, for the serving
    shapes of FLEX_CASES, ``flex_call``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    if case.name in FLEX_CASES:
        return flex_call(case)
    if case.kw["softcap"] or case.kw["window"]:
        return None
    qt, kt, vt = (x.transpose(1, 2) for x in case.args)
    off = case.kw.get("q_offset", 0)
    if off:  # the block's rows of the causal mask
        import torch

        Sq, Sk = qt.shape[2], kt.shape[2]
        mask = (torch.arange(Sk, device=qt.device)[None, :]
                <= off + torch.arange(Sq, device=qt.device)[:, None])
        kw, label = dict(attn_mask=mask), "F.scaled_dot_product_attention(attn_mask, enable_gqa)"
    else:
        kw = dict(is_causal=case.kw["causal"])
        label = "F.scaled_dot_product_attention(is_causal, enable_gqa)"

    def sdpa():
        with fa.full_fp32_matmul():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                  **kw).transpose(1, 2)
    return label, sdpa, {}


# the flash rows with a softcap that phases 12-13 serve (gemma2-2b's local
# and global prefill layers in bf16, phase 12's float32 prefill), where
# torch.nn.attention.flex_attention is the one library call
FLEX_CASES = ("gemma2-2b-serve", "gemma2-2b-serve-global", "gemma2-2b-serve-ref")


def flex_call(case):
    """``flex_attention`` compiled (torch.compile, the shapes static) with a
    tanh softcap ``score_mod``, a causal-plus-window ``block_mask`` and
    ``enable_gqa``, in the kernel's layout, float32 products in full
    float32; the compile (its first call) timed apart.  A compile that
    fails gives no call: the reason is printed in its place."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.transpose(1, 2).contiguous() for x in case.args)
    S, hd = q.shape[2], q.shape[3]
    cap, window = case.kw["softcap"], case.kw["window"]

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def causal_window(b, h, qi, ki):
        keep = ki <= qi
        return keep & (qi - ki < window) if window else keep

    label = (f"flex_attention(score_mod=softcap {cap}, block_mask=causal"
             f"{f' window {window}' if window else ''}, enable_gqa) compiled")
    compiled = torch.compile(flex_attention, dynamic=False)
    mask = create_block_mask(causal_window, None, None, S, S, device=DEVICE)

    def flex():
        with fa.full_fp32_matmul():
            return compiled(q, k, v, score_mod=softcap, block_mask=mask, enable_gqa=True,
                            scale=hd ** -0.5).transpose(1, 2)
    t0 = time.time()
    try:
        flex()
        torch.cuda.synchronize()
    except Exception as e:  # a library's compiler refusing the shape: reported, not timed
        return label, None, {"library_compile_error": f"{type(e).__name__}: {str(e)[:300]}"}
    return label, flex, {"library_compile_s": time.time() - t0}


def c_entry(library: str, fn: str, argtypes: tuple, tensors, ints, floats):
    """A no-argument call that launches ``fn`` of ``csrc/<library>.cu``
    once on the current stream with these tensors' pointers and these
    numbers, and raises on a CUDA error."""
    import torch

    from repro_torch.kernels import build

    entry = build.entry(library, fn, argtypes)
    args = (*(t.data_ptr() for t in tensors), *ints, *floats)

    def launch():
        build.raise_on(entry(*args, torch.cuda.current_stream().cuda_stream), library)
    return launch


CASCADE_FLOATS = ("kmin", "kmax", "pmax", "dt", "qmax_bytes")


def tiered_cluster(case) -> int:
    from repro_torch.kernels import cascade_tiered as ct

    fab, tx, rx, rates, queue, cap, qmask = case.args
    B, W, N = rates.shape
    return ct.cluster_size(W, N, queue.shape[-1])


def tiered_launch(case, outs, C):
    from repro_torch.kernels import cascade_tiered as ct

    fab = case.args[0]
    B, W, N, hf = fab.shape
    return c_entry("cascade_tiered", "cascade_tiered_launch", ct._ARGTYPES, (*case.args, *outs),
                   (B, W, N, hf, case.args[4].shape[-1], C),
                   [case.kw[k] for k in CASCADE_FLOATS])


def flat_cluster(case) -> int:
    from repro_torch.kernels import cascade_common as cc

    lid, rates, queue, cap, qmask = case.args
    return cc.cluster_size(lid.shape[1], 1, queue.shape[-1])


def flat_launch(case, outs, C):
    from repro_torch.kernels import linkload as ll

    lid, rates, queue, cap, qmask = case.args
    B, n, H = lid.shape
    return c_entry("cascade_flat", "cascade_flat_launch", ll._CASCADE_ARGTYPES,
                   (*case.args, *outs), (B, n, H, queue.shape[-1], C),
                   [case.kw[k] for k in CASCADE_FLOATS])


def linkload_cluster(case) -> int:
    from repro_torch.kernels import cascade_common as cc

    lid, rates, queue, cap = case.args
    return cc.cluster_size(lid.shape[0], lid.shape[1], queue.shape[0])


def linkload_launch(case, outs, C):
    from repro_torch.kernels import linkload as ll

    lid, rates, queue, cap = case.args
    n, hops = lid.shape
    return c_entry("linkload", "linkload_launch", ll._LINKLOAD_ARGTYPES, (*case.args, *outs),
                   (n, hops, queue.shape[0], C),
                   [case.kw[k] for k in ("kmin", "kmax", "pmax", "dt")])


def flash_launch(case, outs, C=None):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = case.args
    B, S, H, hd = q.shape
    route = fa.flash_route(q.dtype, hd)
    lib, fn, argtypes = fa._ENTRIES[route]
    dtype = () if route == "wgmma" else (fa._DTYPES[q.dtype],)
    return c_entry(lib, fn, argtypes, (q, k, v, *outs),
                   (*dtype, B, S, k.shape[1], case.kw.get("q_offset", 0), H, k.shape[2], hd,
                    int(case.kw["causal"]), case.kw["window"]),
                   (float(case.kw["softcap"]), hd ** -0.5))


def kernel_specs():
    from repro_torch.kernels import cascade_tiered as ct, flash_attention as fa
    from repro_torch.kernels import linkload as ll, ops
    from repro_torch.netsim import dataplane

    cascade_tols = lambda case: TOLS  # noqa: E731
    LL = "src/repro/kernels/linkload.py"
    return [
        Spec("cascade_tiered", ("linkload_cascade_tiered", f"{LL}:288"),
             ct.cascade_tiered, ct.cascade_tiered_torch, OUTPUTS,
             cascade_tols, tiered_cases, tiered_bound, ran_as="C",
             launch=tiered_launch, cluster=tiered_cluster, repeats=True),
        Spec("cascade_flat", ("linkload_cascade", f"{LL}:372"),
             ll.linkload_cascade, ll.linkload_cascade_torch, OUTPUTS,
             cascade_tols, flat_cases, flat_bound,
             entry=("dataplane.cascade(backend='cuda')",
                    lambda c: dataplane.cascade(*c.args, n_links=c.info["links"],
                                                backend="cuda", **c.kw)),
             more=tiered_vs_flat, ran_as="C", launch=flat_launch, cluster=flat_cluster,
             repeats=True),
        Spec("linkload", ("linkload", f"{LL}:61"),
             ll.linkload, ll.linkload_torch, ("load", "queue", "mark"),
             lambda case: LINKLOAD_TOLS, linkload_cases, linkload_bound,
             entry=("ops.linkload",
                    lambda c: ops.linkload(*c.args, n_links=c.info["links"], **c.kw)),
             ran_as="C", launch=linkload_launch, cluster=linkload_cluster, repeats=True),
        Spec("flash_attention", ("flash_attention", "src/repro/kernels/flash_attention.py:75"),
             fa.flash_attention, fa.flash_attention_torch, ("out",),
             flash_tols, flash_cases, flash_bound,
             entry=("ops.flash_attention", lambda c: ops.flash_attention(*c.args, **c.kw)),
             library=sdpa_call,
             more=flash_rows,
             reps=(dict(reps=5, rounds=5, warmup=2), dict(reps=2, rounds=3, warmup=1)),
             ran_as="route", launch=flash_launch),
    ]


def kernel_row(spec: Spec, case: Case) -> dict:
    """The kernel against its plain version at one case, both timed, and
    at the main case its entry point driven with the counts at 0."""
    import torch

    def run(fn):
        out = fn(*case.args, **case.kw)
        return out if isinstance(out, tuple) else (out,)

    path = {}
    if case.main and spec.entry:
        where, drive = spec.entry
        reset_counts()
        drive(case)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts[spec.name] == 1 and sum(counts.values()) == 1,
              f"{where} launched {counts}")
        path = {"path": where, "path_launches": counts[spec.name],
                "path_tally": read_tallies().get(spec.name)}
        check(case.ran_as is None or path["path_tally"] == {case.ran_as: 1},
              f"{where} at {case.name} ran as {path['path_tally']}, not {case.ran_as}")
    tally = tallies().get(spec.name)
    before = dict(tally or {})
    got = run(spec.kernel)
    repeat = {}
    if spec.repeats:
        again = run(spec.kernel)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        check(same, f"{spec.name} {case.name}: a second launch on the same inputs "
                    "gave other outputs")
        repeat = {"second_launch_bitwise_equal": same}
        del again
    ran = {}
    if spec.ran_as:
        moved = [k for k, n in tally.items() if n != before.get(k, 0)]
        check(len(moved) == 1, f"{spec.name} {case.name}: the launch moved {moved}")
        check(case.ran_as is None or moved[0] == case.ran_as,
              f"{spec.name} {case.name} ran as {moved[0]}, not {case.ran_as}")
        ran = {spec.ran_as: moved[0]}
    C = spec.cluster(case) if spec.cluster else None
    check(C is None or ran.get("C") == C,
          f"{spec.name} {case.name}: the wrapper ran on clusters of {ran.get('C')}, not {C}")
    want = run(spec.plain)
    tols = spec.tols(case)
    errs = close_enough(f"{spec.name} {case.name}", spec.outputs, got, want, tols)
    more = spec.more(case, got, want) if spec.more else {}
    # the C entry that "ms" times (replayed from a CUDA graph) and
    # "c_entry_ms" (called back to back from the host), with its outputs
    # allocated once, held against the plain version too
    outs = tuple(torch.empty_like(g) for g in got)
    launch = spec.launch(case, outs, C)
    launch()
    torch.cuda.synchronize()
    close_enough(f"{spec.name} {case.name} through the C entry", spec.outputs, outs, want, tols)
    library = {"library_ms": None}
    lib = spec.library(case) if spec.library else None
    if lib is not None:
        name, call, more_lib = lib
        library = {"library": name, **more_lib, "library_ms": None}
        if call is not None:
            out = call()
            held = bool(torch.allclose(out.float(), want[0].float(), **tols[0]))
            library.update(library_max_abs_err=float((out.float() - want[0].float()).abs().max()),
                           library_within_tol=held)
            del out
            if held:  # a call that misses the kernel's tolerance computes another function
                library["library_ms"] = time_ms(call, **spec.reps[0])
    del want, got
    ms = kernel_ms(launch, **spec.reps[0])
    c_entry = time_ms(launch, **spec.reps[0])
    wrapper = time_ms(lambda: spec.kernel(*case.args, **case.kw), **spec.reps[0])
    plain = time_ms(lambda: spec.plain(*case.args, **case.kw), **spec.reps[1])
    bound_ms, by, *peak = spec.bound(case)
    row = {"phase": "kernel", "kernel": spec.name, "case": case.name, **case.info, **ran,
           **({"library_source": f"csrc/{case.library}.cu"} if case.library else {}),
           **{k: v for k, v in case.kw.items() if k not in KW and k != "qmax_bytes"},
           "max_abs_err": errs, "tolerances": dict(zip(spec.outputs, tols)), **repeat, **more,
           "ms": ms, "c_entry_ms": c_entry, "wrapper_ms": wrapper, "plain_ms": plain,
           "bound_ms": bound_ms, "bound_by": by,
           **({"bound_peak": peak[0], "tflop_per_s": peak[1] / ms / 1e9} if peak else {}),
           **library}
    emit(row)
    torch.cuda.empty_cache()
    return dict(row, **path)


def phase_kernel() -> dict:
    """Every kernel at each of its cases; returns each kernel's main row."""
    rows = {}
    for spec in kernel_specs():
        for case in spec.cases():
            row = kernel_row(spec, case)
            if case.main:  # one per csrc library
                rows[case.library or spec.name] = dict(row, jax_name=spec.replaces[0],
                                                       replaces=spec.replaces[1])
    return rows


def fig12_traces():
    from repro_torch.netsim import topology, workloads

    topo = topology.sim_2tier(device=DEVICE)
    fabric = topo.n_leaf * topo.n_paths * 100e9
    traces = [workloads.poisson_trace(workloads.TraceConfig(
        workload=wl, load=load, duration_s=2.5e-3, n_hosts=topo.n_hosts, host_bw=100e9,
        seed=1, hosts_per_leaf=topo.hosts_per_leaf, load_base_bw=fabric))
        for wl, load in FIG12_CASES]
    return topo, traces


def phase_sweep():
    """The main path: benchmarks/paper_benches.py::bench_fig12_fct_2tier's
    fast sweep through the port's run_jobs."""
    import torch

    from repro_torch.netsim import engine, metrics, sweep

    topo, traces = fig12_traces()
    stats, expected, walls = {}, 0, {}
    reset_counts()
    for scheme in FIG12_SCHEMES:
        cfg = engine.SimConfig(scheme=scheme, duration_s=10e-3, uplink_sample_every=10)
        # the two F buckets (alistorage, websearch) as run_batch groups
        # them, one job each, so that phase 5 has the alistorage wall
        results, walls[scheme] = [], {}
        for wl, part in (("alistorage", traces[:2]), ("websearch", traces[2:])):
            t0 = time.time()
            (res, outs), = sweep.run_jobs([(topo, cfg, part)], device=DEVICE)
            torch.cuda.synchronize()
            walls[scheme][wl] = time.time() - t0
            results += res
            if wl == "alistorage":
                alistorage_outs = outs
        buckets = {}
        if scheme == "seqbalance":
            finishes = [r.finish for r in results[:2]]  # the alistorage batch
            batch_outs = alistorage_outs
        for (wl, load), trace, res in zip(FIG12_CASES, traces, results):
            s = metrics.fct_stats(res, trace, topo, 100e9)
            stats[(scheme, f"{wl}_{load}")] = s
            check(res.spill_steps == 0, f"{scheme} {wl} {load}: spill {res.spill_steps}")
            b = sweep._f_bucket(len(trace.sizes))
            buckets[b] = max(buckets.get(b, 0), res.steps)
            emit({"phase": "sweep", "scheme": scheme, "case": f"{wl}_{load}",
                  "flows": int(trace.valid.sum()), "avg_slowdown": s["avg_slowdown"],
                  "p99_slowdown": s["p99_slowdown"],
                  "completion_rate": s["completion_rate"],
                  "spill_steps": res.spill_steps, "W": res.window_slots,
                  "steps": res.steps})
        if scheme != "drill":
            expected += sum(buckets.values())
        emit({"phase": "sweep", "scheme": scheme, "wall_s": sum(walls[scheme].values()),
              "wall_s_by_workload": walls[scheme]})
    counts, by = read_counts(), read_tallies()
    launches = counts["cascade_tiered"]
    emit({"phase": "sweep", "wall_s": sum(sum(w.values()) for w in walls.values()),
          "kernel_launches": counts,
          "launches_by_route_or_cluster": by, "steps_needing_the_kernel": expected})
    check(launches >= expected > 0,
          f"cascade_tiered launched {launches} times for {expected} steps")
    return stats, (counts, by), walls, (finishes, batch_outs)


def same_outputs(a, b) -> bool:
    """Two runs' per-step outputs (StepOutputs of numpy arrays) bit for bit."""
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def phase_repeat(fig12) -> int:
    """Runs on the card repeat bit for bit: phase 3's SeqBalance alistorage
    batch (B = 2) twice more, with the recorder on (RecordSpec(ring_chunks
    =64)); the three runs' finish arrays and per-step outputs, and the two
    rings, must be bit-identical.  Returns the tiered kernel's launches."""
    import torch

    from repro_torch import obs
    from repro_torch.netsim import engine

    finishes, outs0 = fig12
    topo, traces = fig12_traces()
    cfg = engine.SimConfig(scheme="seqbalance", duration_s=10e-3, uplink_sample_every=10)
    spec = obs.RecordSpec(ring_chunks=64)
    runs, total = [], 0
    for _ in range(2):
        results, outs, wall, launched, loop = timed_run(topo, cfg, traces[:2], record=spec)
        total += check_launches("repeat", "seqbalance", launched, loop)
        runs.append((results, outs, wall))
    (r1, o1, w1), (r2, o2, w2) = runs
    rows = {}
    for i, load in enumerate((0.5, 0.8)):
        rows[f"alistorage_{load}"] = {
            "finish_equal": [bool(np.array_equal(r.finish, finishes[i])) for r in (r1[i], r2[i])],
            "outputs_equal": [same_outputs(o[i], outs0[i]) for o in (o1, o2)],
            "ring_equal": all(torch.equal(a, b) for a, b in zip(r1[i].ring, r2[i].ring))}
    emit({"phase": "repeat", "runs": 3, "wall_s": [w1, w2], "by_trace": rows})
    for name, row in rows.items():
        check(all(row["finish_equal"]) and all(row["outputs_equal"]) and row["ring_equal"],
              f"repeat {name}: three runs of one program on the card differ ({row})")
    return total


def stat_diffs(s, r) -> dict:
    return {"completion_rate": abs(s["completion_rate"] - r["completion_rate"]),
            "avg_slowdown": abs(s["avg_slowdown"] / r["avg_slowdown"] - 1.0),
            "p99_slowdown": abs(s["p99_slowdown"] / r["p99_slowdown"] - 1.0)}


def compare_stats(phase: str, stats, ref_stats, against: str) -> dict:
    """Per-cell differences of ``stats`` from ``ref_stats[(scheme, case)]``;
    fails past GATES; returns the largest of each."""
    worst = {k: 0.0 for k in GATES}
    for key, s in stats.items():
        diffs = stat_diffs(s, ref_stats[key])
        for k, v in diffs.items():
            worst[k] = max(worst[k], v)
        emit({"phase": phase, "against": against, "scheme": key[0], "case": key[1], **diffs})
    emit({"phase": phase, "against": against, "max_diff": worst, "gates": GATES,
          "target": TARGET, "target_held": all(v <= TARGET for v in worst.values())})
    for k, v in worst.items():
        check(v <= GATES[k], f"{phase}: {k} differs from {against} by {v} > {GATES[k]}")
    return worst


def reference(name: str) -> dict:
    """The JAX package's results src/repro_torch/netsim/<name>_reference.json."""
    return json.loads((SRC / "repro_torch" / "netsim" / f"{name}_reference.json").read_text())


def trajectory_stats(name: str, mode: str, trace: str) -> dict:
    """The JAX package's FCT stats of a phase 10 run: the collective's in
    adaptive_reference.json, the fig12 batch's in fig12_fast_reference.json."""
    if name == "record_ls444":
        return reference("adaptive")["cases"]["collective_ls444"]["runs"]["seqbalance"][mode][
            "collective"]
    return reference_stats()[1][("seqbalance", trace)]


def reference_stats():
    ref = reference("fig12_fast")
    return ref, {(scheme, case): r for scheme, cases in ref["stats"].items()
                 for case, r in cases.items()}


def phase_agree(stats):
    ref, ref_stats = reference_stats()
    emit({"phase": "agree", "reference_commit": ref["commit"],
          "reference_backend": ref["backend"]})
    compare_stats("agree", stats, ref_stats, "jax_reference")


def phase_dense(compact_stats, compact_walls):
    """The dense oracle engine.simulate, one simulation per trace, 1000
    steps each, on the sweep's alistorage traces (DENSE_CASES); its stats
    against the sweep's and the JAX package's, its walls against the
    sweep's on the same traces."""
    import types

    import torch

    from repro_torch.netsim import engine, metrics

    topo, traces = fig12_traces()
    stats, walls, steps = {}, {}, 0
    reset_counts()
    for scheme in FIG12_SCHEMES:
        cfg = engine.SimConfig(scheme=scheme, duration_s=10e-3, uplink_sample_every=10)
        walls[scheme] = 0.0
        for (wl, load), trace in zip(FIG12_CASES[:DENSE_CASES], traces):
            t0 = time.time()
            st, outs = engine.simulate(topo, cfg, trace, device=DEVICE)
            finish = st.finish.cpu().numpy()
            wall = time.time() - t0
            walls[scheme] += wall
            n = int(st.step)
            steps += n
            s = metrics.fct_stats(types.SimpleNamespace(finish=finish), trace, topo, 100e9)
            check(bool(torch.isfinite(outs.goodput_total).all()) and n == 1000,
                  f"dense {scheme} {wl} {load}: {n} of 1000 steps, or goodput not finite")
            stats[(scheme, f"{wl}_{load}")] = s
            emit({"phase": "dense", "scheme": scheme, "case": f"{wl}_{load}",
                  "flows": len(trace.sizes), "wall_s": wall, "us_per_step": wall / n * 1e6,
                  "avg_slowdown": s["avg_slowdown"], "p99_slowdown": s["p99_slowdown"],
                  "completion_rate": s["completion_rate"]})
    counts, by = read_counts(), read_tallies()
    expected = 1000 * DENSE_CASES * (len(FIG12_SCHEMES) - 1)  # all but DRILL
    total = sum(walls.values())
    compact = {k: compact_walls[k]["alistorage"] for k in walls}
    emit({"phase": "dense", "wall_s": total, "wall_s_by_scheme": walls,
          "steps": steps, "us_per_step": total / steps * 1e6, "kernel_launches": counts,
          "launches_by_route_or_cluster": by, "steps_needing_the_kernel": expected,
          "speedup_compact_over_dense": total / sum(compact.values()),
          "speedup_by_scheme": {k: walls[k] / compact[k] for k in walls}})
    check(counts["cascade_tiered"] == expected,
          f"dense: cascade_tiered launched {counts['cascade_tiered']} times for {expected}")
    compare_stats("dense", stats, compact_stats, "compact_sweep")
    compare_stats("dense", stats, reference_stats()[1], "jax_reference")
    return counts, by


def profile_steps(step, st, warm_steps: int, steps: int):
    """``warm_steps`` steps, then ``steps`` under torch.profiler: the host
    wall per step, the device's busy and idle share, the kernels that took
    the most device time, and the profiler's events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm_steps):
        st, _ = step(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            st, _ = step(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device work: the kernel and copy events themselves; record_function
    # ranges also appear on the device as annotations spanning their
    # kernels, which are not device work
    events = prof.events()
    by_kernel: dict = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_kernel.values())
    check(busy_us > 0, "the profiler saw no device work")
    top = sorted(((k, v / steps / 1e3) for k, v in by_kernel.items()),
                 key=lambda kv: -kv[1])[:6]
    return {"steps": steps, "wall_ms_per_step": wall / steps * 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "top_device_ms_per_step": dict(top)}, events


def phase_profile(warm_steps: int = 100, steps: int = 32):
    """Where a step's time goes, ``steps`` steps after ``warm_steps`` into
    the congested part of the run: the compact sweep's SeqBalance
    alistorage batch (B = 2, the sweep's largest kernel shapes), with the
    host time of each phase (record_function ranges in compact.step_fn),
    and the dense engine on the alistorage 0.8 trace (B = 1, a window of
    every flow), whose step has no admission; then netsim/profile.py's
    profile_phases on the compact batch, each phase and the whole step
    timed alone on one state ``warm_steps`` in."""
    from torch.autograd import DeviceType

    from repro_torch.kernels import cascade_tiered as ct
    from repro_torch.netsim import compact, engine, profile, sweep

    topo, traces = fig12_traces()
    cfg = engine.SimConfig(scheme="seqbalance", duration_s=10e-3, uplink_sample_every=10)
    prepped = [compact.sort_trace(t) for t in traces[:2]]  # the alistorage cases
    F_pad, W, A, padded = sweep.plan_group(topo, cfg, prepped)  # as the sweep plans it
    init, step, _ = compact.build_compact_sim(
        topo, cfg, sweep.stack_group(padded, [0, 1], topo.device), W, F_pad, A)
    row, events = profile_steps(step, init(), warm_steps, steps)
    names = ("admit", "cascade", "dcqcn", "finish")
    phases = {n: sum(e.cpu_time_total for e in events
                     if e.device_type == DeviceType.CPU and e.name == n) / steps / 1e3
              for n in names}
    emit({"phase": "profile", "engine": "compact", "scheme": cfg.scheme, "B": 2, "W": W,
          "A": A, "C": ct.cluster_size(W, 4, topo.n_links + 1), **row,
          "host_ms_per_step_by_phase": phases})
    # each phase alone on one warmed state (netsim/profile.py), the card
    # synchronized around each call: printed, not gated
    timed_phases = profile.profile_phases(topo, cfg, traces[:2], warm_steps=warm_steps,
                                          iters=20, device=DEVICE)
    emit({"phase": "profile", "engine": "compact", "profile_phases_us": {
        k: v.stats() if isinstance(v, profile.TimeUs) else v
        for k, v in timed_phases.items()}})
    trace = traces[1]  # alistorage 0.8, the largest
    init, step = engine.build_sim(topo, cfg, trace)
    row, _ = profile_steps(step, init(), warm_steps, steps)
    W = len(trace.sizes)
    emit({"phase": "profile", "engine": "dense", "scheme": cfg.scheme, "case": "alistorage_0.8",
          "B": 1, "W": W, "C": ct.cluster_size(W, 4, topo.n_links + 1), **row})


# benchmarks/paper_benches.py:458-465: the reference's floors on the adaptive
# engine's speedup over fixed dt; printed beside the ratios, not gated (a
# scheme's wall moves by up to 25 % between runs on the chip's host)
SPEED_FLOORS = {"collective": 2.0, "fig12": 0.85}


def collective_trace(topo, size: float, link_bw: float = 100e9, gap: float = 800e-6,
                     flowcells: int = 1, budget: float = 0.0):
    """A 4-chunk bidirectional ring of 8, each chunk's segment cut into
    ``flowcells`` cells sprayed over the paths; by default
    benchmarks/paper_benches.py::bench_adaptive_dt's, with 800 us compute
    gaps between rounds."""
    from repro_torch.dist import collectives, cosim
    from repro_torch.netsim import workloads

    plan = collectives.PathPlan(n_chunks=4, directions=(1, -1, 1, -1), flowcells=flowcells,
                                reorder_budget=budget)
    return workloads.collective_trace(plan, cosim.ring_hosts(topo, 8), size, link_bw=link_bw,
                                      round_gap_s=gap, seed=0, steer_paths=topo.n_paths)


def gated_diffs(stats: dict, ref: dict, what: str) -> dict:
    """The largest stat_diffs of ``stats[key]`` from ``ref[key]``; fails
    past GATES."""
    worst = {k: 0.0 for k in GATES}
    for key, st in stats.items():
        for k, v in stat_diffs(st, ref[key]).items():
            worst[k] = max(worst[k], v)
    for k, v in worst.items():
        check(v <= GATES[k], f"{what}: {k} differs by {v} > {GATES[k]}")
    return worst


def finish_agreement(got, want, dt: float) -> dict:
    """The same set of finished flows? The share of them within one dt,
    the largest gap, and whether the two are equal.  ``alike``: the same
    finished flows and at least 99 % of them within one dt, the agreement
    tests/test_torch_kernels_gpu.py asks of the card against the CPU."""
    done = np.isfinite(got) & np.isfinite(want)
    gap = np.abs(got[done] - want[done])
    same = bool(np.array_equal(np.isfinite(got), np.isfinite(want)))
    within = float((gap <= dt + 1e-9).mean()) if done.any() else 1.0
    return {"same_finished": same, "within_dt": within,
            "max_gap_s": float(gap.max()) if done.any() else 0.0,
            "equal": bool(np.array_equal(got, want)), "alike": same and within >= 0.99}


def timed_run(topo, cfg, traces, **operands):
    """One run_jobs job (run_batch of ``traces``) on the card with the
    counts set to 0 just before: (results, their per-step outputs, wall,
    tiered launches, the loop counts of compact.run_core it moved)."""
    import torch

    from repro_torch.netsim import compact, sweep

    reset_counts()
    before = dict(compact.run_core.counts)
    t0 = time.time()
    (results, outs), = sweep.run_jobs([(topo, cfg, traces, operands)], device=DEVICE)
    torch.cuda.synchronize()
    wall = time.time() - t0
    loop = {k: compact.run_core.counts[k] - before[k] for k in before}
    return results, outs, wall, read_counts()["cascade_tiered"], loop


def check_launches(what: str, scheme: str, launches: int, loop: dict,
                   reorder: bool = False) -> int:
    """The tiered kernel ran once per stepped step and once per
    steady-state check (a fast-forward reuses its check's cascade); never
    for DRILL.  A run with ``reorder`` makes no steady-state check (only
    idle spans fast-forward) and each fast-forward runs its own cascade."""
    want = 0 if scheme == "drill" else loop["scanned_steps"] + loop["steady_checks"]
    if reorder:
        want += loop["fast_forwards"]
    check(launches == want, f"{what} {scheme}: cascade_tiered launched {launches} times, "
                            f"expected {want} ({loop})")
    return want


def phase_adaptive() -> int:
    """Adaptive dt against fixed dt on the card, each against the JAX
    package's (src/repro_torch/netsim/adaptive_reference.json): the
    collective of bench_adaptive_dt on leaf_spine(4, 4, 4) and on sim_2tier,
    and the fig12 fast sweep.  The two modes of a scheme run back to back,
    the first of them alternating from scheme to scheme, so that their
    walls meet the host in one state.  Returns the tiered kernel's
    launches."""
    from repro_torch.netsim import engine, metrics, topology

    ref = reference("adaptive")["cases"]
    ls444 = topology.leaf_spine(4, 4, 4, 100e9, device=DEVICE)
    sim2 = topology.sim_2tier(device=DEVICE)
    fig_topo, fig_traces = fig12_traces()
    col = dict(duration_s=14e-3, uplink_sample_every=10)
    fig = dict(duration_s=10e-3, uplink_sample_every=10)
    fig_names = [f"{wl}_{load}" for wl, load in FIG12_CASES]
    cases = (("collective_ls444", "collective", ls444, col, [collective_trace(ls444, 4e6)],
              ["collective"], ("seqbalance",)),
             ("collective_sim2tier", "collective", sim2, col, [collective_trace(sim2, 8e6)],
              ["collective"], ("seqbalance", "ecmp", "letflow")),
             # the alistorage traces only: phases 9 and 10 took the time
             ("fig12_adaptive", "fig12", fig_topo, fig, fig_traces[:2], fig_names[:2],
              FIG12_SCHEMES))
    total = 0
    for name, kind, topo, cfg_kw, traces, names, schemes in cases:
        check(ref[name]["flows"][:len(traces)] == [int(t.valid.sum()) for t in traces],
              f"{name}: the traces are not the reference's")
        case_walls = {"fixed": 0.0, "adaptive": 0.0}
        for i, scheme in enumerate(schemes):
            row, finish = {}, {}
            for mode in ("fixed", "adaptive") if i % 2 == 0 else ("adaptive", "fixed"):
                jax = {(scheme, n): ref[name]["runs"][scheme][mode][n] for n in names}
                cfg = engine.SimConfig(scheme=scheme, adaptive=mode == "adaptive", **cfg_kw)
                results, _, wall, launched, loop = timed_run(topo, cfg, traces)
                total += check_launches(f"{name} {mode}", scheme, launched, loop)
                stats = {(scheme, n): metrics.fct_stats(r, t, topo, 100e9)
                         for n, r, t in zip(names, results, traces)}
                finish[mode] = [r.finish for r in results]
                ff = [r.ff_steps for r in results]
                row[f"{mode}_loop"] = dict(loop, launches=launched)
                if mode == "adaptive" and kind == "fig12":
                    check(loop["checks_ruled_out"] == 0,
                          f"{name} {scheme}: {loop['checks_ruled_out']} steady-state "
                          "checks where the arrival check ruled every simulation out")
                case_walls[mode] += wall
                worst = gated_diffs(stats, jax, f"{name} {scheme} {mode} vs the JAX package")
                row[mode] = {"wall_s": wall, "ff_steps": ff,
                             "jax_ff_steps": [jax[(scheme, n)]["ff_steps"] for n in names],
                             "vs_jax": worst,
                             "target_held": all(v <= TARGET for v in worst.values())}
                row[f"{mode}_stats"] = stats
            if kind == "collective":
                check(all(f > 0 for f in row["adaptive"]["ff_steps"]),
                      f"{name} {scheme}: the adaptive run fast-forwarded no step")
            gap = gated_diffs(row.pop("adaptive_stats"), row.pop("fixed_stats"),
                              f"{name} {scheme} adaptive vs fixed on the card")
            agree = [finish_agreement(a, f, 10e-6) for a, f in zip(finish["adaptive"],
                                                                  finish["fixed"])]
            emit({"phase": "adaptive", "case": name, "scheme": scheme, "traces": names,
                  **row, "speedup": row["fixed"]["wall_s"] / row["adaptive"]["wall_s"],
                  "adaptive_vs_fixed": {"stats": gap, "finish": agree}})
        ratio = case_walls["fixed"] / case_walls["adaptive"]
        emit({"phase": "adaptive", "case": name, "fixed_wall_s": case_walls["fixed"],
              "adaptive_wall_s": case_walls["adaptive"], "speedup": ratio,
              "reference_floor": SPEED_FLOORS[kind],
              "floor_met": ratio >= SPEED_FLOORS[kind]})
    return total


def phase_faults() -> int:
    """The fig12 alistorage 0.5 trace on sim_2tier under a fault campaign:
    bench_cosim's draw (seed 17, 8 epochs, 3 faults, a ring of 8) at epoch 3
    as a wall-clock capacity schedule, its stride aligned to the chunk, and
    0.5 % loss on spine 0; SeqBalance and ECMP, fixed and adaptive dt, each
    against the JAX package's.  A zero-loss vector must give the finish
    times of no loss operand, and the static capacity other ones than the
    schedule, each as ``finish_agreement`` judges two runs on the card.
    Returns the tiered kernel's launches."""
    from repro_torch.netsim import compact, engine, faults, metrics, topology

    ref = reference("adaptive")["cases"]["faults"]
    topo, traces = fig12_traces()
    trace = traces[0]
    check(ref["flows"] == [int(trace.valid.sum())], "faults: not the reference's trace")
    cfg_kw = dict(duration_s=10e-3, uplink_sample_every=10)
    cfg = engine.SimConfig(**cfg_kw)
    n_steps = int(round(cfg.duration_s / cfg.dt))
    camp = faults.random_campaign(topo, seed=17, epochs=8, n_faults=3, n_ranks=8)
    loss = np.zeros(topo.n_links + 1, np.float32)
    loss[list(topology.spine_links(topo, 0))] = 0.005
    sched = camp.capacity_schedule(topo, 3)
    seg = camp.seg_steps(n_steps, align=compact.plan_chunks(cfg, n_steps)[0])
    ops = dict(capacity=sched, loss=loss, cap_seg_steps=seg)
    total, finish = 0, {}
    for scheme in ("seqbalance", "ecmp"):
        for mode in ("fixed", "adaptive"):
            cfg = engine.SimConfig(scheme=scheme, adaptive=mode == "adaptive", **cfg_kw)
            (res,), _, wall, launched, loop = timed_run(topo, cfg, [trace], **ops)
            total += check_launches(f"faults {mode}", scheme, launched, loop)
            finish[scheme, mode] = res.finish
            s = metrics.fct_stats(res, trace, topo, 100e9)
            want = ref["runs"][scheme][mode]["alistorage_0.5"]
            worst = gated_diffs({0: s}, {0: want}, f"faults {scheme} {mode} vs the JAX package")
            emit({"phase": "faults", "scheme": scheme, "mode": mode, "wall_s": wall,
                  "ff_steps": res.ff_steps, "jax_ff_steps": want["ff_steps"],
                  "completion_rate": s["completion_rate"], "avg_slowdown": s["avg_slowdown"],
                  "p99_slowdown": s["p99_slowdown"], "vs_jax": worst,
                  "target_held": all(v <= TARGET for v in worst.values()),
                  "cap_seg_steps": seg, "loop": dict(loop, launches=launched)})
        agree = finish_agreement(finish[scheme, "adaptive"], finish[scheme, "fixed"], 10e-6)
        emit({"phase": "faults", "scheme": scheme, "adaptive_vs_fixed": agree})
    cfg = engine.SimConfig(scheme="ecmp", **cfg_kw)
    variants = {"zero_loss": dict(capacity=sched, cap_seg_steps=seg,
                                  loss=np.zeros(topo.n_links + 1, np.float32)),
                "no_loss": dict(capacity=sched, cap_seg_steps=seg),
                "static_capacity": dict(capacity=topo.capacity, loss=loss)}
    got = {}
    for v, kw in variants.items():
        (res,), _, _, launched, loop = timed_run(topo, cfg, [trace], **kw)
        total += check_launches(f"faults {v}", "ecmp", launched, loop)
        got[v] = res.finish
    zero = finish_agreement(got["zero_loss"], got["no_loss"], 10e-6)
    static = finish_agreement(got["static_capacity"], finish["ecmp", "fixed"], 10e-6)
    emit({"phase": "faults", "zero_loss_vs_no_loss": zero, "static_vs_schedule": static})
    check(zero["alike"], "faults: a zero-loss vector moved ECMP's finish times")
    check(not static["alike"], "faults: the static capacity gave the schedule's finish times")
    return total


# bench_flowcell's fast grid (benchmarks/bench_flowcell.py:75-95): the arms
# and their (scheme, flowcell trace?, reorder budget); its ring of 16 MB with
# 300 us between rounds over 10 ms, halved in bytes and in time for the
# script's time limit (PERF.md §6): the same arms finish, the same stay
# censored and the two facts read as at full depth
FLOWCELL_GRID = dict(size=8e6, gap_s=1.5e-4, horizon_s=5e-3)
FLOWCELL_BUDGETS = (0, 4, 16)
GRID_ARMS = ("seqbalance", "ecmp", "flowlet_timeout", "flowcell_free") + tuple(
    f"flowcell_b{b}" for b in FLOWCELL_BUDGETS)
SIM2TIER_ARMS = ("seqbalance", "flowlet_timeout", "flowcell_free", "flowcell_b0",
                 "flowcell_b16")
# phase 4's gates on the censored percentiles (p99's, 2 %, on p50 too) and
# the completion rate
CENSORED_GATES = {"completion": 1e-3, "p50_us": 2e-2, "p99_us": 2e-2}
# where the JAX package's two p99s lie this close, an acceptance fact is
# printed and not gated
FACT_MARGIN = 2e-2
# flowlet_timeout where flowlets break (tests/test_torch_flowcell.py's
# REDRAW): traffic, flowlet timeout (s), adaptive, capacity schedule
REDRAW = {"poisson": ("poisson", 1e-6, False, False),
          "poisson_schedule": ("poisson", 1e-6, False, True),
          "line_rate_adaptive": ("line_rate", 1e-9, True, False)}


def redraw_case(name: str):
    """A REDRAW case on the card: (topology, SimConfig keywords, trace, run
    operands) on the hetero fabric of 2 leaves with one fat spine of 4.
    ``poisson`` is alistorage at load 0.5 over its bisection, ``line_rate``
    three long flows from leaf 0 to leaf 1; the schedule moves leaf 0's fat
    uplink to another spine after 0.3 ms and keeps leaf 1's."""
    from repro_torch.netsim import topology, workloads

    traffic, timeout, adaptive, schedule = REDRAW[name]
    topo = topology.hetero_leaf_spine(2, 4, 4, 40e9, 160e9, n_fast_spines=1, device=DEVICE)
    if traffic == "poisson":
        trace = workloads.poisson_trace(workloads.TraceConfig(
            workload="alistorage", load=0.5, duration_s=0.8e-3, n_hosts=topo.n_hosts,
            host_bw=40e9, seed=2, hosts_per_leaf=topo.hosts_per_leaf,
            load_base_bw=2 * 4 * 40e9))
    else:
        trace = workloads.Trace(
            sizes=np.array([4e6, 4e6, 3e6], np.float32),
            arrivals=np.array([0.0, 1e-5, 2e-4], np.float32),
            src=np.array([0, 1, 2], np.int32), dst=np.array([4, 5, 6], np.int32),
            flow_id=np.array([11, 12, 13], np.uint32), valid=np.ones(3, bool))
    ops = {}
    if schedule:
        cap = np.stack([topo.capacity.cpu().numpy()] * 2).astype(np.float32)
        up = cap[1, : topo.n_leaf * topo.n_paths].reshape(topo.n_leaf, topo.n_paths)
        up[0] = np.roll(up[0], 1)
        ops = dict(capacity=cap, cap_seg_steps=30)
    return topo, dict(duration_s=3e-3, adaptive=adaptive, flowlet_timeout=timeout), trace, ops


def arm(name: str):
    """(scheme, runs the flowcell trace, reorder budget or None)."""
    if name.startswith("flowcell_"):
        return "ecmp", True, None if name == "flowcell_free" else float(name[len("flowcell_b"):])
    return name, False, None


def censored(res, trace, horizon_s: float) -> dict:
    """benchmarks/bench_flowcell.py::_censored_p99: the FCT percentiles
    with the unfinished flows censored at the horizon."""
    from repro_torch.netsim import metrics

    f, completion = metrics.fct_samples(res, trace, horizon_s=horizon_s)
    return {"p99_us": float(np.percentile(f, 99) * 1e6),
            "p50_us": float(np.percentile(f, 50) * 1e6), "completion": completion}


def censored_diffs(got: dict, want: dict, what: str) -> dict:
    diffs = {"completion": abs(got["completion"] - want["completion"]),
             "p50_us": abs(got["p50_us"] / want["p50_us"] - 1.0),
             "p99_us": abs(got["p99_us"] / want["p99_us"] - 1.0)}
    for k, v in diffs.items():
        check(v <= CENSORED_GATES[k], f"{what}: {k} differs by {v} > {CENSORED_GATES[k]}")
    return diffs


def finish_diff(got, want) -> dict:
    """How two finish arrays differ: flows whose finish differs (a finish
    against none included) and the largest gap between two finishes."""
    got, want = np.asarray(got), np.asarray(want)
    both = np.isfinite(got) & np.isfinite(want)
    return {"differ": int((~((got == want) | (np.isinf(got) & np.isinf(want)))).sum()),
            "max_gap_s": float(np.abs(got[both] - want[both]).max()) if both.any() else 0.0}


def phase_flowcell(fig12_finish) -> int:
    """Flowcell spraying against SeqBalance, ECMP and flowlet WCMP, each
    held against the JAX package's (src/repro_torch/netsim/flowcell_reference.json):
    bench_flowcell's fast grid on the 25G symmetric and hetero fabrics, the
    degenerate cases (flowcells=1 and reorder=0.0 on unsprayed traffic,
    then phase 3's SeqBalance alistorage batch with reorder=0.0, against
    ``fig12_finish``), the ring on sim_2tier with adaptive dt, and
    flowlet_timeout where flowlets break (REDRAW).  The grid's arms run
    with a window of every flow, the degenerate cases against the grid's
    SeqBalance arm as their plain run; the grid's symmetric ECMP arm runs
    once more at the planner's window, which spills, so that sweep's
    spill retry runs on the card and gives the full window's finishes.
    Returns the tiered kernel's launches."""
    from repro_torch.netsim import engine, metrics, sweep, topology

    ref = reference("flowcell")["cases"]
    total = 0

    def run(topo, scheme, trace, reorder, window=None, ops=None, **cfg_kw):
        nonlocal total
        cfg = engine.SimConfig(scheme=scheme, **cfg_kw)
        (res,), _, wall, launched, loop = timed_run(topo, cfg, [trace], reorder=reorder,
                                                 window_slots=window, **(ops or {}))
        total += check_launches(f"flowcell {scheme}", scheme, launched, loop,
                                reorder=reorder is not None)
        return res, wall, dict(loop, launches=launched, W=res.window_slots,
                               spill_steps=res.spill_steps)

    fabrics = {"symmetric": topology.leaf_spine(4, 4, 4, 25e9, host_bw=100e9, device=DEVICE),
               "hetero": topology.hetero_leaf_spine(4, 4, 4, 25e9, 100e9, n_fast_spines=1,
                                                    host_bw=100e9, device=DEVICE)}
    size, gap, horizon = (FLOWCELL_GRID[k] for k in ("size", "gap_s", "horizon_s"))
    check(ref["flowcell_grid"]["config"] == dict(
        duration_s=horizon, size=size, round_gap_s=gap, flowcells=4,
        budgets=list(FLOWCELL_BUDGETS)), "flowcell_grid: the reference is of another grid")
    grid, runs = {}, {}
    for fabric, topo in fabrics.items():
        traces = {False: collective_trace(topo, size, 25e9, gap),
                  True: collective_trace(topo, size, 25e9, gap, flowcells=4)}
        grid[fabric] = {}
        for name in GRID_ARMS:
            scheme, cells, reorder = arm(name)
            want = ref["flowcell_grid"]["runs"][fabric][name]
            check(want["flows"] == len(traces[cells].sizes), f"flowcell {name}: not the trace")
            # a window of every flow: no spill, so the run is stepped once
            res, wall, loop = run(topo, scheme, traces[cells], reorder,
                                  len(traces[cells].sizes), duration_s=horizon)
            check(res.spill_steps == 0, f"flowcell_grid {fabric} {name}: spill")
            runs[fabric, name] = res
            got = censored(res, traces[cells], horizon)
            grid[fabric][name] = got
            emit({"phase": "flowcell", "case": "flowcell_grid", "fabric": fabric, "arm": name,
                  **got, "jax": {k: want[k] for k in got}, "wall_s": wall,
                  "vs_jax": censored_diffs(got, want, f"flowcell_grid {fabric} {name}"),
                  "loop": loop})
    sym, jsym = grid["symmetric"], ref["flowcell_grid"]["runs"]["symmetric"]
    facts = {"free_wins": ("flowcell_free", "seqbalance"), "gbn_loses": ("seqbalance",
                                                                         "flowcell_b0")}
    for fact, (lo, hi) in facts.items():
        got = sym[lo]["p99_us"] <= sym[hi]["p99_us"]
        want = ref["flowcell_grid"]["facts"][fact]
        close = abs(jsym[lo]["p99_us"] / jsym[hi]["p99_us"] - 1.0) <= FACT_MARGIN
        emit({"phase": "flowcell", "fact": fact, "holds": got, "jax": want,
              "gated": not close, f"{lo}_p99_us": sym[lo]["p99_us"],
              f"{hi}_p99_us": sym[hi]["p99_us"]})
        check(close or got == want, f"flowcell: {fact} is {got} on the card, {want} in JAX")

    topo = fabrics["symmetric"]
    classic = collective_trace(topo, size, 25e9, gap)
    # sweep's spill retry: the planner's window spills on this arm and the
    # rerun at a larger window gives the finishes of the run with a window
    # of every flow
    retries = sweep.obs_stats()["spill_retries"]
    res, wall, loop = run(topo, "ecmp", classic, None, duration_s=horizon)
    retried = sweep.obs_stats()["spill_retries"] - retries
    moved = finish_diff(res.finish, runs["symmetric", "ecmp"].finish)
    emit({"phase": "flowcell", "case": "flowcell_spill_retry", "fabric": "symmetric",
          "arm": "ecmp", "spill_retries": retried, "vs_full_window": moved, "wall_s": wall,
          "loop": loop})
    check(retried > 0, "flowcell_spill_retry: the planner's window did not spill")
    check(moved["differ"] == 0, f"flowcell_spill_retry: {moved['differ']} finish times "
                                "moved from the full window's")

    plan1 = collective_trace(topo, size, 25e9, gap, flowcells=1, budget=9.0)
    same = all(np.array_equal(getattr(classic, f), getattr(plan1, f))
               for f in ("sizes", "arrivals", "src", "dst", "flow_id", "valid", "spray"))
    check(same, "flowcell_degenerate: flowcells=1 did not render the classic trace")
    window, base = len(classic.sizes), runs["symmetric", "seqbalance"]
    one = run(topo, "seqbalance", plan1, None, window, duration_s=horizon)[0]
    zero = run(topo, "seqbalance", classic, 0.0, window, duration_s=horizon)[0]
    small = {"flowcells_1": finish_diff(one.finish, base.finish),
             "reorder_0": finish_diff(zero.finish, base.finish)}
    got = censored(base, classic, horizon)
    want = ref["flowcell_degenerate"]["seqbalance"]
    emit({"phase": "flowcell", "case": "flowcell_degenerate", "fabric": "symmetric",
          "vs_plain": small, "jax_bit_identical": ref["flowcell_degenerate"]["bit_identical"],
          **got, "vs_jax": censored_diffs(got, want, "flowcell_degenerate seqbalance")})
    fig_topo, fig_traces = fig12_traces()
    fig_cfg = engine.SimConfig(scheme="seqbalance", duration_s=10e-3, uplink_sample_every=10)
    batch = fig_traces[:2]
    results, _, wall, launched, loop = timed_run(fig_topo, fig_cfg, batch, reorder=0.0)
    total += check_launches("flowcell fig12 reorder=0", "seqbalance", launched, loop, True)
    fig = {f"alistorage_{load}": finish_diff(r.finish, f)
           for load, r, f in zip((0.5, 0.8), results, fig12_finish)}
    ref_stats = reference_stats()[1]
    stats = {("seqbalance", f"alistorage_{load}"): metrics.fct_stats(r, t, fig_topo, 100e9)
             for load, r, t in zip((0.5, 0.8), results, batch)}
    emit({"phase": "flowcell", "case": "flowcell_degenerate", "fabric": "sim_2tier",
          "traces": ["alistorage_0.5", "alistorage_0.8"], "reorder": 0.0, "wall_s": wall,
          "vs_plain": fig,
          "vs_jax": gated_diffs(stats, ref_stats, "flowcell fig12 reorder=0 vs JAX"),
          "loop": dict(loop, launches=launched)})
    for name, d in {**small, **{f"fig12 {k}": v for k, v in fig.items()}}.items():
        check(d["differ"] == 0, f"flowcell_degenerate {name}: {d['differ']} finish times "
                                "moved from the plain run's")

    sim2 = topology.sim_2tier(device=DEVICE)
    traces = {False: collective_trace(sim2, 8e6, 100e9, 800e-6),
              True: collective_trace(sim2, 8e6, 100e9, 800e-6, flowcells=4)}
    for name in SIM2TIER_ARMS:
        scheme, cells, reorder = arm(name)
        want = ref["flowcell_sim2tier"]["runs"][name]
        res, wall, loop = run(sim2, scheme, traces[cells], reorder, duration_s=14e-3,
                              adaptive=True, uplink_sample_every=10)
        got = censored(res, traces[cells], 14e-3)
        emit({"phase": "flowcell", "case": "flowcell_sim2tier", "arm": name, **got,
              "jax": {k: want[k] for k in got}, "ff_steps": res.ff_steps,
              "jax_ff_steps": want["ff_steps"], "wall_s": wall,
              "vs_jax": censored_diffs(got, want, f"flowcell_sim2tier {name}"), "loop": loop})

    for name in REDRAW:  # the WCMP re-draw fires: held to the JAX package's finishes
        topo, cfg_kw, trace, ops = redraw_case(name)
        want = ref["flowlet_redraw"]["runs"][name]
        jax_finish = np.array([np.inf if f is None else f for f in want["finish_s"]])
        res, wall, loop = run(topo, "flowlet_timeout", trace, None, ops=ops, **cfg_kw)
        ecmp = run(topo, "ecmp", trace, None, ops=ops, **cfg_kw)[0]
        agree = finish_agreement(np.asarray(res.finish, np.float64), jax_finish, 10e-6)
        moved = finish_diff(res.finish, ecmp.finish)
        emit({"phase": "flowcell", "case": "flowlet_redraw", "run": name, "vs_jax": agree,
              "ff_steps": res.ff_steps, "jax_ff_steps": want["ff_steps"],
              "ecmp_ff_steps": ecmp.ff_steps, "vs_ecmp": moved, "wall_s": wall, "loop": loop})
        check(agree["alike"], f"flowlet_redraw {name}: finishes off the JAX package's ({agree})")
        check(res.ff_steps == want["ff_steps"],
              f"flowlet_redraw {name}: ff_steps {res.ff_steps}, JAX {want['ff_steps']}")
        check(moved["differ"] > 0, f"flowlet_redraw {name}: no re-draw (finishes = ECMP's)")
        check(not cfg_kw["adaptive"] or ecmp.ff_steps > res.ff_steps,
              f"flowlet_redraw {name}: the flowlet gap did not hold back the fast-forward")
    emit({"phase": "flowcell", "kernel_launches": total})
    return total


# benchmarks/bench_obs.py:108: the reference's floor on the recorder's
# overhead, printed beside the measured one and not gated
RECORD_OVERHEAD_FLOOR_PCT = 5.0
RING_REL = {"goodput_mean_bps": 1e-3, "queue_mean_bytes": 1e-3, "util_mean": 1e-3,
            "cnp_pkts": 2e-2, "rate_quantiles": 2e-2}
# the one cell whose run on the card lies off the JAX package's compact
# trajectory (0.35 % on p99, 0.018 % on avg).  The witness is the JAX
# package's own pair: its dense engine (engine.simulate) lies off its
# compact run by the same avg 1.7859e-4 and p99 3.4545e-3, and the card's
# finishes are the dense run's, none a step apart (ROADMAP.md §3).  Both
# part from the compact run at step 117, where flow 15009 of the trace
# (93,739 bytes, arriving at 1.0687 ms) finishes in the dense run and on
# the card but keeps 0.1259 bytes of one sub-flow in the compact run, past
# DONE_EPS_BYTES (0.125): float sums in another order; the congestion
# table parts at step 168 (leaf 4, path 9) and paths at step 169.  The card
# takes that trajectory every run (its sums are order-free).  Only its
# ring may be held as the other trajectory's: to the JAX package's at phase
# 4's gates (avg 0.5 % for the means, p99 2 % for the CNPs and each quantile
# column's chunk-weighted mean), looser than RING_REL, with each row's
# quantiles held exactly to the rates of its own run
# (ring_quantiles_vs_states).  Any other cell off the JAX package's
# trajectory fails.
BISTABLE = ("record_fig12", "fixed", "alistorage_0.5")
RING_REL_OTHER = {"goodput_mean_bps": 5e-3, "queue_mean_bytes": 5e-3, "util_mean": 5e-3,
                  "cnp_pkts": 2e-2, "rate_quantiles": 2e-2}


def rel(a, b) -> float:
    """|a - b| / |b| elementwise at most (0 where both are 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    return float(np.where((a == b), 0.0, err).max()) if a.size else 0.0


def ring_vs_outputs(drained: dict, outs) -> dict:
    """The recorder against its own run: each kept row's queue max (exactly),
    queue mean, CNPs and goodput (within 1e-5, another order of float32
    sums) against the run's per-step outputs over the row's steps."""
    f = {name: i for i, name in enumerate(drained["fields"])}
    worst = 0.0
    exact = True
    for row in drained["meta"]:
        cols = slice(int(row[f["step0"]]), int(row[f["step0"]] + row[f["steps"]]))
        mq = np.asarray(outs.max_queue[cols], np.float64)
        exact &= bool(row[f["queue_max"]] == np.float32(mq.max()))
        for name, want in (("queue_mean", mq.mean()), ("cnp_pkts", outs.cnp_rate[cols].sum()),
                           ("goodput_mean", outs.goodput_total[cols].mean())):
            worst = max(worst, abs(row[f[name]] - want) / max(abs(want), 1e-30))
    return {"rows": len(drained["meta"]), "queue_max_exact": exact, "max_rel": float(worst),
            "agree": bool(exact and worst <= 1e-5)}


def ring_quantiles_vs_states(spec, topo, cfg, traces, i: int) -> tuple[dict, int]:
    """One more recorded run with ``obs.recorder.record_chunk`` wrapped so
    that each row's rates and live sub-flows (the states at the chunk's
    end) are copied to the host: each kept row of simulation ``i`` (its
    place in the batch) against the rank quantiles recomputed from them in
    numpy, exactly (a rank statistic selects a value).  Returns the row to
    print and the tiered kernel's launches."""
    from repro_torch.obs import recorder

    original, want = recorder.record_chunk, {}

    def capture(spec_, ring, **kw):
        count = ring.count.cpu().numpy()
        write = (np.ones(count.shape, bool) if kw.get("write") is None
                 else kw["write"].cpu().numpy())
        rc = kw["rc"].cpu().numpy().reshape(count.size, -1)
        act = kw["active"].cpu().numpy().reshape(count.size, -1)
        for b in np.flatnonzero(write):
            n = int(act[b].sum())
            vals = np.sort(np.where(act[b], rc[b], np.float32(np.inf)))
            want[(int(b), int(count[b]))] = [
                vals[min(max(int(np.float32(n - 1) * np.float32(q)), 0), vals.size - 1)]
                if n > 0 else np.float32(0.0) for q in spec_.quantiles]
        return original(spec_, ring, **kw)

    recorder.record_chunk = capture
    try:
        results, _, _, launched, loop = timed_run(topo, cfg, traces, record=spec)
    finally:
        recorder.record_chunk = original
    launches = check_launches("record quantiles", cfg.scheme, launched, loop)
    drained = recorder.drain(spec, results[i].ring)
    cols = [j for j, f in enumerate(drained["fields"]) if f.startswith("rc_q")]
    first = drained["chunks_recorded"] - drained["chunks_kept"]
    unequal = [first + r for r, row in enumerate(drained["meta"])
               if (i, first + r) not in want
               or not np.array_equal(row[cols], np.asarray(want[(i, first + r)], np.float32))]
    return {"rows": int(drained["chunks_kept"]), "unequal_rows": unequal,
            "exact": not unequal}, launches


def ring_agreement(got: dict, want: dict, same_ff: bool,
                   same_trajectory: bool = True) -> tuple[dict, list]:
    """The card's drained ring (its epoch_summary) against the JAX
    package's: chunks_recorded and the step0/steps/ff columns equal where
    ff_steps equals the JAX package's, and there each row's rate quantiles
    within 2 %; goodput, queue and uplink utilization means within 1e-3, the
    CNPs within 2 %.  A ring of another trajectory than the JAX package's
    (``same_trajectory`` False) is held to RING_REL_OTHER, its quantiles
    by each column's chunk-weighted mean.  Returns the row to print (with
    the worst row of each column) and what disagrees."""
    gc, wc = got["chunks"], want["chunks"]
    n = min(len(gc["step0"]), len(wc["step0"]))
    worst = {}
    for f in gc:
        a, b = np.asarray(gc[f][:n]), np.asarray(wc[f][:n])
        e = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        e = np.where(a == b, 0.0, e)
        i = int(e.argmax()) if n else 0
        worst[f] = {"row": i, "rel": float(e[i]) if n else 0.0,
                    "card": float(a[i]) if n else None, "jax": float(b[i]) if n else None}
    errs = {k: rel(got[k], want[k]) for k in ("goodput_mean_bps", "queue_mean_bytes",
                                              "cnp_pkts")}
    errs["util_mean"] = rel(got["uplink"]["util_mean"], want["uplink"]["util_mean"])
    if not same_trajectory:
        gw = np.asarray(gc["steps"], np.float64) / np.sum(gc["steps"])
        ww = np.asarray(wc["steps"], np.float64) / np.sum(wc["steps"])
        errs["rate_quantiles"] = max(rel(np.dot(gc[f], gw), np.dot(wc[f], ww))
                                     for f in gc if f.startswith("rc_q"))
    elif same_ff:  # the rows are the same chunks
        errs["rate_quantiles"] = max(worst[f]["rel"] for f in gc if f.startswith("rc_q"))
    limits = RING_REL if same_trajectory else RING_REL_OTHER
    columns = all(gc[f] == wc[f] for f in ("step0", "steps", "ff"))
    row = {"chunks_recorded": got["chunks_recorded"], "jax_chunks_recorded":
           want["chunks_recorded"], "columns_equal": columns, "gated_columns": same_ff,
           "same_trajectory": same_trajectory, "rel": errs, "limits": limits,
           "worst_row": worst}
    faults = [f"{k} of the ring differs by {v} > {limits[k]}"
              for k, v in errs.items() if v > limits[k]]
    if same_ff and not (got["chunks_recorded"] == want["chunks_recorded"] and columns):
        faults.append("the ring's chunks differ from the JAX package's")
    return row, faults


def phase_record() -> int:
    """The flight recorder on the card, held against the JAX package's
    rings (src/repro_torch/netsim/record_reference.json): bench_obs's
    collective on leaf_spine(4, 4, 4), fixed and adaptive, and phase 3's
    SeqBalance alistorage batch, each run without and with
    RecordSpec(ring_chunks=64), alternated twice.  Every run's finish
    times must equal the first plain run's and the two rings must be
    bit-identical; each ring must be its run's outputs, and the first is
    held against the JAX package's; only the BISTABLE cell, if its run
    lies off the JAX package's trajectory (its FCT stats past the 0.01 %
    target), may be held as a ring of another trajectory
    (``ring_agreement``), its rows' quantiles to its own run's rates
    (``ring_quantiles_vs_states``).  The overhead (min of each) is
    printed beside the reference's floor.  Returns the tiered kernel's
    launches."""
    import torch

    from repro_torch import obs
    from repro_torch.netsim import engine, metrics, topology

    ref = reference("record")
    spec = obs.RecordSpec(ring_chunks=ref["ring_chunks"])
    ls444 = topology.leaf_spine(4, 4, 4, 100e9, device=DEVICE)
    fig_topo, fig_traces = fig12_traces()
    cases = (("record_ls444", ls444, [collective_trace(ls444, 4e6)], ["fixed", "adaptive"],
              dict(scheme="seqbalance", duration_s=14e-3, uplink_sample_every=10)),
             ("record_fig12", fig_topo, fig_traces[:2], ["fixed"],
              dict(scheme="seqbalance", duration_s=10e-3, uplink_sample_every=10)))
    total, faults = 0, []
    for name, topo, traces, modes, cfg_kw in cases:
        jax = ref["cases"][name]
        for mode in modes:
            cfg = engine.SimConfig(adaptive=mode == "adaptive", **cfg_kw)
            walls, runs = {"off": [], "on": []}, {"off": [], "on": []}
            for _ in range(2):
                for side in ("off", "on"):
                    results, outs, wall, launched, loop = timed_run(
                        topo, cfg, traces, **({"record": spec} if side == "on" else {}))
                    total += check_launches(f"{name} {mode} record {side}", cfg.scheme,
                                            launched, loop)
                    walls[side].append(wall)
                    runs[side].append((results, outs))
            names = list(jax) if name == "record_fig12" else [mode]  # the JAX runs' keys
            plain = runs["off"][0][0]
            rows = {}
            for i, trace_name in enumerate(names):
                want = jax[trace_name]
                moved = [finish_diff(r[i].finish, plain[i].finish)["differ"]
                         for r in (runs["off"][1][0], runs["on"][0][0], runs["on"][1][0])]
                rings = [runs["on"][k][0][i].ring for k in range(2)]
                same_ring = all(torch.equal(a, b) for a, b in zip(*rings))
                check(not any(moved) and same_ring,
                      f"{name} {mode} {trace_name}: finish times moved from the first plain "
                      f"run's ({moved}: second plain, with the ring) or the rings differ")
                res, outs = runs["on"][0][0][i], runs["on"][0][1][i]
                own = ring_vs_outputs(obs.drain(spec, res.ring), outs)
                check(own["agree"], f"{name} {mode} {trace_name}: the ring is not its "
                                    f"run's outputs ({own})")
                drift = stat_diffs(metrics.fct_stats(res, traces[i], topo, 100e9),
                                   trajectory_stats(name, mode, trace_name))
                on_path = max(drift.values()) <= TARGET
                row = {"finish_moved": moved, "rings_equal": same_ring, "own_outputs": own,
                       "vs_jax": drift}
                if not on_path:
                    check((name, mode, trace_name) == BISTABLE,
                          f"{name} {mode} {trace_name}: off the JAX package's trajectory "
                          f"(FCT stats off by {drift})")
                    own_q, launched = ring_quantiles_vs_states(spec, topo, cfg, traces, i)
                    total += launched
                    row["own_quantiles"] = own_q
                    check(own_q["exact"], f"{name} {mode} {trace_name}: the ring's rate "
                                          f"quantiles are not its run's ({own_q})")
                ring, bad = ring_agreement(obs.epoch_summary(spec, obs.drain(spec, res.ring)),
                                           want["summary"], res.ff_steps == want["ff_steps"],
                                           on_path)
                faults += [f"{name} {mode} {trace_name}: {b}" for b in bad]
                rows[trace_name] = dict(row, ff_steps=res.ff_steps,
                                        jax_ff_steps=want["ff_steps"], ring=ring)
            off, on = min(walls["off"]), min(walls["on"])
            emit({"phase": "record", "case": name, "mode": mode, "wall_off_s": walls["off"],
                  "wall_on_s": walls["on"], "overhead_pct": (on / off - 1.0) * 100.0,
                  "reference_floor_pct": RECORD_OVERHEAD_FLOOR_PCT,
                  "floor_met": (on / off - 1.0) * 100.0 <= RECORD_OVERHEAD_FLOOR_PCT,
                  "runs": rows})
    emit({"phase": "record", "kernel_launches": total})
    check(not faults, "; ".join(faults))
    return total


# chip_smoke.py phase 11 and its reference: the co-simulation cases of
# benchmarks/bench_cosim.py, each a list of (label, run_cosim keywords)
COSIM_KILL = dict(spine=3, epoch=2, recover_epoch=6)
# every case runs 8 epochs (the blackout cell 10), not bench_cosim's 10 (12):
# the script's time limit (PERF.md §4); every fault window, every
# quarantine's release and every convergence still falls inside them
COSIM_EPOCHS = 8
# the leaf_spine cases' ring carries 4 MB, not bench_cosim's 8 MB: the
# script's time limit again (an epoch is 191 steps, not 331); every case
# quarantines, releases and converges at the epochs it did at 8 MB
COSIM_RING_BYTES = 4e6
# the per-epoch fields that must equal the JAX package's, case by case
COSIM_EQUAL = {
    "cosim_three_tier": ("quarantined", "reported_slow", "plan_version", "plan_churn",
                         "spill_steps"),
    "cosim_grid": ("quarantined", "reported_slow", "plan_version", "plan_churn",
                   "spill_steps"),
    "cosim_campaign": ("quarantined", "reported_slow", "plan_version", "plan_churn",
                       "spill_steps", "replan_round", "straggler_quarantined",
                       "straggler_scale"),
    "cosim_telemetry": ("quarantined", "reported_slow", "plan_version", "plan_churn",
                        "spill_steps", "reports_sent", "reports_delivered",
                        "reports_admitted", "reports_stale", "reports_duplicate",
                        "safe_mode"),
}
COSIM_FIELDS = sorted({f for fs in COSIM_EQUAL.values() for f in fs}
                      | {"fct_p99_s", "fct_p50_s", "completion", "new_builds", "ff_steps"})


def cosim_cases(cosim, faults, topology, obs, topo_kw: dict, flight_dir) -> dict:
    """Phase 11's cases, built from either package's modules (``topo_kw``
    the port's device); fresh objects each call (a telemetry channel
    keeps state).  ``flight_dir``: where the grid's SeqBalance run writes
    its flight log.

      cosim_three_tier  bench_cosim.py:96-106, the acceptance row at full
                        width: three_tier() (320 hosts and paths), a ring
                        of 20 at 16 MB, ECMP, aggregation switch 3 killed
                        at epoch 2 and back at 6;
      cosim_grid        bench_cosim.py:118-139's fast grid on
                        leaf_spine(8, 12, 16, 100e9), ECMP and SeqBalance,
                        a ring of 8 at COSIM_RING_BYTES, spine 3 killed at
                        2 and back
                        at 6; SeqBalance with the recorder
                        (RecordSpec(ring_chunks=64)) and a flight log;
      cosim_campaign    bench_cosim.py:159-185's mixed campaign on the
                        same fabric and ring, ECMP, adaptive dt: a flap
                        kill of spine 3 at onset 0.02 for epochs 2-6, 1 %
                        loss on spine 5 for epochs 3-7, rank 4 a 3x
                        straggler for epochs 4-7, cooldown_steps=2;
      cosim_telemetry   bench_cosim.py:268-297 and :336-345: the killed-
                        spine run through TelemetryChannel(loss=0.3,
                        delay_epochs=2, seed=7) with staleness_bound=2,
                        and the blackout cell (blackout=(0, 5),
                        blackout_epochs=2, spine back at 8);
    every case for COSIM_EPOCHS epochs (the blackout cell two more)."""
    topo3 = topology.three_tier(**topo_kw)
    topo2 = topology.leaf_spine(8, 12, 16, 100e9, **topo_kw)

    def killed(topo, ring, size, scheme, recover_epoch=6, epochs=COSIM_EPOCHS, **kw):
        return dict(topo=topo, hosts=cosim.ring_hosts(topo, ring), size_bytes=size,
                    scheme=scheme, epochs=epochs, phi_steps=2, n_chunks=4, seed=0,
                    faults=(cosim.kill_spine(topo, COSIM_KILL["spine"], epoch=COSIM_KILL["epoch"],
                                             recover_epoch=recover_epoch),), **kw)

    spine_links = topology.spine_links
    campaign = faults.FaultCampaign(events=(
        faults.LinkFlap(links=spine_links(topo2, 3), start_epoch=2, end_epoch=6, duty=1.0,
                        onset_frac=0.02, scale=0.0),
        faults.LossyLink(links=spine_links(topo2, 5), loss_rate=0.01, start_epoch=3,
                         end_epoch=7),
        faults.Straggler(rank=4, slowdown=3.0, start_epoch=4, end_epoch=7)))

    def channel(**kw):
        return dict(telemetry=faults.TelemetryChannel(seed=7, **kw), staleness_bound=2)

    return {
        "cosim_three_tier": [("ecmp", killed(topo3, 20, 16e6, "ecmp"))],
        "cosim_grid": [
            ("ecmp", killed(topo2, 8, COSIM_RING_BYTES, "ecmp")),
            ("seqbalance", killed(topo2, 8, COSIM_RING_BYTES, "seqbalance",
                                  record=obs.RecordSpec(ring_chunks=64),
                                  flight=str(pathlib.Path(flight_dir) / "cosim_grid.jsonl")))],
        "cosim_campaign": [("ecmp", dict(
            topo=topo2, hosts=cosim.ring_hosts(topo2, 8), size_bytes=COSIM_RING_BYTES,
            scheme="ecmp",
            epochs=COSIM_EPOCHS, phi_steps=2, cooldown_steps=2, n_chunks=4, seed=0,
            campaign=campaign,
            adaptive=True))],
        "cosim_telemetry": [
            ("loss30_delay2", killed(topo2, 8, COSIM_RING_BYTES, "ecmp",
                                     **channel(loss=0.3, delay_epochs=2))),
            ("blackout", killed(topo2, 8, COSIM_RING_BYTES, "ecmp", recover_epoch=8,
                                epochs=COSIM_EPOCHS + 2,
                                blackout_epochs=2,
                                **channel(loss=0.0, delay_epochs=0, blackout=(0, 5))))],
    }


# phase 11's recorder rows: a queue under one byte is float noise of a link
# loaded exactly to its capacity (the JAX package's float sums leave 0.02-0.12
# bytes there where the card's exact sums leave 0, and the run then ends a
# step later, which shifts a full ring's window by one row)
QUEUE_NOISE_BYTES = 1.0


def insim_agreement(got: dict, want: dict) -> tuple[dict, list]:
    """One epoch's recorder summary against the JAX package's, row by row
    over the chunks both rings kept (matched by step0): steps and ff
    equal, goodput within RING_REL's 1e-3, CNPs, live sub-flows and rate
    quantiles within its 2 %, queues within 1e-3 or QUEUE_NOISE_BYTES; the
    rings at most one chunk apart.  Returns the row to print and what
    disagrees."""
    gc, wc = got.get("chunks", {}), want.get("chunks", {})
    g_at = {s: i for i, s in enumerate(gc.get("step0", []))}
    w_at = {s: i for i, s in enumerate(wc.get("step0", []))}
    common = sorted(set(g_at) & set(w_at))
    faults = []
    if abs(got["chunks_recorded"] - want["chunks_recorded"]) > 1 or \
            len(common) < min(len(g_at), len(w_at)) - 1:
        faults.append(f"the rings kept other chunks ({got['chunks_recorded']} recorded, "
                      f"JAX {want['chunks_recorded']}; {len(common)} in common)")
    worst = {}
    for f in gc:
        if f in ("step0", "steps", "ff"):
            continue
        a = np.array([gc[f][g_at[s]] for s in common], np.float64)
        b = np.array([wc[f][w_at[s]] for s in common], np.float64)
        err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
        noise = QUEUE_NOISE_BYTES if f.startswith("queue") else 0.0
        err = np.where(np.abs(a - b) <= noise, 0.0, err)
        worst[f] = float(err.max(initial=0.0))
        limit = RING_REL["cnp_pkts"] if f in ("cnp_pkts", "active_subflows") or \
            f.startswith("rc_q") else RING_REL["goodput_mean_bps"]
        if worst[f] > limit:
            faults.append(f"{f} of the ring differs by {worst[f]} > {limit}")
    for f in ("steps", "ff"):
        if any(gc[f][g_at[s]] != wc[f][w_at[s]] for s in common):
            faults.append(f"the ring's {f} column differs from the JAX package's")
    return {"rows_compared": len(common), "chunks_recorded": got["chunks_recorded"],
            "jax_chunks_recorded": want["chunks_recorded"], "worst_rel": worst}, faults


def cosim_row(hist) -> dict:
    """What phase 11 compares of a history, JSON-able: the fields of
    COSIM_FIELDS per epoch, each epoch's recorder summary, the convergence
    epoch after the kill and the refused plans."""
    epochs = {f: [getattr(r, f) for r in hist.records] for f in COSIM_FIELDS}
    epochs = {f: [list(v) if isinstance(v, tuple) else v for v in vs]
              for f, vs in epochs.items()}
    return {"epochs": epochs, "insim": [r.insim for r in hist.records],
            "convergence_epoch": hist.convergence_epoch(COSIM_KILL["epoch"]),
            "plan_refused": hist.plan_refused, "steps_per_epoch":
            int(round(hist.duration_s / 10e-6))}


def same_history(a, b) -> bool:
    """Two histories bit for bit: every record field (the censored FCT
    samples and imbalance arrays included) and the plans."""
    import dataclasses

    def flat(h):
        return [{k: (v.tobytes() if isinstance(v, np.ndarray) else v)
                 for k, v in dataclasses.asdict(r).items()} for r in h.records]
    return (flat(a) == flat(b) and a.plans == b.plans and a.final_plan == b.final_plan
            and a.plan_refused == b.plan_refused)


def phase_cosim() -> int:
    """The dist/ epoch driver on the card: each case of ``cosim_cases``
    through repro_torch.dist.cosim.run_cosim (the grid through
    run_cosim_grid on two threads, each history also run alone and held
    to it bit for bit), against the JAX package's runs of the same specs
    (src/repro_torch/netsim/cosim_reference.json): per epoch the fields of
    COSIM_EQUAL equal, the censored p99 and p50 within 2 % and the
    completion within 1e-3, no kernel library built after epoch 0, the
    same convergence epoch; the grid's flight log read back, its
    recorder summaries against the JAX package's under phase 10's ring
    limits; the telemetry cases' plan versions strictly increasing, none
    refused.  Returns the tiered kernel's launches."""
    import tempfile

    from repro_torch import obs
    from repro_torch.dist import cosim
    from repro_torch.netsim import compact, faults, topology

    ref = reference("cosim")["cases"]
    gates = {"fct_p99_s": CENSORED_GATES["p99_us"], "fct_p50_s": CENSORED_GATES["p50_us"]}
    total, failures, start = 0, [], time.time()
    with tempfile.TemporaryDirectory() as tmp:
        def cases():
            return cosim_cases(cosim, faults, topology, obs, dict(device=DEVICE), tmp)

        for name, runs in cases().items():
            reset_counts()
            before = dict(compact.run_core.counts)
            t0 = time.time()
            if name == "cosim_grid":
                hists = cosim.run_cosim_grid([spec for _, spec in runs], workers=2,
                                             device=DEVICE)
            else:
                hists = [cosim.run_cosim(**spec, device=DEVICE) for _, spec in runs]
            wall = time.time() - t0
            loop = {k: compact.run_core.counts[k] - before[k] for k in before}
            launched = read_counts()["cascade_tiered"]
            want = loop["scanned_steps"] + loop["steady_checks"]
            check(launched == want > 0, f"{name}: cascade_tiered launched {launched} times, "
                                        f"expected {want} ({loop})")
            total += launched
            steps = sum(len(h.records) * cosim_row(h)["steps_per_epoch"] for h in hists)
            row = {"phase": "cosim", "case": name, "wall_s": wall,
                   "us_per_step": wall / steps * 1e6, "epoch_steps": steps,
                   "loop": dict(loop, launches=launched), "runs": {}}
            for (label, spec), hist in zip(runs, hists):
                got, jax = cosim_row(hist), ref[name][label]
                diffs = {}
                for f in COSIM_EQUAL[name]:
                    if got["epochs"][f] != jax["epochs"][f]:
                        failures.append(f"{name} {label}: {f} {got['epochs'][f]} on the card, "
                                        f"{jax['epochs'][f]} in JAX")
                for f, gate in gates.items():
                    g, w = np.asarray(got["epochs"][f]), np.asarray(jax["epochs"][f])
                    diffs[f] = float(np.max(np.abs(g / w - 1.0)))
                    if diffs[f] > gate:
                        failures.append(f"{name} {label}: {f} differs by {diffs[f]} > {gate}")
                diffs["completion"] = float(np.max(np.abs(
                    np.asarray(got["epochs"]["completion"])
                    - np.asarray(jax["epochs"]["completion"]))))
                if diffs["completion"] > CENSORED_GATES["completion"]:
                    failures.append(f"{name} {label}: completion differs by "
                                    f"{diffs['completion']}")
                if any(got["epochs"]["new_builds"][1:]):
                    failures.append(f"{name} {label}: libraries built after epoch 0 "
                                    f"{got['epochs']['new_builds']}")
                if got["convergence_epoch"] != jax["convergence_epoch"]:
                    failures.append(f"{name} {label}: converged at {got['convergence_epoch']}, "
                                    f"JAX at {jax['convergence_epoch']}")
                run = {"vs_jax": diffs, "convergence_epoch": got["convergence_epoch"],
                       "jax_convergence_epoch": jax["convergence_epoch"],
                       "p99_us": [round(x * 1e6, 3) for x in got["epochs"]["fct_p99_s"]],
                       "quarantined": got["epochs"]["quarantined"],
                       "ff_steps": got["epochs"]["ff_steps"],
                       "jax_ff_steps": jax["epochs"]["ff_steps"],
                       "new_builds": got["epochs"]["new_builds"],
                       "plan_refused": got["plan_refused"]}
                if name == "cosim_telemetry":
                    vs = got["epochs"]["plan_version"]
                    run["versions_increase"] = all(b > a for a, b in zip(vs, vs[1:]))
                    run["safe_mode"] = got["epochs"]["safe_mode"]
                    if not run["versions_increase"] or got["plan_refused"]:
                        failures.append(f"{name} {label}: plan versions {vs}, "
                                        f"{got['plan_refused']} refused")
                if spec.get("record") is not None:
                    rings = [insim_agreement(g, w) for g, w in zip(got["insim"], jax["insim"])]
                    failures += [f"{name} {label} epoch {e}: {b}"
                                 for e, (_, bad) in enumerate(rings) for b in bad]
                    run["insim"] = [r for r, _ in rings]
                if spec.get("flight") is not None:
                    _, events = obs.read_flight(spec["flight"])
                    kinds = [e["kind"] for e in events]
                    run["flight_events"] = {k: kinds.count(k) for k in sorted(set(kinds))}
                    if run["flight_events"] != {"campaign": 1, "epoch": len(hist.records),
                                                "run_end": 1}:
                        failures.append(f"{name} {label}: flight log {run['flight_events']}")
                    report_check(spec["flight"], len(hist.records))  # phase 24's report twin
                row["runs"][label] = run
            if name == "cosim_grid":  # each history alone, bit for bit
                t0 = time.time()
                alone = {label: cosim.run_cosim(**spec, device=DEVICE)
                         for label, spec in cases()[name]}
                row["alone_wall_s"] = time.time() - t0
                row["grid_equals_alone"] = {label: same_history(h, alone[label])
                                            for (label, _), h in zip(runs, hists)}
                failures += [f"cosim_grid {label}: the grid's history is not the spec's alone"
                             for label, same in row["grid_equals_alone"].items() if not same]
            emit(row)
    emit({"phase": "cosim", "kernel_launches": total, "wall_s": time.time() - start})
    check(not failures, "; ".join(failures))
    return total


# phase 16: the paper's testbed results, copied from benchmarks/
# paper_benches.py:99-156 (the port has no benchmark module yet).  The
# paper's scale: Fig. 10 and Fig. 11 run 15 ms (1,500 steps of 10 us), the
# pairs starting at 0, 5 and 10 ms, read over steps 1,000 to the end; Table
# II runs 10 ms.  TESTBED_REDUCED is the CPU tests' cut: 2 ms, the pairs at
# 0, 0.5 and 1 ms, read from step 150, Table II 1 ms.
TESTBED_PAPER = dict(horizon_s=15e-3, starts=(0.0, 5e-3, 10e-3), late=1000,
                     table2_horizon_s=10e-3)
TESTBED_REDUCED = dict(horizon_s=2e-3, starts=(0.0, 0.5e-3, 1e-3), late=150,
                       table2_horizon_s=1e-3)
TESTBED_PARTS = ("fig10", "fig11", "table2")
TESTBED_SCHEMES = ("ecmp", "seqbalance")
TABLE2_SENDERS = (1, 2, 3)
# the gates on the testbed readings against the JAX package's: each per-path
# late mean (Fig. 10, Fig. 11) and Table II's mean goodput within 1 % of the
# JAX package's (of 1 Gb/s where it reads less), Table II's congestion-packet
# bandwidth within 1 % or 1 Kb/s (the paper's unit); the facts equal.  The
# port's CPU runs read the JAX package's to 2.4e-7; each TESTBED_PLANTED
# fault moves a reading of its part by 10 % or more (testbed_reference.json
# keeps the port's planted readings at the paper's scale).
TESTBED_REL = 1e-2
TESTBED_FLOOR_GBPS = 1.0
TESTBED_CNP_ABS_BPS = 1e3
# Table II's fact: the congestion packets take under this share of the data
# rate at each load (the paper's Table II: 0.05 Gb/s at most)
TABLE2_NEGLIGIBLE = 1e-3
# planted faults, each a wrong input that the gates of its part must catch:
# the asymmetric fabric without its 80G links (Fig. 11), SeqBalance's QPs
# not split into sub-flows (Fig. 10: n_sub=1), the symmetric fabric at 25G
# (Table II).  A congestion table never marked is no such fault: no queue
# reaches kmin in these runs, so it changes no reading.
TESTBED_PLANTED = {"no_80g_links": "fig11", "one_subflow": "fig10", "fabric_25g": "table2"}


def pairs_trace(workloads, n_qp: int = 4, size: float = 1e12, starts=(0.0, 5e-3, 10e-3)):
    """paper_benches.py::_pairs_trace: sender i to host 3 + i, n_qp QPs of
    size / n_qp bytes each (none finishes), pair i starting at starts[i]."""
    pairs, st = [], []
    for i, t0 in enumerate(starts):
        for _ in range(n_qp):
            pairs.append((i, 3 + i))
            st.append(t0)
    return workloads.permanent_senders_trace(pairs, st, size / n_qp)


def dc40(dcqcn_params):
    """paper_benches.py::_dc40: DCQCN for the 40G testbed."""
    return dcqcn_params(kmin_bytes=160e3, kmax_bytes=520e3, r_ai=400e6, min_rate=400e6)


def late_mean_gbps(outs, late: int) -> np.ndarray:
    """Leaf 0's uplink offered load, Gb/s per path, averaged over the steps
    from ``late`` on (paper_benches.py:115)."""
    up = np.asarray(outs.uplink_load)[:, 0, :]
    return up[late:].mean(0) / 1e9


def testbed_readings(run, engine, topology, workloads, metrics, dcqcn_params, topo_kw: dict,
                     scale: dict = TESTBED_PAPER, fault: str | None = None,
                     parts=TESTBED_PARTS) -> dict:
    """Fig. 10, Fig. 11 and Table II through either package's modules:
    ``run(what, topo, cfg, traces)`` returns (results, outs) of a
    ``sweep.run_batch``.  Fig. 10 and Fig. 11: leaf 0's per-path late
    means, their total and spread (max - min), Fig. 11's fat path (path 2)
    and ``fat_gain`` (SeqBalance's fat-path load over ECMP's); Table II:
    SeqBalance at 1, 2 and 3 senders of 4 QPs of 250 MB, its
    congestion-packet bandwidth and mean goodput; and the paper's fact of
    each of ``parts`` as the run reads it."""
    topos = {"symmetric": topology.testbed_symmetric(**topo_kw),
             "asymmetric": topology.testbed_asymmetric(**topo_kw)}
    if fault == "no_80g_links":
        topos["asymmetric"] = topology.leaf_spine(2, 3, 3, 40e9, base_rtt_s=4e-6, **topo_kw)
    elif fault == "fabric_25g":
        topos["symmetric"] = topology.leaf_spine(2, 4, 3, 25e9, base_rtt_s=4e-6, **topo_kw)
    cfg_kw = {"dcqcn": dc40(dcqcn_params)}
    trace = pairs_trace(workloads, starts=scale["starts"])
    out, facts = {}, {}
    for fig, fabric in (("fig10", "symmetric"), ("fig11", "asymmetric")):
        if fig not in parts:
            continue
        out[fig] = {}
        for scheme in TESTBED_SCHEMES:
            split = {"n_sub": 1} if fault == "one_subflow" and scheme == "seqbalance" else {}
            cfg = engine.SimConfig(scheme=scheme, duration_s=scale["horizon_s"], **split,
                                   **cfg_kw)
            _, (outs,) = run(f"{fig} {scheme}", topos[fabric], cfg, [trace])
            late = late_mean_gbps(outs, scale["late"])
            out[fig][scheme] = {"per_path_gbps": [float(v) for v in late],
                                "total_gbps": float(late.sum()),
                                "spread_gbps": float(late.max() - late.min())}
            if fig == "fig11":
                out[fig][scheme]["fat_gbps"] = float(late[2])
    if "fig10" in parts:
        sym = out["fig10"]
        facts["fig10_seqbalance_spread_below_ecmp"] = (sym["seqbalance"]["spread_gbps"]
                                                       < sym["ecmp"]["spread_gbps"])
    if "fig11" in parts:
        fat = out["fig11"]
        fat["fat_gain"] = fat["seqbalance"]["fat_gbps"] / max(fat["ecmp"]["fat_gbps"], 1e-9)
        facts["fig11_fat_gain_above_1"] = fat["fat_gain"] > 1.0
    if "table2" in parts:
        horizon = scale["table2_horizon_s"]
        traces = [workloads.permanent_senders_trace(
            [(i, 3 + i) for i in range(n) for _ in range(4)], [0.0] * 4 * n, 2.5e8)
            for n in TABLE2_SENDERS]
        cfg = engine.SimConfig(scheme="seqbalance", duration_s=horizon, **cfg_kw)
        results, outs = run("table2 seqbalance", topos["symmetric"], cfg, traces)
        out["table2"] = {
            str(n): {"cong_pkt_bps": metrics.congestion_packet_bandwidth(r, horizon),
                     "goodput_mean_bps": float(np.asarray(o.goodput_total).mean())}
            for n, r, o in zip(TABLE2_SENDERS, results, outs)}
        facts["table2_congestion_negligible"] = {
            n: t["cong_pkt_bps"] < TABLE2_NEGLIGIBLE * t["goodput_mean_bps"]
            for n, t in out["table2"].items()}
    out["facts"] = facts
    return out


def testbed_faults(got: dict, want: dict) -> tuple[dict, list]:
    """The testbed gates on the parts ``got`` holds: (the largest error of
    each reading, the readings past their gates)."""
    errs, faults = {}, []
    for fig in ("fig10", "fig11"):
        if fig not in got:
            continue
        for scheme in TESTBED_SCHEMES:
            g = np.asarray(got[fig][scheme]["per_path_gbps"], np.float64)
            w = np.asarray(want[fig][scheme]["per_path_gbps"], np.float64)
            e = float((np.abs(g - w) / np.maximum(np.abs(w), TESTBED_FLOOR_GBPS)).max())
            errs[f"{fig}_{scheme}_per_path"] = e
            if e > TESTBED_REL:
                faults.append(f"{fig} {scheme}: a path's late mean is off by {e:.4g} "
                              f"({g.round(4).tolist()} Gb/s, JAX {w.round(4).tolist()})")
    for n, w in want["table2"].items() if "table2" in got else ():
        g = got["table2"][n]
        e = abs(g["goodput_mean_bps"] / w["goodput_mean_bps"] - 1.0)
        d = abs(g["cong_pkt_bps"] - w["cong_pkt_bps"])
        errs[f"table2_{n}_goodput"], errs[f"table2_{n}_cong_pkt_bps_abs"] = e, d
        if e > TESTBED_REL:
            faults.append(f"table2 {n} senders: mean goodput off by {e:.4g}")
        if d > max(TESTBED_CNP_ABS_BPS, TESTBED_REL * w["cong_pkt_bps"]):
            faults.append(f"table2 {n} senders: congestion packets {g['cong_pkt_bps']} b/s, "
                          f"JAX {w['cong_pkt_bps']}")
    wanted = {k: want["facts"][k] for k in got["facts"]}
    if got["facts"] != wanted:
        faults.append(f"the paper's facts read {got['facts']}, JAX {wanted}")
    return errs, faults


def phase_testbed() -> int:
    """The paper's testbed results on the card (Table I's closed form, then
    Fig. 10, Fig. 11, Table II at the paper's scale, TESTBED_PAPER) through
    sweep.run_batch, held
    against the JAX package's (src/repro_torch/netsim/testbed_reference.json)
    by testbed_faults; the tiered kernel launched once on every step of
    every run (the flows never finish, so every run steps to its horizon).
    That each TESTBED_PLANTED fault fails these gates is shown by
    tests/test_torch_testbed.py.  Returns the tiered kernel's launches."""
    from repro_torch.core import gbn
    from repro_torch.netsim import engine, metrics, topology, workloads
    from repro_torch.netsim.dcqcn import DCQCNParams

    ref = reference("testbed")
    total, walls = 0, {}

    def run(what, topo, cfg, traces):
        nonlocal total
        results, outs, wall, launched, loop = timed_run(topo, cfg, traces)
        total += check_launches(f"testbed {what}", cfg.scheme, launched, loop)
        steps = int(round(cfg.duration_s / cfg.dt))
        check(loop["scanned_steps"] == launched == steps,
              f"testbed {what}: {launched} launches for {loop['scanned_steps']} steps "
              f"of {steps}")
        walls[what] = wall
        emit({"phase": "testbed", "run": what, "traces": len(traces), "steps": steps,
              "wall_s": wall, "us_per_step": wall / steps * 1e6, "launches": launched,
              "W": results[0].window_slots})
        return results, outs

    table1 = [gbn.table1_inflation(size) for size in (64e3, 1e6)]  # on the card by default
    check(all(v.device.type == "cuda" for v in table1), "testbed: Table I ran off the card")
    table1 = [round(float(v), 2) for v in table1]
    emit({"phase": "testbed", "table1_inflation": {"64KB": table1[0], "1MB": table1[1]}})
    check(table1 == [5.77, 2.83], f"testbed: Table I reads {table1}, not [5.77, 2.83]")
    got = testbed_readings(run, engine, topology, workloads, metrics, DCQCNParams,
                           dict(device=DEVICE))
    errs, faults = testbed_faults(got, ref["readings"])
    emit({"phase": "testbed", "readings": got, "jax": ref["readings"], "errors": errs,
          "gates": {"rel": TESTBED_REL, "floor_gbps": TESTBED_FLOOR_GBPS,
                    "cnp_abs_bps": TESTBED_CNP_ABS_BPS},
          "wall_s": sum(walls.values()), "kernel_launches": total})
    check(not faults, "testbed: " + "; ".join(faults))
    return total


# phase 13: gemma2-2b as published, 4 prompts over the 4,096-token window
SERVE_PROMPTS = (4500, 4700, 4900, 5120)
SERVE_NEW_TOKENS = 32
SERVE_SEED = 13
# phase 15: the moe, hybrid and ssm families as published, 4 prompts each:
# deepseek's over 3,584-4,096 tokens, recurrentgemma's all past its
# 2,048-token window, xlstm's over 768-1,024 (a multiple of the mLSTM's
# 256-token chunk once padded)
FAMILIES_SERVE = (("deepseek-moe-16b", (3584, 3755, 3925, 4096)),
                  ("recurrentgemma-9b", (2560, 2731, 2901, 3072)),
                  ("xlstm-1.3b", (768, 853, 939, 1024)))
FAMILIES_REFERENCE = SRC / "repro_torch" / "models" / "families_reference.json"


def serve_engine_run(cfg, params, prompts, max_len: int, new_tokens: int):
    """The main path: ServeEngine.admit (prefill) and ServeEngine.step
    until every request is done (decode ticks), with the launch counts set
    to 0 just before; (each request's tokens, prefill wall, decode wall,
    decode ticks, kernel launches, flash_attention's routes)."""
    import torch

    from repro_torch.serve import engine

    reqs = [engine.Request(i, p, new_tokens) for i, p in enumerate(prompts)]
    eng = engine.ServeEngine(cfg, params, batch_size=len(prompts), max_len=max_len,
                             device=DEVICE)
    torch.cuda.synchronize()
    reset_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        eng.admit(reqs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ticks = 1  # the tick that ends the run returns 0 active requests
        while eng.step() > 0:
            ticks += 1
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    counts, routes = read_counts(), read_tallies()["flash_attention"]
    del eng
    return [r.out_tokens for r in reqs], t1 - t0, t2 - t1, ticks, counts, routes


def attention_layers(cfg) -> int:
    """The self-attention layers of a prefill: one flash launch each."""
    from repro_torch.models import transformer

    prelude, sb, n_super, trailing = transformer.block_program(cfg)
    return (sum(u.kind == "attn" for u in prelude + trailing)
            + n_super * sum(u.kind == "attn" for u in sb))


def flash_routes_of(cfg) -> dict:
    """The flash launches by route that one prefill of ``cfg`` must make."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    n = attention_layers(cfg)
    return {fa.flash_route(getattr(torch, cfg.dtype), cfg.hd): n} if n else {}


def against_reference(phase: str, cfg, params, case: dict, prompts, steps: list,
                      float32_run: dict | None = None, whole: bool = True):
    """``params`` (``case``'s numpy draw) served on the card against
    the JAX package's run ``steps`` of the same case: decode teacher-forced
    on its tokens, the logits at its top ids and greedy token within
    SERVE_TOL of the row's RMS (given ``float32_run``, the JAX package's
    float32 run fed a bfloat16 run's tokens, against that instead);
    ServeEngine's own tokens equal to its up to each request's first
    near-tie; one prefill's flash launches by route.  Without ``whole``
    the logits and tokens are printed and not held.  Returns the row to
    print, the teacher-forced prefill's moe dispatches, and (ok, what) for
    each check."""
    import torch

    from repro_torch.serve import compare

    jax_tokens = torch.as_tensor([s["token"] for s in steps], device=DEVICE)
    top_ids = torch.as_tensor([s["top_ids"] for s in steps], device=DEVICE)
    rms = torch.as_tensor([s["norm"] for s in steps], device=DEVICE) / cfg.vocab ** 0.5
    routes = []
    _, got = compare.serve_steps(params, cfg, prompts, case["max_len"], len(steps),
                                 forced=jax_tokens, routes=routes)
    got = torch.gather(got, -1, torch.cat([top_ids, jax_tokens[..., None]], -1))

    def err_against(ref: dict) -> float:
        want = torch.cat([torch.as_tensor(ref["top_values"], device=DEVICE),
                          torch.as_tensor(ref["chosen_logit"], device=DEVICE)[..., None]], -1)
        return float(((got - want).abs() / rms[..., None]).max())

    err = err_against({"top_values": [s["top_values"] for s in steps],
                       "chosen_logit": [s["chosen_logit"] for s in steps]})
    tol = compare.SERVE_TOL[cfg.dtype]
    held, extra = err, {}
    if float32_run is not None:
        held = err_against(float32_run)
        extra = {"vs_jax_float32_max_err_over_rms": held,
                 "jax_bfloat16_vs_float32_max_err_over_rms":
                     float32_run["bfloat16_max_err_over_rms"]}
    margin = torch.as_tensor([s["margin"] for s in steps], device=DEVICE)
    upto = compare.tokens_before_near_tie(margin, rms, tol)
    tokens, prefill_s, decode_s, ticks, counts, routes_run = serve_engine_run(
        cfg, params, prompts, case["max_len"], case["max_new_tokens"])
    jax_rows = jax_tokens.t().tolist()
    same = [t[:n] == j[:n] for t, j, n in zip(tokens, jax_rows, upto)]
    row = {"phase": phase, "dtype": cfg.dtype, "arch": case["arch"],
           "cut": case["replace"], "prompts": [len(p) for p in prompts],
           "max_len": case["max_len"], "new_tokens": case["max_new_tokens"],
           "teacher_forced_max_err_over_rms": err, **extra, "tolerance": tol,
           "end_to_end_held": whole, "tokens_compared": upto, "tokens_equal": same,
           "tokens_equal_all_steps": [t == j for t, j in zip(tokens, jax_rows)],
           "prefill_s": prefill_s, "decode_s": decode_s, "ticks": ticks,
           "kernel_launches": counts, "flash_routes": routes_run}
    checks = [(routes_run == flash_routes_of(cfg)
               and counts["flash_attention"] == sum(routes_run.values()),
               f"{phase} {case['arch']} {cfg.dtype}: flash_attention ran as {routes_run}, not "
               f"{flash_routes_of(cfg)}")]
    if whole:
        checks += [(held <= tol, f"{phase} {case['arch']} {cfg.dtype}: teacher-forced logits "
                                 f"{held} of the row's RMS off the JAX package's "
                                 f"{'float32 ' if float32_run else ''}run (tolerance {tol})"),
                   (all(same), f"{phase} {case['arch']} {cfg.dtype}: ServeEngine's tokens "
                               f"differ from the JAX package's before a near-tie ({tokens} "
                               f"against {jax_rows})")]
    return row, routes[0], checks


def unit_checks(phase: str, entry: dict, tree: dict, cfg) -> tuple[list, list]:
    """The units of ``entry["units"]`` (families_reference.json) on the card
    in ``cfg.dtype``, fed the JAX package's input (compare.unit_inputs),
    against its float32 outputs at the sampled rows and columns within
    compare.UNIT_TOL; (rows to print, (ok, what) for each)."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.serve import compare

    u, ref = entry["case"]["units"], entry["units"]
    _, sb, _, _ = transformer.block_program(cfg)
    x, xd = compare.unit_inputs(u["input_seed"], u["batch"], u["seq"], u["decode_steps"],
                                cfg.d_model)
    rows = torch.as_tensor(ref["rows"], device=DEVICE)
    cols = torch.as_tensor(ref["cols"], device=DEVICE)
    lim = compare.UNIT_TOL[cfg.dtype]
    out, checks = [], []
    for rec in ref["layers"]:
        unit = sb[rec["layer"]]
        p = transformer.unit_params(cfg, unit, {k: v[0] for k, v in
                                                tree["main"][rec["layer"]].items()},
                                    getattr(torch, cfg.dtype), device=DEVICE)
        got = compare.unit_outputs(unit.kind, p, cfg, x, xd)[rows][:, cols].cpu().numpy()
        errs = compare.unit_errors(got, rec["float32"], rec["rms"])
        out.append({"unit": unit.kind, "layer": rec["layer"], **errs, "limit": lim,
                    "jax_bfloat16": rec["jax_bfloat16"],
                    "planted_fault_on_the_cpu": rec["planted_cpu"][cfg.dtype]})
        checks.append((errs["max"] <= lim["max"] and errs["mean"] <= lim["mean"],
                       f"{phase} {entry['case']['arch']} {cfg.dtype}: the {unit.kind} unit "
                       f"(layer {rec['layer']}) is {errs} of a row's RMS off the JAX "
                       f"package's float32 unit (limit {lim})"))
        del p
    return out, checks


def phase_serve_ref() -> dict:
    """gemma2-2b at full width, cut to 4 layers and a 256-token window,
    served in float32 (route simt) and bfloat16 (route wgmma), each held
    against the JAX package's serving of the same case
    (src/repro_torch/models/serve_reference.json) by ``against_reference``.
    Returns each route's launches in its ServeEngine run."""
    ref = json.loads((SRC / "repro_torch" / "models" / "serve_reference.json").read_text())
    return serve_reference_cases("serve_ref", [ref])


def serve_reference_cases(phase: str, entries: list) -> dict:
    """Each reference entry (case, prompts, the JAX runs by dtype, for
    MoE its prefill routing, for bfloat16 its float32 run, for xlstm its
    units) served in float32 and bfloat16 from one numpy draw; returns the
    flash launches by route."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import weights

    launches = {"simt": 0, "wgmma": 0}
    for entry in entries:
        case = entry["case"]
        prompts = [np.asarray(p, np.int32) for p in entry["prompts"]]
        base = registry.get_config(case["arch"]).replace(**case["replace"])
        t0 = time.time()
        tree = weights.numpy_params(base, case["weights_seed"])
        draw_s = time.time() - t0
        for dtype in ("float32", "bfloat16"):
            cfg = base.replace(dtype=dtype)
            params = weights.from_jax_params(tree, cfg, device=DEVICE)
            units = dtype == "bfloat16" and "units" in entry
            row, routes, checks = against_reference(
                phase, cfg, params, case, prompts, entry["runs"][dtype],
                entry.get("float32_run") if dtype == "bfloat16" else None, whole=not units)
            row["numpy_draw_s"] = draw_s
            if "moe" in entry:  # the prefill's routing against the JAX package's
                layers = []
                for ref, r in zip(entry["moe"][dtype], routes):
                    got = r.gate_idx.sort(-1).values.cpu().numpy()
                    moved = set(np.nonzero((got != np.sort(ref["experts"], -1)).any(-1))[0])
                    layers.append({"dropped": int(r.dropped), "jax_dropped": ref["dropped"],
                                   "routed_otherwise": len(moved),
                                   "jax_near_ties": len(ref["near_ties"]),
                                   "routed_otherwise_off_near_ties":
                                       len(moved - set(ref["near_ties"]))})
                row["moe_layers"] = layers
                if dtype == "float32":
                    checks.append((all(L["dropped"] == L["jax_dropped"] > 0 for L in layers)
                                   and not any(L["routed_otherwise_off_near_ties"]
                                               for L in layers),
                                   f"{phase} {case['arch']} float32: the MoE routing is not "
                                   f"the JAX package's: {layers}"))
            del routes, params
            torch.cuda.empty_cache()
            if "units" in entry:
                row["units"], more = unit_checks(phase, entry, tree, cfg)
                checks += more
            emit(row)
            for ok, what in checks:
                check(ok, what)
            for route, n in row["flash_routes"].items():
                launches[route] += n
        del tree
    return launches


def phase_serve_families_ref() -> dict:
    """deepseek-moe-16b, granite-moe-3b-a800m, recurrentgemma-9b and
    xlstm-1.3b at full width, cut in depth (families_reference.json's
    cases), each in float32 and bfloat16 against the JAX package's run by
    ``against_reference`` (a bfloat16 run against its float32 run; for
    xlstm-1.3b in bfloat16 its units by ``unit_checks`` instead), the MoE
    cases' prefill routing too: in float32 the same replicas dropped in
    every layer (and some), and no token routed otherwise but at a JAX
    near-tie.  Returns the flash launches by route."""
    return serve_reference_cases("serve_families_ref",
                                 json.loads(FAMILIES_REFERENCE.read_text())["cases"])
def gemm_kernel(name: str) -> bool:
    """cuBLAS's and CUTLASS's matrix-product kernels, by name."""
    n = name.lower()
    return any(k in n for k in ("gemm", "gemv", "xmma", "cutlass", "nvjet"))


# the model code's profiler ranges (repro_torch.models.common.span)
SPANS = ("moe.dispatch", "moe.experts", "moe.combine", "recurrent.mlstm", "recurrent.slstm",
         "recurrent.rglru")


def profile_serve(run, label: str) -> dict:
    """``run()`` (which returns its count of calls) under torch.profiler:
    the wall, the device's busy and idle share, the kernels launched a
    call, the flash kernel's and the GEMMs' device ms, the device ms of
    the kernels launched inside each of the model's SPANS (by the host
    time of their launch), the top kernels.  It reads the profiler's raw
    events: building its event tree takes minutes at xlstm's 133k
    kernels a prefill."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel: dict = {}
    launch_at: dict = {}  # correlation id -> host start of the launch
    ranges: dict = {name: [] for name in SPANS}
    kernels = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                us = e.duration_ns() / 1e3
                by_kernel[e.name()] = by_kernel.get(e.name(), 0.0) + us
                kernels.append((e.linked_correlation_id(), us))
        else:
            launch_at[e.correlation_id()] = e.start_ns()
            if e.name() in ranges:
                ranges[e.name()].append((e.start_ns(), e.end_ns()))
    unmatched = sum(1 for corr, _ in kernels if corr not in launch_at)
    spans = {}
    for name, intervals in ranges.items():
        if not intervals:
            continue
        intervals.sort()
        starts = [a for a, _ in intervals]
        total = 0.0
        for corr, us in kernels:
            t = launch_at.get(corr)
            i = -1 if t is None else bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= intervals[i][1]:
                total += us
        spans[name] = total / 1e3
    busy = sum(by_kernel.values()) / 1e3
    check(busy > 0, f"serve profile {label}: the profiler saw no device work")
    check(sum(spans.values()) <= busy * (1 + 1e-6),
          f"serve profile {label}: the ranges hold more device time than the run")
    flash = sum(v for k, v in by_kernel.items() if "flash" in k) / 1e3
    gemm = sum(v for k, v in by_kernel.items() if gemm_kernel(k)) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"what": label, "calls": n, "device_kernels_per_call": len(kernels) / n,
            "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3), "flash_device_ms": flash,
            "gemm_device_ms": gemm, "other_device_ms": busy - flash - gemm,
            "span_device_ms": spans, "kernels_without_launch_record": unmatched,
            "top_device_ms": {k: v / 1e3 for k, v in top}}


def serve_published(phase: str, arch: str, lens, seed: int) -> dict:
    """``arch`` as published (bf16, weights from model.init_params on the
    card) serving prompts of ``lens`` tokens, SERVE_NEW_TOKENS new tokens
    each, through ServeEngine: one flash launch on wgmma per
    self-attention layer a prefill and none on simt; held against the
    same weights served with the plain attention (teacher-forced logits,
    tokens up to the first near-tie; for MoE the plain path fed the same
    tokens again, routed to the kernel run's experts, is the logits'
    reference); run twice, bit for bit; its walls,
    peak memory, for MoE the replicas dropped and the tokens routed
    otherwise than with the plain attention, in each layer of the
    prefill; and a profile of one prefill and 8 decode ticks.  Returns
    the flash launches by route in the first run."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.serve import compare, engine

    cfg = registry.get_config(arch)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, cfg.vocab, n).astype(np.int32) for n in lens]
    max_len = max(lens) + SERVE_NEW_TOKENS
    torch.cuda.synchronize()
    t0 = time.time()
    params = model.init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.reset_peak_memory_stats()
    walls = {"init_params": init_s}
    t0 = time.time()
    runs = [serve_engine_run(cfg, params, prompts, max_len, SERVE_NEW_TOKENS)
            for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    (tokens, prefill_s, decode_s, ticks, counts, routes), again = runs
    walls["engine_runs"] = time.time() - t0
    t0 = time.time()
    # the same weights with the plain attention: the reference
    moe_family = cfg.family == "moe"
    plain_routes, kernel_routes = ([], []) if moe_family else (None, None)
    ref_tokens, ref_logits = compare.serve_steps(params, cfg, prompts, max_len,
                                                 SERVE_NEW_TOKENS, plain=True,
                                                 routes=plain_routes)
    got = [compare.serve_steps(params, cfg, prompts, max_len, SERVE_NEW_TOKENS,
                               forced=ref_tokens, routes=kernel_routes if i == 0 else None)[1]
           for i in range(2)]
    tol = compare.SERVE_TOL["bfloat16"]
    errs, rms = compare.logit_errors(got[0], ref_logits, ref_tokens)
    upto = compare.tokens_before_near_tie(compare.margins(ref_logits), rms, tol)
    moe = {}
    if moe_family:
        # a bf16 near-tie sends a token to other experts on one side only
        # (and a full expert then drops or keeps another): the reference
        # is the plain path again, fed the same tokens, each token sent to
        # the kernel run's experts
        moe = {"vs_plain_attention_own_routing_max_err_over_rms": float(errs.max()),
               "moe_dropped_by_layer": [int(r.dropped) for r in kernel_routes[0]],
               "moe_dropped_by_layer_plain": [int(r.dropped) for r in plain_routes[0]],
               "moe_tokens_routed_otherwise_than_plain_by_layer": [
                   int((a.gate_idx.sort(-1).values != b.gate_idx.sort(-1).values)
                       .any(-1).sum()) for a, b in zip(kernel_routes[0], plain_routes[0])],
               "moe_tokens_routed_otherwise_than_plain_in_decode": sum(
                   int((a.gate_idx.sort(-1).values != b.gate_idx.sort(-1).values)
                       .any(-1).sum()) for ka, pa in zip(kernel_routes[1:], plain_routes[1:])
                   for a, b in zip(ka, pa)),
               "moe_replicas_per_layer": int(kernel_routes[0][0].slot.numel())}
        del plain_routes
        ref_logits = compare.serve_steps(params, cfg, prompts, max_len, SERVE_NEW_TOKENS,
                                         forced=ref_tokens, plain=True,
                                         route_as=kernel_routes)[1]
        del kernel_routes
        errs, _ = compare.logit_errors(got[0], ref_logits, ref_tokens)
    ref_rows = ref_tokens.t().tolist()
    same = [t[:n] == r[:n] for t, r, n in zip(tokens, ref_rows, upto)]
    bitwise = torch.equal(got[0], got[1]) and tokens == again[0]
    del got
    torch.cuda.empty_cache()
    err = float(errs.max())
    walls["plain_and_forced_runs"] = time.time() - t0
    del ref_logits
    new = len(prompts) * ticks  # tokens decoded (the prefill gives each request its first)
    want = flash_routes_of(cfg)
    emit({"phase": phase, "nvidia_smi": card_name(), "arch": cfg.name, "family": cfg.family,
          "n_layers": cfg.n_layers,
          "local_window": cfg.local_window, "dtype": cfg.dtype, "params": n_params,
          "prompts": list(lens), "padded_to": max(lens), "max_len": max_len,
          "new_tokens": SERVE_NEW_TOKENS, "init_params_s": init_s,
          "prefill_s": [prefill_s, again[1]], "decode_s": [decode_s, again[2]],
          "ticks": ticks, "decode_ms_per_tick": [d / ticks * 1e3 for d in (decode_s, again[2])],
          "decode_tokens_per_s": [new / d for d in (decode_s, again[2])],
          "prefill_tokens_per_s": [len(prompts) * max(lens) / p for p in (prefill_s, again[1])],
          "peak_memory_gb": peak / 1e9, "kernel_launches": counts, "flash_routes": routes,
          "vs_plain_attention_max_err_over_rms": err, "tolerance": tol,
          "plain_reference": "routed to the kernel run's experts" if moe else "its own",
          "tokens_compared": upto, "tokens_equal": same,
          "tokens_equal_all_steps": [t == r for t, r in zip(tokens, ref_rows)],
          "repeat_bitwise_equal": bitwise, **moe})
    check(routes == want and counts["flash_attention"] == sum(want.values()),
          f"{phase} {arch}: flash_attention ran as {routes}, not {want}")
    check(err <= tol, f"{phase} {arch}: the kernel path's teacher-forced logits are {err} "
                      f"of the row's RMS off the plain attention's (tolerance {tol})")
    check(all(same), f"{phase} {arch}: the kernel path's tokens differ from the plain "
                     f"attention's before a near-tie")
    check(bitwise, f"{phase} {arch}: two runs of the kernel path differ")
    # where the time goes: one prefill, then 8 decode ticks
    eng = engine.ServeEngine(cfg, params, batch_size=len(prompts), max_len=max_len,
                             device=DEVICE)
    reqs = [engine.Request(i, p, SERVE_NEW_TOKENS) for i, p in enumerate(prompts)]
    t0 = time.time()
    with torch.inference_mode():
        pre = profile_serve(lambda: eng.admit(reqs) or 1, "prefill")
        dec = profile_serve(lambda: sum(1 for _ in range(8) if eng.step() >= 0), "decode")
    del eng
    dec["host_ms_per_tick"] = dec["wall_ms"] / dec["calls"]
    walls["profiles"] = time.time() - t0
    for row in (pre, dec):
        emit({"phase": phase, "arch": arch, "profile": row})
    emit({"phase": phase, "arch": arch, "walls_s": walls})
    del params
    torch.cuda.empty_cache()
    return routes


def phase_serve() -> int:
    """The serving main path of gemma2-2b (serve_published): as published
    (26 layers, window 4,096), 4 prompts of 4,500-5,120 tokens; 26 wgmma
    flash launches a prefill.  Returns them."""
    return serve_published("serve", "gemma2-2b", SERVE_PROMPTS, SERVE_SEED).get("wgmma", 0)


def phase_serve_families() -> int:
    """The slice's main path (serve_published) for the moe, hybrid and ssm
    families: deepseek-moe-16b (28 wgmma flash launches a prefill),
    recurrentgemma-9b (12) and xlstm-1.3b (none), each as published, one
    after another, each freed before the next loads.  Returns the wgmma
    launches of their main-path runs."""
    import gc

    launches = 0
    for arch, lens in FAMILIES_SERVE:
        launches += serve_published("serve_families", arch, lens, SERVE_SEED).get("wgmma", 0)
        gc.collect()
    return launches


# ------------------------------------------------------------ training
TRAIN_REFERENCE = SRC / "repro_torch" / "launch" / "train_reference.json"
# phase 17's case, which tests/test_torch_train.py --write-train-reference
# runs through the JAX package: gemma2-2b at full width cut to one local
# and one global layer, a 128-token window, the weights of
# weights.numpy_params(cfg, seed) and the batches of pipeline.batch_at
TRAIN_CASE = {"arch": "gemma2-2b", "replace": {"n_layers": 2, "local_window": 128,
                                               "q_chunk": 128},
              "batch": 2, "seq": 256, "seed": 0, "steps": 3,
              "opt": {"lr": 1e-3, "warmup_steps": 1, "total_steps": 8}, "samples": 64}
# The float32 run against the JAX package's float32 run: both sum in
# float32 in another order (the CPU port reads TRAIN_READ_F32 in
# train_reference.json's "port_cpu"); a wrong term moves a leaf by its size.
# lr within one ulp.  "grad_entries" are the sampled entries' largest
# error in units of the leaf's RMS; "update_diff" the sampled estimate of
# ||dp_port - dp_jax|| / ||dp_jax|| of the update p_3 - p_0.
TRAIN_TOL = {"loss": 1e-4, "nll": 1e-4, "grad_norm": 1e-4, "lr_ulps": 1,
             "leaf_grad_norm": 1e-4, "grad_entries": 1e-3, "update_norm": 1e-4,
             "update_diff": 1e-3}
# The bfloat16 run against the JAX package's float32 run: each reading
# within BF16_SPREAD_FACTOR times the JAX package's own bfloat16 run's
# (recorded beside it), and never tighter than TRAIN_TOL
BF16_SPREAD_FACTOR = 2.0
# phase 18: gemma2-2b as published, through the driver as its CLI runs it
TRAIN_ARGV = ("--arch", "gemma2-2b", "--remat", "full", "--batch", "2", "--seq", "2048",
              "--steps", "10", "--cosim-epochs", "4", "--log-every", "1")
# the JAX driver's co-simulation flags of TRAIN_ARGV (its defaults:
# spine 1 killed, phi 2, 4 chunks)
TRAIN_COSIM = {"cosim_epochs": 4, "cosim_kill_spine": 1, "cosim_phi": 2, "n_chunks": 4}


def train_cfg(case: dict, dtype: str):
    from repro_torch.configs import registry

    return registry.get_config(case["arch"]).replace(dtype=dtype, **case["replace"])


def sample_index(name: str, size: int, n: int) -> np.ndarray:
    """``n`` fixed flat indices into a leaf of ``size`` entries, drawn from
    its name."""
    import zlib

    return np.random.default_rng(zlib.crc32(name.encode())).integers(0, size, n)


def leaf_readings(named: dict, n: int) -> dict:
    """Each leaf's size, norm (summed in float64) and entries at
    ``sample_index`` (name -> tensor, on any device)."""
    import torch

    out = {"size": {}, "norm": {}, "samples": {}}
    for name, t in sorted(named.items()):
        flat = t.detach().reshape(-1)
        out["size"][name] = flat.numel()
        out["norm"][name] = float(torch.linalg.vector_norm(flat, dtype=torch.float64))
        idx = torch.as_tensor(sample_index(name, max(flat.numel(), 1), n), device=flat.device)
        out["samples"][name] = flat[idx].double().cpu().tolist() if flat.numel() else []
    return out


def tree_leaf(tree: dict, name: str, i):
    """The leaf ``name`` (``weights.leaves``' names) of a JAX-layout tree,
    at superblock ``i`` of a stacked one."""
    parts = name.split(".")
    leaf = tree[name] if len(parts) == 1 else tree[parts[0]][int(parts[1])][parts[2]]
    return leaf if i is None else leaf[i]


def train_readings(cfg, case: dict, tree: dict, device, update=None, mesh=None,
                   plan=None) -> dict:
    """``case``'s steps of the port's train step
    (``launch.steps.make_train_step``; with a ``mesh``, its "seqbalance"
    pod step with ``plan``) from ``tree``'s weights on ``device``, float32
    products in full float32: each step's loss, nll, grad norm and lr and
    its gradients' ``leaf_readings`` (read by a probe around
    ``optimizer.update``: the masters' ``.grad``, or the pod step's mean
    gradients of member 0), then the update p_n - p_0 of each leaf.
    ``update`` stands in for ``optimizer.update`` (a planted fault)."""
    import torch

    from repro_torch.data import pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import weights
    from repro_torch.train import optimizer

    params = weights.from_jax_params(tree, cfg, device, trainable=True)
    state = {"params": params, "opt": optimizer.init(params)}
    step = steps.make_train_step(cfg, optimizer.AdamWConfig(**case["opt"]), mesh,
                                 "xla" if mesh is None else "seqbalance", plan)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, global_batch=case["batch"],
                               seq_len=case["seq"], seed=case["seed"])
    orig = optimizer.update
    real, grads, rows = update or orig, [], []

    def probe(g, st, p, c):
        if p is params:  # not another pod member's copy
            grads.append(leaf_readings(g if g is not None else weights.stacked(
                (name, i, torch.zeros_like(t) if t.grad is None else t.grad)
                for name, i, t in weights.leaves(p)), case["samples"]))
        return real(g, st, p, c)

    optimizer.update = probe
    try:
        with fa.full_fp32_matmul():
            for i in range(case["steps"]):
                state, m = step(state, pipeline.batch_at(dcfg, i, device=device))
                rows.append({**{k: float(v) for k, v in m.items()}, "grad": grads[-1]})
    finally:
        optimizer.update = orig
    delta = weights.stacked(
        (name, i, t.detach() - torch.from_numpy(np.asarray(tree_leaf(tree, name, i))).to(device))
        for name, i, t in weights.leaves(params))
    return {"steps": rows, "update": leaf_readings(delta, case["samples"])}


def ulps(got: float, want: float) -> float:
    want32 = np.float32(want)
    return float(abs(np.float32(got) - want32) / np.spacing(want32))


def train_agreement(got: dict, want: dict) -> dict:
    """The readings of ``got`` (``train_readings``) against ``want``'s, each
    the largest over steps and leaves (TRAIN_TOL's keys)."""

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    def entries(g, w, name):
        rms = w["norm"][name] / max(w["size"][name], 1) ** 0.5
        d = np.asarray(g["samples"][name]) - np.asarray(w["samples"][name])
        return d, max(rms, 1e-30)

    out = {k: max(rel(g[k], w[k]) for g, w in zip(got["steps"], want["steps"]))
           for k in ("loss", "nll", "grad_norm")}
    out["lr_ulps"] = max(ulps(g["lr"], w["lr"]) for g, w in zip(got["steps"], want["steps"]))
    out["leaf_grad_norm"] = max(rel(g["grad"]["norm"][n], w["grad"]["norm"][n])
                                for g, w in zip(got["steps"], want["steps"])
                                for n in w["grad"]["norm"] if w["grad"]["norm"][n])
    grad_e = [entries(g["grad"], w["grad"], n) for g, w in zip(got["steps"], want["steps"])
              for n in w["grad"]["norm"] if w["grad"]["norm"][n]]
    out["grad_entries"] = max(float(np.abs(d).max() / rms) for d, rms in grad_e)
    gu, wu = got["update"], want["update"]
    names = [n for n in wu["norm"] if wu["norm"][n]]
    out["update_norm"] = max(rel(gu["norm"][n], wu["norm"][n]) for n in names)
    out["update_diff"] = max(float(np.sqrt(np.mean(d ** 2)) / rms)
                             for d, rms in (entries(gu, wu, n) for n in names))
    return out


def bf16_limits(ref: dict) -> dict:
    """The bfloat16 run's limits: BF16_SPREAD_FACTOR times the JAX package's
    own bfloat16 run against its float32 run, at least TRAIN_TOL."""
    return {k: max(TRAIN_TOL[k], BF16_SPREAD_FACTOR * v) if k != "lr_ulps" else TRAIN_TOL[k]
            for k, v in ref["jax_bf16_spread"].items()}


def strip_builds(lines) -> list:
    """``[cosim]`` lines without their build counts: the JAX package's
    count the XLA programs it compiled, the port's the kernel libraries
    it built (none once phase 1 has)."""
    import re

    return [re.sub(r" builds \d+$", "", line) for line in lines]


def restart_check(device) -> dict:
    """REDUCED gemma2-2b in float32 (a state of a few MB) under
    ``torch.use_deterministic_algorithms(True)``: 6 steps straight against
    3, ``checkpoint.save``, ``restore`` into a fresh state (another seed)
    and 3 more; the metrics, params and moments must be equal bit for
    bit."""
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.train import checkpoint, optimizer

    cfg = registry.get_config("gemma2-2b", reduced=True).replace(dtype="float32")
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=32, seed=1)
    step = steps.make_train_step(cfg, optimizer.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                            total_steps=20))
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            state, straight = steps.init_state(cfg, 0, device=device), []
            for i in range(6):
                state, m = step(state, pipeline.batch_at(dcfg, i, device=device))
                straight.append({k: float(v) for k, v in m.items()})
                if i == 2:
                    checkpoint.save(tmp, 2, state)
            again = checkpoint.restore(tmp, 2, steps.init_state(cfg, 1, device=device))
            resumed = []
            for i in range(3, 6):
                again, m = step(again, pipeline.batch_at(dcfg, i, device=device))
                resumed.append({k: float(v) for k, v in m.items()})
    finally:
        torch.use_deterministic_algorithms(prev)
    a = {lid: checkpoint._host(leaf) for lid, leaf in checkpoint._leaves(state)}
    b = {lid: checkpoint._host(leaf) for lid, leaf in checkpoint._leaves(again)}
    differ = sorted(k for k in a if not np.array_equal(a[k], b[k]))
    return {"metrics_equal": resumed == straight[3:], "leaves": len(a),
            "leaves_differing": differ, "straight_losses": [r["loss"] for r in straight],
            "resumed_losses": [r["loss"] for r in resumed]}


def chunked_check(device) -> dict:
    """attention._sdpa_chunked, the training path above Q_CHUNK tokens,
    against _sdpa over the whole score matrix on the card, at gemma2-2b's
    heads (8 of 256 on 4 KV heads), S = 2,048 in chunks of 1,024, float32
    in full float32, with a window and without: values and the gradients
    of q, k and v, each by the norm of the difference over its own norm."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention

    cfg = registry.get_config("gemma2-2b")
    g = torch.Generator(device=device).manual_seed(5)
    S, out = 2048, {}
    q0 = torch.randn(1, S, 8, 256, generator=g, device=device)
    k0 = torch.randn(1, 4, S, 256, generator=g, device=device)
    v0 = torch.randn(1, 4, S, 256, generator=g, device=device)
    ct = torch.randn(1, S, 8, 256, generator=g, device=device)
    with fa.full_fp32_matmul():
        for window in (0, 1000):
            res = []
            for chunked in (True, False):
                q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
                o = (attention._sdpa_chunked(q, k, v, cfg, window) if chunked else
                     attention._sdpa(q, k, v, attention.causal_mask(S, window, device), cfg))
                (o * ct).sum().backward()
                res.append([o.detach(), q.grad, k.grad, v.grad])
            out[f"window_{window}"] = {
                name: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
                for name, a, b in zip(("out", "dq", "dk", "dv"), *res)}
    return out


def phase_train_ref() -> dict:
    """Phase 17: TRAIN_CASE's steps of the port's train step on the card
    in float32 and in bfloat16 (float32 masters) against the JAX
    package's float32 run (train_reference.json): the float32 run within
    TRAIN_TOL, the bfloat16 run within ``bf16_limits``; the restart check
    bit for bit (``restart_check``); the chunked attention against the
    whole score matrix (``chunked_check``).  No kernel launches: the train
    step runs the plain attention.  Returns the launch counts."""
    import gc

    import torch

    from repro_torch.models import weights

    ref = json.loads(TRAIN_REFERENCE.read_text())
    case = ref["case"]
    check(case == TRAIN_CASE, f"train_reference.json holds another case: {case}")
    reset_counts()
    tree = weights.numpy_params(train_cfg(case, "float32"), case["seed"])
    failures = []
    for dtype in ("float32", "bfloat16"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got = train_readings(train_cfg(case, dtype), case, tree, DEVICE)
        wall = time.time() - t0
        agree = train_agreement(got, ref["runs"]["float32"])
        limits = TRAIN_TOL if dtype == "float32" else bf16_limits(ref)
        failed = sorted(k for k in limits if not agree[k] <= limits[k])
        emit({"phase": "train_ref", "nvidia_smi": card_name(), "dtype": dtype,
              "against": "the JAX package's float32 run", "wall_s": wall,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "losses": [r["loss"] for r in got["steps"]],
              "jax_losses": [r["loss"] for r in ref["runs"]["float32"]["steps"]],
              "grad_norms": [r["grad_norm"] for r in got["steps"]],
              "agreement": agree, "limits": limits, "failed": failed,
              **({"jax_bf16_spread": ref["jax_bf16_spread"]} if dtype == "bfloat16" else {})})
        failures += [f"{dtype} {k}: {agree[k]} > {limits[k]}" for k in failed]
        del got
        gc.collect()
        torch.cuda.empty_cache()
    del tree
    restart = restart_check(DEVICE)
    chunked = chunked_check(DEVICE)
    counts = read_counts()
    emit({"phase": "train_ref", "restart": restart, "chunked_vs_whole": chunked,
          "kernel_launches": counts})
    check(not failures, f"train_ref: the port's train step disagrees with the JAX "
                        f"package's: {failures}")
    check(restart["metrics_equal"] and not restart["leaves_differing"],
          f"train_ref: a restarted run differs from the uninterrupted one: {restart}")
    worst = max(v for w in chunked.values() for v in w.values())
    check(worst <= 1e-5, f"train_ref: _sdpa_chunked lies {worst} off _sdpa: {chunked}")
    check(not any(counts.values()), f"train_ref: the train step launched kernels: {counts}")
    return counts


def param_count(cfg, active: bool = False) -> int:
    """Parameters of ``cfg``'s model, from its field tables; with ``active``
    an MoE unit's routed experts counted as the top-k at the capacity
    factor of them that a token's replicas run through."""
    from repro_torch.models import transformer

    prelude, sb, n_super, trailing = transformer.block_program(cfg)

    def unit(u, name, f):
        n = int(np.prod(f.shape))
        if active and u.kind == "moe" and name.startswith("we_"):
            m = cfg.moe
            n = n * m.top_k * m.capacity_factor / m.n_experts
        return n

    def units(us):
        return sum(unit(u, name, f) for u in us
                   for name, f in transformer.unit_shapes(cfg, u).items())

    n = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2) + cfg.d_model
    n += n_super * units(sb) + units(prelude + trailing)
    if cfg.is_encoder_decoder:
        eu, en = transformer.encoder_program(cfg)
        n += en * units(eu) + cfg.d_model
    return n


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of a train step: 6 N tokens (N the active parameters:
    ``param_count(active=True)``), plus attention's two products over the
    causal (windowed) query-key pairs, forward and backward (12 B H hd
    pairs a layer); remat's recomputation not counted."""
    from repro_torch.models import transformer

    prelude, sb, n_super, trailing = transformer.block_program(cfg)
    layers = [u for u in prelude + trailing if u.kind == "attn"]
    layers += [u for u in sb if u.kind == "attn"] * n_super
    pos = np.arange(seq)
    attn = sum(12 * batch * cfg.n_heads * cfg.hd
               * int(np.minimum(pos + 1, u.window or seq).sum()) for u in layers)
    return 6.0 * param_count(cfg, active=True) * batch * seq + attn


def attention_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of a prefill's self-attention, as the flash kernel does
    them: its two products, 4 B H hd a (query, key) pair that the mask
    keeps, over the causal (windowed) pairs of ``seq`` tokens in each
    decoder attention layer, and over every pair of the encoder's frames
    in each encoder layer (whisper-large-v3's non-causal encoder)."""
    from repro_torch.models import transformer

    prelude, sb, n_super, trailing = transformer.block_program(cfg)
    layers = [u for u in prelude + trailing if u.kind == "attn"]
    layers += [u for u in sb if u.kind == "attn"] * n_super
    pos = np.arange(seq)
    per_pair = 4 * batch * cfg.n_heads * cfg.hd
    total = sum(per_pair * int(np.minimum(pos + 1, u.window or seq).sum()) for u in layers)
    if cfg.is_encoder_decoder:
        eu, en = transformer.encoder_program(cfg)
        total += en * sum(u.kind == "attn" for u in eu) * per_pair * cfg.encoder_frames ** 2
    return float(total)


def prefill_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of a decoder-only prefill less its attention's products
    (``attention_flops``): 2 N tokens over the decoder's layers (N the
    active parameters less the embedding, the head and the final norm),
    plus the last position's logits, 2 B D V."""
    assert not cfg.is_encoder_decoder, cfg.name
    head = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2) + cfg.d_model
    n = param_count(cfg, active=True) - head
    return 2.0 * n * batch * seq + 2.0 * batch * cfg.d_model * cfg.vocab


def phase_train() -> int:
    """Phase 18, the slice's main path: ``repro_torch.launch.train`` as its
    CLI runs (TRAIN_ARGV): gemma2-2b as published (26 layers, window
    4,096, bfloat16 compute on float32 masters, remat "full"), B 2, S
    2,048 (the chunked attention), 10 steps, after a 4-epoch
    co-simulation whose epochs run the tiered kernel.  Gates: the
    ``[cosim]`` lines (but their build counts) and the final plan's
    inactive set equal to the JAX driver's (train_reference.json), one
    tiered launch a stepped step, no flash launch, every loss finite.
    Prints each step's wall, the optimizer's share of it (a probe that
    synchronizes the card around ``optimizer.update``), tokens/s, the
    model FLOPs of a step, peak memory and the loss curve.  Returns the
    tiered kernel's launches."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.netsim import compact
    from repro_torch.train import optimizer

    ref = json.loads(TRAIN_REFERENCE.read_text())["cosim"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(compact.run_core.counts)
    orig, update_s = optimizer.update, []

    def timed_update(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = orig(*a)
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t)
        return res

    reset_counts()
    t0 = time.time()
    optimizer.update = timed_update
    try:
        out = train.main([*TRAIN_ARGV, "--device", DEVICE])
    finally:
        optimizer.update = orig
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    loop = {k: compact.run_core.counts[k] - before[k] for k in before}
    peak = torch.cuda.max_memory_allocated()
    args = train.parser().parse_args(list(TRAIN_ARGV))
    cfg = registry.get_config(args.arch, reduced=args.reduced).replace(remat=args.remat)
    tokens = args.batch * args.seq
    walls = [r["wall_s"] for r in out["steps"]]
    steady = statistics.mean(walls[1:])
    flops = train_flops(cfg, args.batch, args.seq)
    losses = [r["loss"] for r in out["steps"]]
    emit({"phase": "train", "nvidia_smi": card_name(), "argv": list(TRAIN_ARGV),
          "arch": cfg.name, "n_layers": cfg.n_layers, "local_window": cfg.local_window,
          "dtype": cfg.dtype, "param_dtype": cfg.param_dtype, "remat": cfg.remat,
          "q_chunk": cfg.q_chunk, "params": param_count(cfg), "batch": args.batch,
          "seq": args.seq, "wall_s": wall, "step_walls_s": walls,
          "optimizer_update_s": update_s, "steady_step_s": steady,
          "tokens_per_s": tokens / steady,
          "model_flops_per_step": flops, "model_tflop_per_s": flops / steady / 1e12,
          "of_bf16_peak": flops / steady / BF16_FLOP_PER_S,
          "peak_memory_gb": peak / 1e9, "losses": losses,
          "grad_norms": [r["grad_norm"] for r in out["steps"]],
          "lrs": [r["lr"] for r in out["steps"]], "cosim": out["cosim"],
          "jax_cosim": ref["lines"], "plan_inactive": list(out["plan"].inactive),
          "kernel_launches": counts, "cosim_loop": loop})
    check(strip_builds(out["cosim"]) == strip_builds(ref["lines"]),
          f"train: the [cosim] lines differ from the JAX driver's: {out['cosim']}")
    check(list(out["plan"].inactive) == ref["inactive"],
          f"train: the final plan's inactive set {out['plan'].inactive} is not the JAX "
          f"driver's {ref['inactive']}")
    check_launches("train", "ecmp", counts["cascade_tiered"], loop)
    check(counts["cascade_tiered"] > 0, "train: the co-simulation ran no tiered kernel")
    check(counts["flash_attention"] == 0,
          f"train: the train step launched flash_attention {counts['flash_attention']} times")
    check(len(losses) == args.steps and all(np.isfinite(losses)),
          f"train: losses {losses}")
    return counts["cascade_tiered"]


# ------------------------------------------------------------ grad sync
GRAD_SYNC_REFERENCE = SRC / "repro_torch" / "dist" / "grad_sync_reference.json"
WIRES = ("float32", "bfloat16", "int8")
# phase 19: the ring on the card, every (members, wire, plan), each member
# GRAD_SYNC_MEMBER entries (a size that needs padding at every ring size)
GRAD_SYNC_RINGS = [(n, wire, plan) for n in (2, 4, 8) for wire in WIRES
                   for plan in ("default", "inactive", "pinned")]
GRAD_SYNC_MEMBER = 10_007
RING_SAMPLES = 64
# phase 19's timed leaf: gemma2-2b's tied embedding [256,000, 2,304], its
# largest gradient leaf (2.36 GB a member in float32), at 2 and 4 members
GRAD_SYNC_TIMED = (256_000, 2_304)
GRAD_SYNC_TIMED_MEMBERS = (2, 4)
# phase 20: phase 17's case over a pod axis (B 4: a share of 2 a member at
# 2 pods), which tests/test_torch_grad_sync.py --write-grad-sync-reference
# runs through the JAX package's pod step on forced host devices; at full
# width 2 pods on the float32 and the int8 wire (the JAX package keeps a
# replica of the state on each forced device: 4 pods at full width would
# take about 48 GB on the host), and 4 pods on the int8 wire at REDUCED
# width (both ring directions reach other members from 3 on)
GRAD_SYNC_CASE = {**TRAIN_CASE, "batch": 4, "chunks": 4,
                  "runs": [{"name": "2pods-float32", "pods": 2, "wire": "float32",
                            "reduced": False},
                           {"name": "2pods-int8", "pods": 2, "wire": "int8", "reduced": False},
                           {"name": "4pods-int8-reduced", "pods": 4, "wire": "int8",
                            "reduced": True}]}
# phase 20's limits: TRAIN_TOL on the float32 wire; on a lossy wire its
# loss, nll, norms and lr only.  There a ulp between two right float sums
# of a member's gradient can cross a rounding tie of the wire, which moves
# an entry by a whole quantum (an int8 scale is a segment's absmax / 127,
# many RMS of a sparse leaf such as the embedding), and AdamW turns that
# into +-lr: the port on the CPU reads 0.065 RMS in the sampled entries
# and 5.5e-3 in the update's difference at full width on the int8 wire,
# while its norms hold TRAIN_TOL and every planted fault moves them
# (grad_sync_reference.json, "port_cpu" and "planted")
LOSSY_WIRE_KEYS = ("loss", "nll", "grad_norm", "lr_ulps", "leaf_grad_norm", "update_norm")


def grad_sync_limits(run: dict) -> dict:
    keys = TRAIN_TOL if run["wire"] == "float32" else LOSSY_WIRE_KEYS
    return {k: TRAIN_TOL[k] for k in keys}


# phase 21: the driver as its CLI runs, gemma2-2b as published over 2 pods
# on this one card (one row a member), after phase 18's co-simulation
TRAIN_SYNC_ARGV = ("--arch", "gemma2-2b", "--remat", "full", "--batch", "2", "--seq", "2048",
                   "--steps", "5", "--cosim-epochs", "4", "--log-every", "1",
                   "--grad-sync", "seqbalance", "--pods", "2")
# phase 22: the port's dry run of these cells on both production meshes,
# against the JAX package's run_cell of the same cells
# (src/repro_torch/launch/dryrun_reference.json; tests/test_torch_dryrun.py)
DRYRUN_CELLS = (("gemma2-2b", "train_4k"), ("gemma2-2b", "prefill_32k"),
                ("gemma2-2b", "decode_32k"), ("deepseek-moe-16b", "train_4k"),
                ("recurrentgemma-9b", "train_4k"), ("xlstm-1.3b", "prefill_32k"),
                ("qwen3-32b", "prefill_32k"))
DRYRUN_REFERENCE = SRC / "repro_torch" / "launch" / "dryrun_reference.json"
# the port's FLOPs a device (less the flash kernel's: XLA's count of the JAX
# package's Pallas call holds none of it) over the JAX package's: within a
# factor of DRYRUN_FLOPS_LIMIT, on every cell.  XLA's cost analysis of these
# programs reads low and unevenly (gemma2-2b prefill_32k: 1.45e12 a device on
# 256 devices and 6.67e12 on 512; train_4k 2.2e13, a third of 6 N tokens /
# 256), so the port's ratios spread over a decade (dryrun_reference.json's
# "flops_ratio"), while a product left unsharded moves a count 16 or 256
# times
DRYRUN_FLOPS_LIMIT = 20.0
# cells whose JAX count XLA takes from one layer: their FLOPs (less the
# flash kernel's) are held instead within DRYRUN_PREFILL_RECKONING_LIMIT of
# the model's own count a device (``prefill_flops``).  qwen3-32b's 64
# layers run as one scan, whose body XLA's cost analysis counts once:
# 4.29e12 a device at 16 x 16 against the model's 2.56e14
DRYRUN_FLOPS_FROM_MODEL = (("qwen3-32b", "prefill_32k"),)
DRYRUN_PREFILL_RECKONING_LIMIT = 1.25
# a train cell's FLOPs a device over the model's own count of the step
# (``train_flops``: 6 N_active tokens, the routed experts at the capacity
# factor, plus causal attention; remat's recompute not counted) over the
# devices: printed on every train cell, held on the MoE cells, whose weight
# gradients DTensor left unsplit over "model" until the products were laid
# out as their weights (``common.matmul``)
DRYRUN_MOE_RECKONING_LIMIT = 2.0
# every cell's collective bytes a device over the JAX package's (coll_x,
# each collective's result on one device): within this factor.  The MoE
# dispatch and combine gathered every token and every expert's slots whole
# on each device (40.1x / 28.7x), gemma2-2b's decode gathered the KV cache
# to the query's layout (8.0x / 4.0x), its prefill moved the filled cache by
# gathering the whole batch (5.7x / 1.9x), xlstm-1.3b's mLSTM ran its scan
# whole on every "model" rank (29.8x / 14.5x) and its sLSTM reduced its
# float32 gate inputs (6.5x / 3.4x), qwen3-32b's prefill reduced q and k
# whole in float32 for its qk-norm and again for a flash attention
# replicated over "model" (8.9x), until each was repaired
DRYRUN_COLL_LIMIT = 3.0
# a prefill cell's flash FLOPs on rank 0 and on the last rank over the
# model's own attention count a device (``attention_flops`` over the
# devices): within this factor either way.  Where the heads do not split
# over "model", every "model" rank attended its data rank's whole rows (16x)
DRYRUN_FLASH_LIMIT = 1.25


def ring_plan(mod, name: str, wire: str):
    """Phase 19's plans, as ``mod`` (either package's collectives) builds
    them: the default (1, -1), one of two paths quarantined, and a
    ``PinnedPlan`` from ``replan_chunk_paths`` (path 0 of four down: its
    chunk moves to path 2, of its direction)."""
    if name == "default":
        return mod.PathPlan(n_chunks=4, wire_dtype=wire)
    if name == "inactive":
        return mod.PathPlan(n_chunks=4, directions=(1, -1), inactive=(True, False),
                            wire_dtype=wire)
    dirs, down = (1, -1, 1, -1), (True, False, False, False)
    return mod.PinnedPlan(n_chunks=4, directions=dirs, inactive=down,
                          paths=mod.replan_chunk_paths((0, 1, 2, 3), dirs, down), wire_dtype=wire)


def ring_inputs(n: int, size: int, seed: int) -> np.ndarray:
    """[n, size] float32, each member at its own magnitude (1e-2 to 1e2),
    so that the int8 wire's scales differ between members."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-2, 2, (n, 1))
    return (rng.standard_normal((n, size)) * mag).astype(np.float32)


def ring_case(k: int):
    """Phase 19's case k: (members, wire, plan name, inputs, sample index)."""
    n, wire, plan = GRAD_SYNC_RINGS[k]
    return (n, wire, plan, ring_inputs(n, GRAD_SYNC_MEMBER, 2000 + k),
            sample_index(f"ring{k}", GRAD_SYNC_MEMBER, RING_SAMPLES))


def differing_bits(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.count_nonzero(a.view(np.uint32) != b.view(np.uint32)))


def ring_check(k: int, got: np.ndarray, cpu: np.ndarray, jax_samples, scales: list,
               rounds: int) -> dict:
    """Phase 19's readings of case k's card output: bits differing from the
    port's CPU run and from the JAX package's sampled outputs, the error
    against the exact sum and its limit, the rounds."""
    n, wire, plan, x, idx = ring_case(k)
    exact = x.astype(np.float64).sum(0)
    absmax = float(np.abs(exact).max())
    # float32: 1e-6 of the sum's absmax; bfloat16: tests/test_collectives.py:66;
    # int8: one rounding of at most half a scale a round, n of them at most
    limit = {"float32": 1e-6 * absmax, "bfloat16": 2e-2 * absmax,
             "int8": n * max(scales or [0.0]) / 2}[wire]
    return {"members": n, "wire": wire, "plan": plan,
            "bits_off_cpu": differing_bits(got, cpu),
            "bits_off_jax_samples": differing_bits(got[:, idx],
                                                   np.asarray(jax_samples, np.float32)),
            "max_abs_err": float(np.abs(got - exact[None]).max()), "limit": limit,
            "rounds": rounds, "rounds_expected": 2 * (n - 1) * 4}


def phase_grad_sync() -> dict:
    """Phase 19: ``dist.collectives.seqbalance_all_reduce`` on the card (a
    ``LocalAxis``: every member on the one device): each of GRAD_SYNC_RINGS
    against the port's CPU run of the same inputs and the JAX package's
    sampled outputs (grad_sync_reference.json), bit for bit, within its
    wire's error of the exact sum, and 2 (n - 1) rounds a chunk; then
    gemma2-2b's embedding gradient at 2 and 4 members, the ring and
    ``baseline_all_reduce`` timed against the bytes bound.  No kernel
    launches (the ring is PyTorch arithmetic and a roll).  Returns the
    launch counts."""
    import torch

    from repro_torch.dist import collectives as coll

    ref = json.loads(GRAD_SYNC_REFERENCE.read_text())["rings"]
    reset_counts()
    failures, orig = [], coll.quantize_int8
    for k in range(len(GRAD_SYNC_RINGS)):
        n, wire, plan_name, x, _ = ring_case(k)
        plan = ring_plan(coll, plan_name, wire)
        scales = []

        def probe(v, dim=None):
            q, scale = orig(v, dim)
            scales.append(float(scale.max()))
            return q, scale

        coll.permute_rounds = 0
        coll.quantize_int8 = probe
        try:
            got = coll.seqbalance_all_reduce(torch.from_numpy(x).to(DEVICE),
                                             coll.LocalAxis(n, DEVICE), plan).cpu().numpy()
        finally:
            coll.quantize_int8 = orig
        rounds = coll.permute_rounds
        cpu = coll.seqbalance_all_reduce(torch.from_numpy(x), coll.LocalAxis(n, "cpu"),
                                         plan).numpy()
        row = ring_check(k, got, cpu, ref[k]["samples"], scales, rounds)
        emit({"phase": "grad_sync", **row})
        if (row["bits_off_cpu"] or row["bits_off_jax_samples"] or not row["max_abs_err"]
                <= row["limit"] or rounds != row["rounds_expected"]):
            failures.append(row)
    timed = []
    for n in GRAD_SYNC_TIMED_MEMBERS:
        g = torch.Generator(device=DEVICE).manual_seed(n)
        x = torch.randn((n, *GRAD_SYNC_TIMED), generator=g, device=DEVICE)
        axis = coll.LocalAxis(n, DEVICE)
        torch.cuda.reset_peak_memory_stats()
        ring_ms = time_ms(lambda: coll.seqbalance_all_reduce(x, axis), reps=1, rounds=3, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        base_ms = time_ms(lambda: coll.baseline_all_reduce(x, axis), reps=1, rounds=3, warmup=1)
        moved = 2 * nbytes(x)  # every member's leaf read once, its sum written once
        bound_ms, by = bound(moved, (n - 1) * x[0].numel())
        row = {"phase": "grad_sync", "nvidia_smi": card_name(), "leaf": list(GRAD_SYNC_TIMED),
               "members": n, "plan": "PathPlan() (4 chunks, float32 wire)", "ring_ms": ring_ms,
               "baseline_ms": base_ms, "hbm_bytes": moved, "bound_ms": bound_ms,
               "bound_by": by, "ring_of_bound": bound_ms / ring_ms,
               "baseline_of_bound": bound_ms / base_ms, "peak_memory_gb": peak / 1e9}
        emit(row)
        timed.append(row)
        del x
        torch.cuda.empty_cache()
    counts = read_counts()
    check(not failures, f"grad_sync: the ring on the card disagrees: {failures}")
    check(not any(counts.values()), f"grad_sync: the ring launched kernels: {counts}")
    return counts


def grad_sync_cfg(case: dict, run: dict):
    """A run's config: ``case``'s cut of the published model, or at
    REDUCED width in float32."""
    from repro_torch.configs import registry

    if run["reduced"]:
        return registry.get_config(case["arch"], reduced=True).replace(dtype="float32")
    return train_cfg(case, "float32")


def grad_sync_readings(case: dict, run: dict, device, step_fn=None) -> dict:
    """``train_readings`` of one of GRAD_SYNC_CASE's runs (its pods, wire
    and config) through the pod step on a "local" mesh on ``device``, with
    the rounds it ran."""
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import weights

    cfg = grad_sync_cfg(case, run)
    tree = weights.numpy_params(cfg, case["seed"])
    coll.permute_rounds = 0
    plan = coll.PathPlan(n_chunks=case["chunks"], wire_dtype=run["wire"])
    mesh = mesh_mod.make_pod_mesh(run["pods"], device=device)
    if step_fn is None:
        out = train_readings(cfg, case, tree, device, mesh=mesh, plan=plan)
    else:  # a planted fault in the step
        from repro_torch.launch import steps

        orig, steps.make_train_step = steps.make_train_step, step_fn
        try:
            out = train_readings(cfg, case, tree, device, mesh=mesh, plan=plan)
        finally:
            steps.make_train_step = orig
    return {**out, "rounds": coll.permute_rounds}


def rounds_of(cfg, steps_run: int, pods: int, chunks: int) -> int:
    """The ring's rounds in ``steps_run`` pod steps: 2 (n - 1) a chunk of
    every leaf."""
    from repro_torch.dist import sharding

    return steps_run * len(sharding.param_shapes(cfg)) * chunks * 2 * (pods - 1)


def phase_train_sync_ref() -> dict:
    """Phase 20: GRAD_SYNC_CASE's runs of the pod step on the card against
    the JAX package's pod step (grad_sync_reference.json) within
    ``grad_sync_limits``, the rounds each ran, and the float32-wire run's loss
    against the port's single-device step on the same B 4 batches.  No
    kernel launches.  Returns the launch counts."""
    import gc

    import torch

    from repro_torch.models import weights

    ref = json.loads(GRAD_SYNC_REFERENCE.read_text())
    case = ref["case"]
    check(case == GRAD_SYNC_CASE, f"grad_sync_reference.json holds another case: {case}")
    reset_counts()
    failures = []
    for run in case["runs"]:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got = grad_sync_readings(case, run, DEVICE)
        wall = time.time() - t0
        agree = train_agreement(got, ref["runs"][run["name"]])
        cfg = grad_sync_cfg(case, run)
        limits = grad_sync_limits(run)
        want_rounds = rounds_of(cfg, case["steps"], run["pods"], case["chunks"])
        row = {"phase": "train_sync_ref", "nvidia_smi": card_name(), **run,
               "against": "the JAX package's pod step", "wall_s": wall,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "losses": [r["loss"] for r in got["steps"]],
               "jax_losses": [r["loss"] for r in ref["runs"][run["name"]]["steps"]],
               "agreement": agree, "limits": limits, "rounds": got["rounds"],
               "rounds_expected": want_rounds,
               "failed": sorted(k for k in limits if not agree[k] <= limits[k])}
        failures += [f"{run['name']} {k}: {agree[k]} > {limits[k]}" for k in row["failed"]]
        if got["rounds"] != want_rounds:
            failures.append(f"{run['name']}: {got['rounds']} rounds, not {want_rounds}")
        if run["wire"] == "float32":
            single = train_readings(cfg, case, weights.numpy_params(cfg, case["seed"]), DEVICE)
            own = train_agreement(got, single)
            row["against_single_device_step"] = own
            if not own["loss"] <= TRAIN_TOL["loss"]:
                failures.append(f"{run['name']}: loss {own['loss']} off the single-device step")
            del single
        emit(row)
        del got
        gc.collect()
        torch.cuda.empty_cache()
    counts = read_counts()
    check(not failures, f"train_sync_ref: the pod step disagrees: {failures}")
    check(not any(counts.values()), f"train_sync_ref: the pod step launched kernels: {counts}")
    return counts


def phase_train_sync(step0_loss: float) -> int:
    """Phase 21: ``repro_torch.launch.train`` as its CLI runs
    (TRAIN_SYNC_ARGV): gemma2-2b as published over 2 pods on the card,
    one row a member, the grad sync through the ring with the
    co-simulation's plan.  Gates: every loss finite; step 0's loss (before
    any update) within phase 17's bfloat16 loss limit (``bf16_limits``) of
    phase 18's one-device step 0 (``step0_loss``); the ``[cosim]`` lines
    and the final plan the JAX driver's (train_reference.json); the ring's
    rounds; one tiered launch a stepped step, no flash launch.  Prints each
    step's wall, tokens/s, the grad sync's synchronized share of a step
    (a probe around each leaf's ``tree_all_reduce_mean``) and the peak
    memory.  Returns the tiered kernel's launches."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import train
    from repro_torch.netsim import compact

    ref = json.loads(TRAIN_REFERENCE.read_text())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(compact.run_core.counts)
    orig, sync_s = coll.tree_all_reduce_mean, []

    def timed_sync(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = orig(*a)
        torch.cuda.synchronize()
        sync_s.append(time.perf_counter() - t)
        return res

    reset_counts()
    coll.permute_rounds = 0
    t0 = time.time()
    coll.tree_all_reduce_mean = timed_sync
    try:
        out = train.main([*TRAIN_SYNC_ARGV, "--device", DEVICE])
    finally:
        coll.tree_all_reduce_mean = orig
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    rounds = coll.permute_rounds
    loop = {k: compact.run_core.counts[k] - before[k] for k in before}
    peak = torch.cuda.max_memory_allocated()
    args = train.parser().parse_args(list(TRAIN_SYNC_ARGV))
    cfg = registry.get_config(args.arch, reduced=args.reduced)
    want_rounds = rounds_of(cfg, args.steps, args.pods, out["plan"].n_chunks)
    leaves = len(sync_s) // max(args.steps, 1)
    per_step = [sum(sync_s[i * leaves:(i + 1) * leaves]) for i in range(args.steps)]
    walls = [r["wall_s"] for r in out["steps"]]
    steady = statistics.mean(walls[1:])
    losses = [r["loss"] for r in out["steps"]]
    limit = bf16_limits(ref)["loss"]
    step0_rel = abs(losses[0] - step0_loss) / abs(step0_loss)
    emit({"phase": "train_sync", "nvidia_smi": card_name(), "argv": list(TRAIN_SYNC_ARGV),
          "arch": cfg.name, "pods": out["pods"], "plan": repr(out["plan"]), "wall_s": wall,
          "step_walls_s": walls, "steady_step_s": steady,
          "tokens_per_s": args.batch * args.seq / steady, "grad_sync_s": per_step,
          "grad_sync_share": [a / b for a, b in zip(per_step[1:], walls[1:])],
          "peak_memory_gb": peak / 1e9, "losses": losses,
          "grad_norms": [r["grad_norm"] for r in out["steps"]],
          "step0_loss_one_device": step0_loss, "step0_rel": step0_rel, "step0_limit": limit,
          "rounds": rounds, "rounds_expected": want_rounds, "cosim": out["cosim"],
          "kernel_launches": counts, "cosim_loop": loop})
    check(out["pods"] == args.pods, f"train_sync: the driver ran {out['pods']} pods")
    check(len(losses) == args.steps and all(np.isfinite(losses)), f"train_sync: losses {losses}")
    check(step0_rel <= limit, f"train_sync: step 0's loss {losses[0]} lies {step0_rel} off "
                              f"the one-device step's {step0_loss} (limit {limit})")
    check(strip_builds(out["cosim"]) == strip_builds(ref["cosim"]["lines"]),
          f"train_sync: the [cosim] lines differ from the JAX driver's: {out['cosim']}")
    check(list(out["plan"].inactive) == ref["cosim"]["inactive"],
          f"train_sync: the final plan's inactive set {out['plan'].inactive}")
    check(rounds == want_rounds, f"train_sync: {rounds} ring rounds, not {want_rounds}")
    check_launches("train_sync", "ecmp", counts["cascade_tiered"], loop)
    check(counts["flash_attention"] == 0,
          f"train_sync: the train step launched flash_attention {counts['flash_attention']} times")
    return counts["cascade_tiered"]


def last_rank_flash(arch: str, shape: str, label: str, multi: bool) -> float:
    """The flash FLOPs of the cell's last rank (its last "model" member), in
    a fake group of its own (the dry run reads one rank: rank 0's)."""
    import torch

    from repro_torch.launch import dryrun, mesh as tmesh

    if torch.distributed.is_initialized():  # the rank-0 group of the trace before
        torch.distributed.destroy_process_group()
    dryrun.forget_meshes()
    size = tmesh.make_production_mesh(multi_pod=multi).size
    try:
        return dryrun.run_cell(arch, shape, label, device=DEVICE, mesh=tmesh.fake_production_mesh(
            multi_pod=multi, rank=size - 1))["flash_flops"]
    finally:
        torch.distributed.destroy_process_group()
        dryrun.forget_meshes()


def phase_dryrun(cells=DRYRUN_CELLS, name: str = "dryrun") -> dict:
    """Phase 22: the port's dry run of ``cells`` (of DRYRUN_CELLS; the
    phase's lines named ``name``) on both production meshes, on fake
    tensors on the card, against the JAX package's run_cell of the same
    cells (DRYRUN_REFERENCE).  Gates: every cell OK; its
    argument bytes equal to ``dryrun.expected_argument_bytes`` and the JAX
    package's to the same count in its own layout; a cell's FLOPs (less
    the flash kernel's) within a factor DRYRUN_FLOPS_LIMIT of the JAX
    package's (where its cell is OK; a cell of DRYRUN_FLOPS_FROM_MODEL
    within DRYRUN_PREFILL_RECKONING_LIMIT of ``prefill_flops`` a device
    instead), and an MoE train cell's within
    DRYRUN_MOE_RECKONING_LIMIT of ``train_flops`` a device; a prefill
    cell's flash FLOPs on rank 0 and on its last rank within
    DRYRUN_FLASH_LIMIT of ``attention_flops`` a device (either way); every
    cell's collective bytes within DRYRUN_COLL_LIMIT of the JAX package's;
    nothing allocated on the card; no kernel launched; every cell's peak
    within the card's memory less SHARD_RANK_MARGIN (phase 23 runs a rank
    of some).  Every cell's
    collective ratio beside its FLOPs ratio, and its peak beside the
    card's memory, printed.  Returns the launch counts and each cell's
    peak bytes (phase 23 reads the train_4k cells of gemma2-2b and of
    SHARD_RANK_ARCHS)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun, mesh as tmesh

    ref = json.loads(DRYRUN_REFERENCE.read_text())
    check([tuple(c) for c in ref["cells"]] == list(DRYRUN_CELLS),
          f"dryrun_reference.json holds other cells: {ref['cells']}")
    card = torch.cuda.get_device_properties(0).total_memory
    reset_counts()
    allocated = torch.cuda.memory_allocated()
    failures, peaks = [], {}
    for label, multi in dryrun.MESHES.items():
        mesh = tmesh.fake_production_mesh(multi_pod=multi)
        for arch, shape in cells:
            key = f"{label}/{arch}/{shape}"
            try:
                rec = dryrun.run_cell(arch, shape, label, device=DEVICE, mesh=mesh)
            except Exception as e:  # recorded as the JAX package's dry run records it
                import traceback

                rec = {"status": "FAIL", "error": f"{type(e).__name__}: {e}"[:2000],
                       "trace": traceback.format_exc()[-2000:]}
            want = ref["jax"][key]
            row = {"phase": "dryrun_cell", "cell": key, "status": rec["status"]}
            if rec["status"] != "OK":
                failures.append(f"{key}: {rec['status']} {rec.get('error', '')[:300]}")
                emit({**row, **rec})
                continue
            cfg, cell = registry.get_config(arch), registry.get_shape(shape)
            expected = dryrun.expected_argument_bytes(cfg, cell, mesh)
            expected_jax = dryrun.expected_argument_bytes(cfg, cell, mesh, "jax")
            peaks[key] = rec["peak_bytes"]
            row.update(trace_s=rec["trace_s"], argument_size_bytes=rec["argument_size_bytes"],
                       expected=expected, jax_status=want.get("status"),
                       jax_argument_size_bytes=want.get("argument_size_bytes"),
                       expected_jax=expected_jax, flops=rec["flops"],
                       jax_flops=want.get("flops"), peak_bytes=rec["peak_bytes"],
                       jax_peak_bytes=want.get("peak_bytes"),
                       jax_temp_size_bytes=want.get("temp_size_bytes"),
                       collectives=rec["collectives"], jax_collectives=want.get("collectives"),
                       bytes_accessed=rec["bytes_accessed"],
                       jax_bytes_accessed=want.get("bytes_accessed"),
                       card_memory_bytes=card, peak_over_card=rec["peak_bytes"] / card,
                       coll_x=rec["coll_x"], jax_coll_x=want.get("coll_x"))
            if rec["argument_size_bytes"] != expected:
                failures.append(f"{key}: {rec['argument_size_bytes']} argument bytes, "
                                f"not {expected}")
            row["peak_limit"] = card - SHARD_RANK_MARGIN
            if rec["peak_bytes"] > card - SHARD_RANK_MARGIN:
                failures.append(f"{key}: {rec['peak_bytes'] / 1e9} GB at the peak, over "
                                f"the card's memory less {SHARD_RANK_MARGIN / 1e9} GB")
            if cell.kind == "train":
                reckoned = train_flops(cfg, cell.global_batch, cell.seq_len) / mesh.size
                row.update(reckoned_flops=reckoned, flops_over_reckoning=rec["flops"] / reckoned)
                if cfg.family == "moe" and rec["flops"] > DRYRUN_MOE_RECKONING_LIMIT * reckoned:
                    failures.append(f"{key}: FLOPs {rec['flops']:.4g}, over "
                                    f"{DRYRUN_MOE_RECKONING_LIMIT} x {reckoned:.4g}")
            reckoned = attention_flops(cfg, cell.global_batch, cell.seq_len) / mesh.size
            if cell.kind == "prefill" and reckoned:
                last = last_rank_flash(arch, shape, label, multi)
                mesh = tmesh.fake_production_mesh(multi_pod=multi)
                row.update(reckoned_attention_flops=reckoned,
                           flash_over_reckoning=rec["flash_flops"] / reckoned,
                           last_rank_flash_over_reckoning=last / reckoned)
                for who in ("flash_over_reckoning", "last_rank_flash_over_reckoning"):
                    if not 1 / DRYRUN_FLASH_LIMIT <= row[who] <= DRYRUN_FLASH_LIMIT:
                        failures.append(f"{key}: {who} {row[who]:.4g}, outside "
                                        f"{DRYRUN_FLASH_LIMIT}")
            if want.get("status") == "OK":
                ratio = (rec["flops"] - rec["flash_flops"]) / want["flops"]
                limit = DRYRUN_COLL_LIMIT
                row.update(flops_ratio=ratio, coll_ratio=rec["coll_x"] / want["coll_x"],
                           coll_limit=limit)
                if row["coll_ratio"] > limit:
                    failures.append(f"{key}: collectives {row['coll_ratio']:.4g} x the JAX "
                                    f"package's, over {limit}")
                if want["argument_size_bytes"] != expected_jax:
                    failures.append(f"{key}: the JAX package's {want['argument_size_bytes']} "
                                    f"argument bytes, not its layout's {expected_jax}")
                if ((arch, shape) not in DRYRUN_FLOPS_FROM_MODEL
                        and not 1 / DRYRUN_FLOPS_LIMIT <= ratio <= DRYRUN_FLOPS_LIMIT):
                    failures.append(f"{key}: FLOPs {ratio} of the JAX package's")
            if (arch, shape) in DRYRUN_FLOPS_FROM_MODEL:
                model = prefill_flops(cfg, cell.global_batch, cell.seq_len) / mesh.size
                row["flops_over_model"] = (rec["flops"] - rec["flash_flops"]) / model
                limit = DRYRUN_PREFILL_RECKONING_LIMIT
                if not 1 / limit <= row["flops_over_model"] <= limit:
                    failures.append(f"{key}: FLOPs {row['flops_over_model']:.4g} of the "
                                    f"model's, outside {limit}")
            emit(row)
    torch.distributed.destroy_process_group()
    counts = read_counts()
    emit({"phase": name, "nvidia_smi": card_name(), "cells": len(peaks),
          "peak_bytes": peaks, "allocated_before": allocated,
          "allocated_after": torch.cuda.memory_allocated(), "kernel_launches": counts})
    check(torch.cuda.memory_allocated() == allocated,
          "dryrun: the fake tensors allocated memory on the card")
    check(not failures, f"dryrun: {failures}")
    check(not any(counts.values()), f"dryrun: kernels launched: {counts}")
    return counts


SHARD_RANK_STEPS = 3  # phase 23
# phase 23 runs rank 0 of a train_4k cell of SHARD_RANK_ARCHS where phase
# 22's peak for it leaves this much of the card's memory free (and phase
# 22 fails a train cell that does not)
SHARD_RANK_MARGIN = 4e9
# (arch, the phase's name), run one after the other
SHARD_RANK_ARCHS = (("deepseek-moe-16b", "shard_rank_moe"),
                    ("recurrentgemma-9b", "shard_rank_recurrent"))


def rank_params(cfg, mesh, seed: int = 0):
    """Rank 0's float32 masters of ``cfg`` sharded over ``mesh`` (a fake
    group), built leaf by leaf: each leaf drawn whole on the card (random,
    from ``seed``: ``common.dense_init`` over its next-to-last dim, norm
    scales zero), its block kept, the whole freed.  The masters of a
    published MoE model (deepseek-moe-16b's 66 GB) are never whole on the
    card at once."""
    import torch
    from torch import nn

    from repro_torch.dist import sharding
    from repro_torch.models import common, model, weights

    dense = common.dense_init
    # the tree's structure on the meta device; norm scales and the like on the CPU
    common.dense_init = lambda shape, generator, fan_in=None, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device="meta")
    try:
        params = model.init_params(cfg, seed, device="cpu", trainable=True)
    finally:
        common.dense_init = dense
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    specs = sharding.param_specs(cfg, mesh)
    for name, _, module, attr in weights.slots(params):
        p = module._parameters[attr]
        whole = (dense(tuple(p.shape), g, p.shape[-2] if p.dim() > 1 else 1) if p.is_meta
                 else p.detach().to(DEVICE))
        module._parameters[attr] = nn.Parameter(
            sharding.distribute(whole, mesh, sharding.port_spec(name, specs[name])))
        del whole
    return params


def phase_shard_rank(predicted_peak: float, arch: str = "gemma2-2b",
                     label: str = "single_pod_16x16", name: str = "shard_rank") -> dict:
    """Phase 23: rank 0 of ``arch`` train_4k at ``label``'s sharding (16 x 16
    or 2 x 16 x 16, a fake group of 256 or 512), real tensors on the card:
    the state built leaf by leaf (``rank_params``; the moments made from
    the sharded masters), then SHARD_RANK_STEPS steps of
    ``launch.steps.make_train_step`` on this rank's share of the global
    batch, remat "dots".  Prints each step's wall (this rank's compute:
    the fake collectives move nothing) and the steps' peak memory beside
    ``predicted_peak`` (phase 22's peak_bytes of the cell) and the card's
    memory; fails if it does not fit.  The loss is garbage (the fake
    collectives) and is not checked.  Returns the launch counts."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data import pipeline
    from repro_torch.dist import sharding
    from repro_torch.launch import dryrun, mesh as tmesh, steps
    from repro_torch.train import optimizer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = tmesh.fake_production_mesh(multi_pod=dryrun.MESHES[label])
    cfg = registry.get_config(arch).replace(remat="dots")
    cell = registry.get_shape("train_4k")
    t0 = time.time()
    params = rank_params(cfg, mesh)
    state = {"params": params, "opt": optimizer.init(params)}
    torch.cuda.synchronize()
    build_s, build_peak = time.time() - t0, torch.cuda.max_memory_allocated()
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, global_batch=cell.global_batch,
                               seq_len=cell.seq_len, seed=0)
    step = steps.make_train_step(cfg, optimizer.AdamWConfig(), mesh, "xla")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    walls, losses = [], []
    for i in range(SHARD_RANK_STEPS):
        batch = sharding.shard_batch(pipeline.batch_at(dcfg, i, device=DEVICE), mesh)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    local = batch["tokens"].to_local().shape
    emit({"phase": name, "nvidia_smi": card_name(), "arch": cfg.name,
          "mesh": f"{label} (rank 0 of a fake group of {mesh.size})", "remat": cfg.remat,
          "local_batch": list(local), "build_s": build_s, "build_peak_gb": build_peak / 1e9,
          "state_gb": held / 1e9, "step_walls_s": walls,
          "steady_step_s": statistics.mean(walls[1:]),
          "tokens_per_s_this_rank": local[0] * local[1] / statistics.mean(walls[1:]),
          "peak_memory_gb": peak / 1e9, "predicted_peak_gb": predicted_peak / 1e9,
          "card_memory_gb": total / 1e9, "losses_unchecked": losses,
          "kernel_launches": counts})
    del state, params, step
    torch.distributed.destroy_process_group()
    check(peak < total, f"{name}: {peak / 1e9} GB at the peak, over the card's "
                        f"{total / 1e9}")
    check(not any(counts.values()), f"{name}: kernels launched: {counts}")
    return counts


def phase_shard_rank_cells(predicted: dict, name: str) -> dict:
    """Phase 23 for an arch of SHARD_RANK_ARCHS (its lines named ``name``):
    ``phase_shard_rank`` of each of its train_4k cells whose phase-22 peak
    (``predicted``: "label/arch/shape" -> bytes) leaves SHARD_RANK_MARGIN
    of the card's memory free; for a cell that does not, a line saying by
    how much it is over.  Returns the launch counts, summed over the cells
    run."""
    import gc

    import torch

    total = torch.cuda.get_device_properties(0).total_memory
    counts: dict = {}
    for key, peak in sorted(predicted.items()):
        label, arch, _ = key.split("/")
        if peak > total - SHARD_RANK_MARGIN:
            emit({"phase": name, "cell": key, "run": False,
                  "predicted_peak_gb": peak / 1e9, "card_memory_gb": total / 1e9,
                  "over_by_gb": (peak - (total - SHARD_RANK_MARGIN)) / 1e9})
            continue
        got = phase_shard_rank(peak, arch, label, name)
        counts = {k: counts.get(k, 0) + v for k, v in got.items()}
        gc.collect()
        torch.cuda.empty_cache()
    return counts


# phase 23's prefill: rank 0 of this cell at its mesh's sharding with real
# tensors, its peak within SHARD_RANK_PREFILL_SLACK of phase 22's count
SHARD_RANK_PREFILL = ("single_pod_16x16", "qwen3-32b", "prefill_32k")  # phase 22's key
SHARD_RANK_PREFILL_SLACK = 1e9


def phase_shard_rank_prefill(predicted_peak: float) -> dict:
    """Phase 23's prefill: rank 0 of SHARD_RANK_PREFILL (qwen3-32b
    prefill_32k at 16 x 16, a fake group of 256) with real tensors on the
    card: its float32 masters built leaf by leaf (``rank_params``: the
    whole masters are 131 GB), its share of a random batch, one
    ``launch.steps.make_prefill_step`` step (the cache made as this rank's
    blocks, its flash attention split over "model" as
    ``models.attention.flash_plan`` says).  Prints its wall, its peak memory
    beside ``predicted_peak`` (phase 22's peak_bytes of the cell) and the
    card's memory and its flash launches by route; fails if it does not
    fit, if its peak lies more than SHARD_RANK_PREFILL_SLACK from the
    prediction, or if it launched no flash kernel.  Its outputs are
    garbage (the fake collectives) and are not checked.  Returns the
    launch counts."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.dist import sharding
    from repro_torch.launch import dryrun, mesh as tmesh, steps
    from repro_torch.models import attention

    label, arch, shape = SHARD_RANK_PREFILL
    torch.cuda.empty_cache()
    mesh = tmesh.fake_production_mesh(multi_pod=dryrun.MESHES[label])
    cfg, cell = registry.get_config(arch), registry.get_shape(shape)
    t0 = time.time()
    params = rank_params(cfg, mesh)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    inputs = {k: (torch.randint(0, cfg.vocab, s, generator=g, device=DEVICE, dtype=dt)
                  if not dt.is_floating_point else
                  torch.randn(s, generator=g, device=DEVICE).to(dt))
              for k, (s, dt) in registry.input_specs(cfg, cell).items()}
    batch = sharding.shard_batch(inputs, mesh)
    del inputs
    torch.cuda.synchronize()
    build_s = time.time() - t0
    step = steps.make_prefill_step(cfg, cell.seq_len)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    with torch.no_grad():
        t = time.perf_counter()
        logits, cache = step(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts, routes = read_counts(), read_tallies().get("flash_attention", {})
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    dm = sharding.device_mesh(mesh)
    plan = attention.flash_plan(dm, cell.global_batch, cell.seq_len, cfg.n_heads,
                                cfg.n_kv_heads)
    emit({"phase": "shard_rank_prefill", "nvidia_smi": card_name(), "arch": cfg.name,
          "shape": shape, "mesh": f"{label} (rank 0 of a fake group of {mesh.size})",
          "flash_plan": plan, "local_tokens": list(batch["tokens"].to_local().shape),
          "build_s": build_s, "state_gb": held / 1e9, "step_wall_s": wall,
          "peak_memory_gb": peak / 1e9, "predicted_peak_gb": predicted_peak / 1e9,
          "peak_off_prediction_gb": (peak - predicted_peak) / 1e9,
          "card_memory_gb": total / 1e9, "flash_routes": routes, "kernel_launches": counts})
    del logits, cache, params, batch, step
    torch.distributed.destroy_process_group()
    check(peak < total, f"shard_rank_prefill: {peak / 1e9} GB at the peak, over the card's "
                        f"{total / 1e9}")
    check(abs(peak - predicted_peak) <= SHARD_RANK_PREFILL_SLACK,
          f"shard_rank_prefill: {peak / 1e9} GB at the peak, {predicted_peak / 1e9} predicted")
    check(counts["flash_attention"] > 0 and routes.get("wgmma") == counts["flash_attention"],
          f"shard_rank_prefill: flash launches {counts['flash_attention']}, routes {routes}")
    check(sum(counts.values()) == counts["flash_attention"],
          f"shard_rank_prefill: other kernels launched: {counts}")
    return counts


# phase 24: the examples' twins (repro_torch.examples, repro_torch.obs.report)
# as their CLIs run, against src/repro_torch/examples/examples_reference.json
# (the JAX example's own code path on the CPU; tests/test_torch_examples.py)
EXAMPLES_REFERENCE = SRC / "repro_torch" / "examples" / "examples_reference.json"
EXAMPLES_SIMULATE = {"default": (), "elephants": ("--elephants",)}
EXAMPLES_DECODE_ARCHS = ("gemma2-2b", "deepseek-moe-16b")


def report_epoch_rows(text: str) -> int:
    """The epoch rows of ``obs.report``'s table in its printed ``text``."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.split()[:2] == ["ep", "p99_us"])
    rows = 0
    for ln in lines[start + 1:]:
        if not ln.strip():
            break
        rows += 1
    return rows


def report_check(path: str, epochs: int) -> dict:
    """Phase 24's report twin on a flight log of phase 11 (``path``, a run of
    ``epochs`` epochs): as its CLI runs, its exit code 0 and an epoch row
    of its table for each epoch."""
    import contextlib
    import io

    from repro_torch.obs import report

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = report.main([path])
    row = {"phase": "examples_report", "rc": rc, "epoch_rows": report_epoch_rows(buf.getvalue()),
           "epochs": epochs, "lines": len(buf.getvalue().splitlines())}
    emit(row)
    check(rc == 0 and row["epoch_rows"] == epochs,
          f"examples_report: {row['epoch_rows']} epoch rows for {epochs} epochs, rc {rc}")
    return row


def phase_examples() -> dict:
    """Phase 24: the examples' twins on the card as their CLIs run.
    simulate_datacenter, default and --elephants: the five schemes' FCT
    stats against the JAX example's at GATES, the tiered kernel launched;
    serve_decode for EXAMPLES_DECODE_ARCHS: its tokens equal to a run of
    the plain attention on the same weights up to each row's first
    near-tie, the float32 flash kernel (route simt) launched; quickstart:
    its lines equal the JAX example's.  Returns the launches."""
    import contextlib
    import io

    import torch

    from repro_torch.examples import quickstart, serve_decode, simulate_datacenter
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import compare

    ref = json.loads(EXAMPLES_REFERENCE.read_text())
    out = {"cascade_tiered": 0, "simt": 0}
    for name, argv in EXAMPLES_SIMULATE.items():
        reset_counts()
        run = simulate_datacenter.main(list(argv))
        launched = read_counts()["cascade_tiered"]
        out["cascade_tiered"] += launched
        want = ref[name]
        check(run["flows"] == want["flows"], f"examples {name}: {run['flows']} flows, "
                                             f"not {want['flows']}")
        worst = gated_diffs(run["stats"], want["stats"], f"examples simulate_datacenter {name}")
        emit({"phase": "examples", "example": "simulate_datacenter", "case": name,
              "wall_s": run["wall_s"], "flows": run["flows"], "max_diff": worst,
              "tiered_launches": launched,
              "stats": {s: {k: st[k] for k in (*GATES, "imbalance_median")}
                        for s, st in run["stats"].items()}})
        check(launched > 0, f"examples {name}: the tiered kernel was not launched")
    for arch in EXAMPLES_DECODE_ARCHS:
        reset_counts()
        run = serve_decode.main(["--arch", arch])
        simt = fa.flash_attention.route_launches.get("simt", 0)
        out["simt"] += simt
        plain = serve_decode.decode(run["params"], run["cfg"], run["batch"],
                                    run["tokens"].shape[1], plain_attention=True)
        logits = plain["logits"].cpu()
        rms = logits.pow(2).mean(-1).sqrt()
        upto = compare.tokens_before_near_tie(compare.margins(logits), rms,
                                              compare.SERVE_TOL["float32"])
        got, want = run["tokens"].cpu(), plain["tokens"].cpu()
        equal = [bool(torch.equal(got[i, :n], want[i, :n])) for i, n in enumerate(upto)]
        emit({"phase": "examples", "example": "serve_decode", "arch": arch,
              "prefill_s": run["prefill_s"], "decode_ms": run["decode_ms"],
              "simt_launches": simt, "steps_before_near_tie": upto, "equal": equal,
              "sample": got[0, :16].tolist()})
        check(all(equal) and min(upto) >= 1, f"examples serve_decode {arch}: tokens {equal} "
                                              f"before the near-ties {upto}")
        check(simt > 0, f"examples serve_decode {arch}: the simt flash kernel was not launched")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lines = quickstart.main([])
    emit({"phase": "examples", "example": "quickstart", "lines": lines})
    check(lines == ref["quickstart"], f"examples quickstart: {lines}")
    return out


def cluster_sweep() -> None:
    """Each cluster kernel (tiered, flat, linkload) at each of its phase 2
    shapes on clusters of 1 to 16 CTAs through its C entry, held against
    its plain version, with the card's cluster occupancy for each size:
    the measurement cluster_size is fitted to."""
    import ctypes

    import torch

    from repro_torch.kernels import build

    sizes = (1, 2, 4, 8, 16)
    for spec in kernel_specs():
        if spec.cluster is None:
            continue
        occupancy = build.entry(spec.name, f"{spec.name}_max_clusters",
                                (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
        for case in spec.cases():
            want = spec.plain(*case.args, **case.kw)
            n_links = want[0].shape[-1]
            row = {}
            for C in sizes:
                count = ctypes.c_int(0)
                build.raise_on(occupancy(C, n_links, ctypes.byref(count)),
                               f"{spec.name} occupancy")
                outs = tuple(torch.empty_like(w) for w in want)
                launch = spec.launch(case, outs, C)
                launch()
                torch.cuda.synchronize()
                close_enough(f"{spec.name} {case.name} C={C}", spec.outputs, outs, want,
                             spec.tols(case))
                row[C] = {"ms": kernel_ms(launch), "max_active_clusters": count.value}
            emit({"phase": "cluster_sweep", "kernel": spec.name, "case": case.name, **case.info,
                  "cluster_size": spec.cluster(case),
                  "fastest": min(row, key=lambda c: row[c]["ms"]), "by_cluster": row})
            torch.cuda.empty_cache()


# faults planted in a copy of csrc/flash_attention_sm90.cu by
# --planted-faults: (pattern, replacement), each matching once
PLANTED = {
    "softcap_dropped": (r"const bool capped = softcap > 0\.0f;", "const bool capped = false;"),
    "window_dropped": (r"\n(\s*)window, softcap, sm_scale\);", r"\n\g<1>0, softcap, sm_scale);"),
}
PLANTED_ROWS = ("gemma2-2b-serve", "gemma2-2b-serve-global")


def planted_checks() -> None:
    """In a copy with a planted fault: phase 2's bf16 serving rows, phase
    12 and phase 13, each printed with whether it failed."""
    import torch

    from repro_torch.kernels import flash_attention as fa, ops

    for case in flash_cases():
        if case.name in PLANTED_ROWS:
            err = row_rel_err(ops.flash_attention(*case.args, **case.kw),
                              fa.flash_attention_torch(*case.args, **case.kw))
            limit = FLASH_ROW_REL[case.info["dtype"]]
            emit({"planted_check": f"phase 2 {case.name}", "row_rel_err": err,
                  "limit": limit, "failed": err > limit})
    torch.cuda.empty_cache()
    for name, phase in (("phase 12", phase_serve_ref), ("phase 13", phase_serve)):
        try:
            phase()
            emit({"planted_check": name, "failed": False})
        except SmokeFailure as e:
            emit({"planted_check": name, "failed": True, "failure": str(e)})
        torch.cuda.empty_cache()


def planted_faults(dest: pathlib.Path) -> bool:
    """Each fault of PLANTED in its own copy of the checkout under
    ``dest``, checked by planted_checks in a process of its own; True
    where every fault failed at least one check."""
    import re
    import shutil

    dest = dest.resolve()
    check(ROOT not in (dest, *dest.parents), f"--planted-faults: {dest} lies in the checkout")
    kernel = pathlib.Path("src/repro_torch/csrc/flash_attention_sm90.cu")
    caught_all = True
    for fault, (pattern, replacement) in PLANTED.items():
        copy = dest / fault
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
            ".git", "_build", "_local", "chiprun_out", "__pycache__"))
        src, n = re.subn(pattern, replacement, (copy / kernel).read_text())
        check(n == 1, f"--planted-faults: {fault} matched {n} times")
        (copy / kernel).write_text(src)
        out = subprocess.run([sys.executable, "chip_smoke.py", "--planted-child"], cwd=copy,
                             capture_output=True, text=True)
        rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
        for r in rows:  # the checks, and what phases 12 and 13 read against their limits
            if "planted_check" in r:
                emit({"planted": fault, **r})
            elif r.get("phase") in ("serve_ref", "serve") and "tolerance" in r:
                emit({"planted": fault, "phase": r["phase"], "dtype": r["dtype"],
                      "err_over_rms": r.get("teacher_forced_max_err_over_rms",
                                            r.get("vs_plain_attention_max_err_over_rms")),
                      "tolerance": r["tolerance"]})
        failed = [r["planted_check"] for r in rows if r.get("failed")]
        emit({"planted": fault, "rc": out.returncode, "caught_by": failed})
        caught_all &= out.returncode == 0 and bool(failed)
        if out.returncode:
            print(out.stderr[-2000:], file=sys.stderr)
    return caught_all


def timed(name: str, phase, *args):
    """``phase(*args)``, its wall printed after it."""
    t0 = time.time()
    out = phase(*args)
    emit({"phase_wall": name, "s": time.time() - t0})
    return out


def worker_fig12() -> dict:
    stats, sweep_counts, walls, fig12 = timed("sweep", phase_sweep)
    repeat = phase_repeat(fig12)
    phase_agree(stats)
    dense_counts = timed("dense", phase_dense, stats, walls)
    flowcell = timed("flowcell", phase_flowcell, fig12[0])
    return {"sweep": sweep_counts, "repeat": repeat, "dense": dense_counts,
            "flowcell": flowcell}


def worker_adaptive() -> dict:
    return {"adaptive": timed("adaptive", phase_adaptive),
            "faults": timed("faults", phase_faults)}


def worker_record() -> dict:
    return {"record": timed("record", phase_record), "cosim": timed("cosim", phase_cosim),
            "testbed": timed("testbed", phase_testbed)}


def worker_serve() -> dict:
    import gc

    import torch

    out = {"serve_ref": timed("serve_ref", phase_serve_ref),
           "serve": timed("serve", phase_serve),
           "serve_families_ref": timed("serve_families_ref", phase_serve_families_ref),
           "serve_families": timed("serve_families", phase_serve_families)}
    gc.collect()  # the serving models are gone before training loads the card
    torch.cuda.empty_cache()
    out.update(train_ref=timed("train_ref", phase_train_ref), train=timed("train", phase_train))
    gc.collect()  # phase 18's model and moments are gone before the rings load the card
    torch.cuda.empty_cache()
    out["grad_sync"] = timed("grad_sync", phase_grad_sync)
    return {**out, "train_sync_ref": timed("train_sync_ref", phase_train_sync_ref)}


def worker_dryrun() -> dict:
    return {"dryrun": timed("dryrun", phase_dryrun, DRYRUN_SPLIT["dryrun"]),
            "examples": timed("examples", phase_examples)}


def worker_dryrun_train() -> dict:
    return {"dryrun_train": timed("dryrun_train", phase_dryrun, DRYRUN_SPLIT["dryrun_train"],
                                  "dryrun_train")}


def worker_train_sync() -> dict:
    """Phase 21, given phase 18's step-0 loss (the argument after its
    name), then phase 23, given phase 22's peak bytes of gemma2-2b's cell
    (the next) and of the cells of SHARD_RANK_ARCHS (a JSON object, the
    next), each once the model before it is gone."""
    import gc

    import torch

    out = {"train_sync": timed("train_sync", phase_train_sync, float(sys.argv[3]))}
    gc.collect()
    torch.cuda.empty_cache()
    out["shard_rank"] = timed("shard_rank", phase_shard_rank, float(sys.argv[4]))
    peaks = json.loads(sys.argv[5])
    for arch, name in SHARD_RANK_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = timed(name, phase_shard_rank_cells,
                          {k: v for k, v in peaks.items()
                           if k.split("/")[1] == arch and k.endswith("/train_4k")}, name)
    gc.collect()
    torch.cuda.empty_cache()
    out["shard_rank_prefill"] = timed("shard_rank_prefill", phase_shard_rank_prefill,
                                      peaks["/".join(SHARD_RANK_PREFILL)])
    return out


# the processes that run phases 3-20 but 6 at once, each its phases in
# order -> their launch counts; the serving and training phases share one,
# so that one model at a time holds the card's memory
WORKERS = {"fig12": worker_fig12, "adaptive": worker_adaptive, "record": worker_record,
           "serve": worker_serve, "dryrun": worker_dryrun, "dryrun_train": worker_dryrun_train}
# phase 22's cells in its two workers: the train cells of the MoE and
# hybrid families and qwen3-32b's prefill apart, so that neither outlasts
# the serve worker
DRYRUN_SPLIT = {"dryrun": tuple(c for c in DRYRUN_CELLS if c[0] in ("gemma2-2b", "xlstm-1.3b")),
                "dryrun_train": tuple(c for c in DRYRUN_CELLS
                                      if c[0] not in ("gemma2-2b", "xlstm-1.3b"))}
# phases 21 and 23 run in a process of their own after them, one after the
# other: each holds most of the card's memory, and none of it is left to
# what the main process holds
LAST_WORKERS = {"train_sync": worker_train_sync}
WORKER_THREADS = 2  # torch's CPU threads in each, so that the six share 8 cores
DEADLINE_S = 1140.0  # after START: the workers still running are stopped


def run_workers(workers: dict, argv: tuple = ()) -> tuple[dict, dict]:
    """Each of ``workers`` (WORKERS or LAST_WORKERS) in a process of its own
    (``argv`` after its name), all started together; once all have ended,
    each one's output printed in turn.  Returns (name -> the counts of its
    {"worker": ...} line, phase -> the last {"phase": ...} line a worker
    printed of it).  A worker that fails, or runs past DEADLINE_S, fails
    the script, and the others are stopped."""
    import signal
    import tempfile

    # stopped from outside: leave through the finally below, which stops the workers
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    procs, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for name in workers:
                out = open(pathlib.Path(tmp) / f"{name}.jsonl", "w+")
                procs[name] = (subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--worker", name, *argv],
                    cwd=ROOT, stdout=out), out)
            while True:
                rcs = {n: p.poll() for n, (p, _) in procs.items()}
                failed = [f"worker {n} exited with {rc}" for n, rc in rcs.items()
                          if rc not in (None, 0)]
                if failed or None not in rcs.values():
                    break
                if time.time() - START > DEADLINE_S:
                    failed = [f"workers {[n for n, rc in rcs.items() if rc is None]} "
                              f"still running after {DEADLINE_S} s"]
                    break
                time.sleep(0.5)
        finally:
            for p, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait()
        counts, phases = {}, {}
        for name, (_, out) in procs.items():
            out.seek(0)
            for line in out:
                print(line, end="", flush=True)
                if line.startswith('{"worker"'):
                    counts[name] = json.loads(line)["launches"]
                elif line.startswith('{"phase": '):
                    obj = json.loads(line)
                    phases[obj["phase"]] = obj
            out.close()
    check(not failed, "; ".join(failed))
    check(set(counts) == set(workers), f"workers without a result: {set(workers) - set(counts)}")
    return counts, phases


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    if sys.argv[1:] == ["--planted-child"]:
        planted_checks()
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--planted-faults":
        try:
            phase_device()
            return 0 if planted_faults(pathlib.Path(sys.argv[2])) else 1
        except SmokeFailure as e:
            print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
            return 1
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        torch.set_num_threads(WORKER_THREADS)
        if sys.argv[2] == "serve":  # cuBLAS repeats bit for bit (phase 17's restart check)
            import os

            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        try:
            load_kernels()
            emit({"worker": sys.argv[2],
                  "launches": {**WORKERS, **LAST_WORKERS}[sys.argv[2]]()})
        except SmokeFailure as e:
            print(f"chip_smoke.py --worker {sys.argv[2]}: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    if sys.argv[1:] == ["--cluster-sweep"]:
        try:
            phase_device()
            cluster_sweep()
        except SmokeFailure as e:
            print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    try:
        timed("device", phase_device)
        rows = timed("kernel", phase_kernel)
        timed("profile", phase_profile)
        torch.cuda.empty_cache()
        t0 = time.time()
        by_worker, phases = run_workers(WORKERS)
        counts = {k: v for c in by_worker.values() for k, v in c.items()}
        emit({"phase_wall": "workers", "s": time.time() - t0})
        peak = phases["dryrun"]["peak_bytes"]["single_pod_16x16/gemma2-2b/train_4k"]
        rank_peaks = {k: v for k, v in phases["dryrun_train"]["peak_bytes"].items()
                      if k.split("/")[1] in dict(SHARD_RANK_ARCHS) and k.endswith("/train_4k")
                      or k == "/".join(SHARD_RANK_PREFILL)}
        last, _ = run_workers(LAST_WORKERS, (repr(phases["train"]["losses"][0]), repr(peak),
                                             json.dumps(rank_peaks)))
        train_sync_launches = last["train_sync"]["train_sync"]
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"phase": "script", "wall_s": time.time() - START})
    kernels = []
    (sweep_counts, sweep_by), (dense_counts, dense_by) = counts["sweep"], counts["dense"]
    repeat_launches, adaptive_launches = counts["repeat"], counts["adaptive"]
    fault_launches, flowcell_launches = counts["faults"], counts["flowcell"]
    record_launches, cosim_launches = counts["record"], counts["cosim"]
    testbed_launches, serve_launches = counts["testbed"], counts["serve"]
    serve_ref_launches, families_ref_launches = counts["serve_ref"], counts["serve_families_ref"]
    families_launches = counts["serve_families"]
    train_launches, examples_launches = counts["train"], counts["examples"]
    # phases 22-23 (the dry run's fake tensors, one rank's training): none
    dryrun_launches = {k: counts["dryrun"][k] + counts["dryrun_train"][k] for k in counts["dryrun"]}
    shard_rank_launches = last["train_sync"]["shard_rank"]
    shard_rank_moe_launches = last["train_sync"]["shard_rank_moe"]
    shard_rank_prefill_launches = last["train_sync"]["shard_rank_prefill"]
    for lib, row in rows.items():
        name = row["kernel"]  # the wrapper's, which may serve several libraries
        by_path = {"fig12_sweep": sweep_counts[name], "dense_engine": dense_counts[name]}
        if name == "cascade_tiered":
            # the main path: the fig12 sweep, phases 7-11, the testbed and
            # the training driver's co-simulation, on one device and over pods
            by_path.update(repeat=repeat_launches, adaptive=adaptive_launches,
                           faults=fault_launches,
                           flowcell=flowcell_launches, record=record_launches,
                           cosim=cosim_launches, testbed=testbed_launches,
                           train=train_launches, train_sync=train_sync_launches,
                           examples=examples_launches["cascade_tiered"])
            launches = (sweep_counts[name] + repeat_launches + adaptive_launches
                        + fault_launches + flowcell_launches + record_launches
                        + cosim_launches + testbed_launches + train_launches
                        + train_sync_launches + examples_launches["cascade_tiered"])
            extra = {"clusters_fig12_sweep": sweep_by[name], "clusters_dense_engine": dense_by[name]}
        elif name == "flash_attention":  # the serving path: phases 12-15, none in training
            route = row["route"]
            by_path.update({row["path"]: row["path_launches"],
                            "serve_ref": serve_ref_launches.get(route, 0),
                            "serve": serve_launches if route == "wgmma" else 0,
                            "serve_families_ref": families_ref_launches.get(route, 0),
                            "serve_families": families_launches if route == "wgmma" else 0,
                            "train": 0, "train_sync": 0,
                            "dryrun": dryrun_launches[name],
                            "shard_rank": shard_rank_launches[name],
                            "shard_rank_moe": shard_rank_moe_launches.get(name, 0),
                            "shard_rank_prefill": (shard_rank_prefill_launches[name]
                                                   if route == "wgmma" else 0),
                            "examples": examples_launches["simt"] if route == "simt" else 0})
            launches = sum(by_path[k] for k in ("serve_ref", "serve", "serve_families_ref",
                                                "serve_families", "shard_rank_prefill",
                                                "examples"))
            extra = {"flash_route": route}
        else:  # not on the fig12 path (0 there): the count of its own entry point
            by_path[row["path"]] = row["path_launches"]
            launches = row["path_launches"]
            extra = {"clusters": row["path_tally"]}
        err = row["max_abs_err"]
        kernels.append({
            "name": row["jax_name"], "route": "cuda",
            "source": f"src/repro_torch/csrc/{lib}.cu",
            "replaces": row["replaces"], "launches": launches, "launches_by_path": by_path,
            "case": row["case"], **extra, "max_abs_err": max(err.values()), "ms": row["ms"],
            "wrapper_ms": row["wrapper_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
