"""The port's pod train step (``--grad-sync seqbalance``) against the JAX
package's, on the CPU.

``repro_torch.launch.steps.make_train_step(cfg, opt, make_pod_mesh(n),
"seqbalance", plan)`` on a "local" pod mesh (every member on the CPU, one
after another) against ``repro.launch.steps.make_train_step`` on a JAX pod
mesh of forced host devices (one subprocess runs every JAX case), on the
same numpy weights and batches: REDUCED gemma2-2b over 2 pods on the
float32 wire, 4 on the int8 wire and 2 on the bfloat16 wire, REDUCED
deepseek-moe-16b over 2 on the float32 wire (the router's gradients
through the ring), with three planted faults that the check must catch;
the "process" transport (2 gloo ranks) against the "local" one; and the
driver's ``--grad-sync seqbalance`` lines against the JAX driver's under
4 forced devices.

Run as a script, it writes ``src/repro_torch/dist/grad_sync_reference.json``
(chip_smoke.py phase 20's case through the JAX package's pod step on 8
forced host devices, the collective cases of phase 19, the port's CPU
readings and the planted faults'; about 11 minutes on 8 cores, 36 GB at the peak):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_grad_sync.py --write-grad-sync-reference
"""
import contextlib
import inspect
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.data import pipeline as jpipe  # noqa: E402
from repro.dist import collectives as jcoll  # noqa: E402
from repro.launch import mesh as jmesh, steps as jsteps  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.dist import collectives as coll, sharding  # noqa: E402
from repro_torch.launch import mesh as tmesh, steps as tsteps, train as ttrain  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from test_torch_collectives import run_ranks  # noqa: E402
from test_torch_models import configs, to_jax  # noqa: E402
from test_torch_train import STEP_REL, STEP_UPDATE_REL, leaf_dict, port_params, rel  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
REFERENCE = SRC / "repro_torch" / "dist" / "grad_sync_reference.json"

# name -> (arch, pods, wire); 2 steps of B 4 x S 16, phase 17's optimizer,
# 2 chunks (one a ring direction: the JAX package compiles every round of
# every chunk of every leaf, 4 x 6 of them a leaf at 4 pods and 4 chunks)
POD_CASES = {"gemma2-2b-2pods-float32": ("gemma2-2b", 2, "float32"),
             "gemma2-2b-4pods-int8": ("gemma2-2b", 4, "int8"),
             "gemma2-2b-2pods-bfloat16": ("gemma2-2b", 2, "bfloat16"),
             "deepseek-moe-16b-2pods-float32": ("deepseek-moe-16b", 2, "float32")}
STEPS, BATCH, SEQ, SEED, CHUNKS = 2, 4, 16, 0, 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)


def data_cfg(mod, vocab: int):
    return mod.DataConfig(vocab=vocab, global_batch=BATCH, seq_len=SEQ, seed=SEED)


def jax_pod_run(arch: str, n: int, wire: str) -> dict:
    """The JAX package's pod step: per step loss, grad norm and lr; the
    params after the last (device 0's copy)."""
    jcfg, tcfg = configs(arch)
    jp = to_jax(weights.numpy_params(tcfg, SEED), jcfg)
    state = {"params": jp, "opt": jopt.init(jp)}
    plan = jcoll.PathPlan(n_chunks=CHUNKS, wire_dtype=wire)
    step = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**OPT), jmesh.make_pod_mesh(n),
                                          "seqbalance", plan))
    rows = []
    for i in range(STEPS):
        state, m = step(state, jpipe.batch_at(data_cfg(jpipe, jcfg.vocab), i))
        rows.append({k: float(v) for k, v in m.items()})
    return {"rows": rows, "params": leaf_dict(state["params"])}


JAX_RUNS = textwrap.dedent("""
    import io, contextlib, json, sys, time, types
    import numpy as np
    import jax
    sys.path.insert(0, sys.argv[2])
    import test_torch_grad_sync as t
    from repro.launch import train as jtrain

    path = sys.argv[1]
    out = {"devices": jax.device_count(), "runs": {}}
    t0 = time.time()
    arrays = {}
    for name, case in t.POD_CASES.items():
        run = t.jax_pod_run(*case)
        out["runs"][name] = run["rows"]
        arrays.update({f"{name}/{k}": v for k, v in run["params"].items()})
        out[f"wall {name}"] = time.time() - t0
    for argv in (t.DRIVER_ARGV, t.DRIVER_ARGV_ODD):
        buf = io.StringIO()
        sys.argv = ["train", *argv]
        with contextlib.redirect_stdout(buf):
            jtrain.main()
        lines = buf.getvalue().splitlines()
        out[" ".join(argv)] = [line for line in lines if line.startswith("[grad-sync]")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        plan = jtrain._cosim_plan(types.SimpleNamespace(**t.DRIVER_COSIM))
    out["cosim"] = buf.getvalue().strip().splitlines()
    out["wall"] = time.time() - t0
    np.savez(path, **arrays)
    print(json.dumps(out))
""")
# the drivers' [grad-sync] lines come before the first step: no step is run
DRIVER_ARGV = ("--arch", "granite-3-8b", "--reduced", "--steps", "0", "--batch", "4", "--seq",
               "8", "--grad-sync", "seqbalance")
DRIVER_ARGV_ODD = ("--arch", "granite-3-8b", "--reduced", "--steps", "0", "--batch", "6",
                   "--seq", "8", "--grad-sync", "seqbalance")
DRIVER_TRAIN = ("--arch", "granite-3-8b", "--reduced", "--steps", "2", "--batch", "4", "--seq",
                "8", "--grad-sync", "seqbalance")
DRIVER_COSIM = {"cosim_epochs": 4, "cosim_kill_spine": 1, "cosim_phi": 2, "n_chunks": 4}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Every JAX case of this file, from one subprocess on 4 forced devices."""
    path = tmp_path_factory.mktemp("jax_pods") / "params.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_RUNS, str(path), str(ROOT / "tests")],
                         capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["devices"] == 4
    params = {}
    for key, v in np.load(path).items():
        name, leaf = key.split("/", 1)
        params.setdefault(name, {})[leaf] = v
    res["params"] = params
    return res


def port_pod_run(arch: str, n: int, wire: str, step_fn=None) -> dict:
    """The port's pod step on a local CPU mesh, read as ``jax_pod_run``
    reads the JAX package's; ``step_fn`` stands in for
    ``launch.steps.make_train_step`` (a planted fault)."""
    _, tcfg = configs(arch)
    params = weights.from_jax_params(weights.numpy_params(tcfg, SEED), tcfg, "cpu",
                                     trainable=True)
    state = {"params": params, "opt": topt.init(params)}
    make = step_fn or tsteps.make_train_step
    step = make(tcfg, topt.AdamWConfig(**OPT), tmesh.make_pod_mesh(n, device="cpu"),
                "seqbalance", coll.PathPlan(n_chunks=CHUNKS, wire_dtype=wire))
    rows = []
    for i in range(STEPS):
        state, m = step(state, tpipe.batch_at(data_cfg(tpipe, tcfg.vocab), i, device="cpu"))
        rows.append({k: float(v) for k, v in m.items()})
    return {"rows": rows, "params": port_params(state["params"])}


def step_errors(got: dict, want: dict, p0: dict) -> dict:
    """The largest relative error of loss and grad norm over the steps, lr
    in ulps, and the largest leaf's update p_n - p_0 error."""
    out = {k: max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got["rows"], want["rows"]))
           for k in ("loss", "grad_norm")}
    out["lr_ulps"] = max(float(abs(np.float32(g["lr"]) - np.float32(w["lr"]))
                               / np.spacing(np.float32(w["lr"])))
                         for g, w in zip(got["rows"], want["rows"]))
    out["update"] = max(rel(got["params"][k] - p0[k], want["params"][k] - p0[k])
                        for k in want["params"])
    return out


def within(err: dict) -> bool:
    return (err["loss"] <= STEP_REL and err["grad_norm"] <= STEP_REL and err["lr_ulps"] <= 1
            and err["update"] <= STEP_UPDATE_REL)


def p0_of(arch: str) -> dict:
    _, tcfg = configs(arch)
    return weights.stacked((n, i, np.asarray(t.detach().numpy()))
                           for n, i, t in weights.leaves(weights.from_jax_params(
                               weights.numpy_params(tcfg, SEED), tcfg, "cpu")))


@pytest.mark.parametrize("name", list(POD_CASES))
def test_pod_step_matches_the_jax_pod_step(jax_runs, name):
    """Loss and grad norm within STEP_REL, lr within an ulp, and each leaf's
    update within STEP_UPDATE_REL of the JAX package's (test_torch_train's
    limits for the single-device step)."""
    arch, n, wire = POD_CASES[name]
    coll.permute_rounds = 0
    got = port_pod_run(arch, n, wire)
    want = {"rows": jax_runs["runs"][name], "params": jax_runs["params"][name]}
    err = step_errors(got, want, p0_of(arch))
    print(name, err)
    assert within(err), err
    leaves = len(sharding.param_shapes(configs(arch)[1]))
    assert coll.permute_rounds == STEPS * leaves * CHUNKS * 2 * (n - 1)
    assert all(set(r) == {"loss", "nll", "grad_norm", "lr"} for r in got["rows"])


def summed_loss_step():
    """Planted fault: the pod step's loss summed over the pods, not
    averaged."""
    src = inspect.getsource(tsteps._pod_train_step)
    old = "loss = collectives.baseline_all_reduce(loss, axis) / n"
    assert old in src
    ns = dict(vars(tsteps))
    exec(compile(textwrap.dedent(src.replace(old, old[:-len(" / n")])),
                 "<planted pod step>", "exec"), ns)
    pod = types.FunctionType(ns["_pod_train_step"].__code__, ns)

    def make(cfg, opt_cfg, mesh, grad_sync, plan):
        return pod(cfg, opt_cfg, mesh, plan)
    return make


@contextlib.contextmanager
def planted(fault: str):
    """(a) the wire ignored (float32 sent where int8 is asked); (b) one
    scale shared by every member of the local axis; (c) the loss summed."""
    orig_encode, orig_plan = coll._encode, coll.PathPlan
    if fault == "wire_ignored":
        coll.PathPlan = lambda **kw: orig_plan(**dict(kw, wire_dtype="float32"))
    elif fault == "shared_scale":
        def shared(x, wire):
            if wire == "int8":
                q, scale = coll.quantize_int8(x)
                return q, scale.expand(x.shape[0], 1)
            return orig_encode(x, wire)
        coll._encode = shared
    try:
        yield summed_loss_step() if fault == "loss_summed" else None
    finally:
        coll._encode, coll.PathPlan = orig_encode, orig_plan


PLANTED = ("wire_ignored", "shared_scale", "loss_summed")


@pytest.mark.parametrize("fault", PLANTED)
def test_planted_faults_fail_the_pod_step_check(jax_runs, fault):
    name = "gemma2-2b-4pods-int8"
    arch, n, wire = POD_CASES[name]
    with planted(fault) as step_fn:
        got = port_pod_run(arch, n, wire, step_fn)
    err = step_errors(got, {"rows": jax_runs["runs"][name], "params": jax_runs["params"][name]},
                      p0_of(arch))
    print(fault, err)
    assert not within(err), (fault, err)


def test_float32_pod_step_equals_the_single_device_step():
    """2 pods on the float32 wire against the port's own single-device step
    on the same B 4 batch: the mean of the two halves' gradients is the
    whole batch's up to float32 rounding."""
    arch = "gemma2-2b"
    pod = port_pod_run(arch, 2, "float32")
    _, tcfg = configs(arch)
    params = weights.from_jax_params(weights.numpy_params(tcfg, SEED), tcfg, "cpu",
                                     trainable=True)
    state = {"params": params, "opt": topt.init(params)}
    step = tsteps.make_train_step(tcfg, topt.AdamWConfig(**OPT))
    for i, row in enumerate(pod["rows"]):
        state, m = step(state, tpipe.batch_at(data_cfg(tpipe, tcfg.vocab), i, device="cpu"))
        assert abs(float(m["loss"]) - row["loss"]) <= STEP_REL * row["loss"], (row, m)
        assert abs(float(m["grad_norm"]) - row["grad_norm"]) <= STEP_REL * row["grad_norm"]


def test_pod_step_releases_each_gradient_buffer_as_its_mean_is_made(monkeypatch):
    """The local pod step's [n, ...] buffers are let go leaf by leaf during
    the sync: nothing but the leaf being reduced is held twice (at a
    published model's size a second copy of every gradient does not fit
    beside the state on one card)."""
    import gc
    import weakref

    _, tcfg = configs("gemma2-2b")
    state = tsteps.init_state(tcfg, 0, device="cpu")
    step = tsteps.make_train_step(tcfg, topt.AdamWConfig(**OPT),
                                  tmesh.make_pod_mesh(2, device="cpu"), "seqbalance")
    seen, alive, orig = [], [], coll.tree_all_reduce_mean

    def probe(g, axis, plan):
        gc.collect()
        alive.append(sum(r() is not None for r in seen))
        seen.append(weakref.ref(g))
        return orig(g, axis, plan)

    monkeypatch.setattr(coll, "tree_all_reduce_mean", probe)
    step(state, tpipe.batch_at(data_cfg(tpipe, tcfg.vocab), 0, device="cpu"))
    assert len(alive) == len(sharding.param_shapes(tcfg)) and not any(alive), alive


GLOO_STEP = """
    init()
    import test_torch_grad_sync as t
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import mesh

    m = mesh.make_pod_mesh(WORLD)
    assert m.transport == "process"
    out = {}
    for wire in ("float32", "int8"):
        run = t.port_pod_run("gemma2-2b", WORLD, wire)
        out.update({f"{wire}/{k}": v for k, v in run["params"].items()})
        out[f"{wire}/rows"] = np.array([[r[k] for k in ("loss", "nll", "grad_norm", "lr")]
                                        for r in run["rows"]])
    # the driver as torchrun starts it (its group already joined here)
    os.environ.update(WORLD_SIZE=str(WORLD), LOCAL_RANK=str(RANK))
    from repro_torch.launch import train
    res = train.main([*t.DRIVER_TRAIN, "--device", "cpu"])
    out["driver"] = np.array([[r["loss"], r["grad_norm"]] for r in res["steps"]])
    out["driver_pods"] = np.array(res["pods"])
    np.savez(OUT, **out)
    dist.destroy_process_group()
"""


def test_process_pod_step_equals_the_local_one(tmp_path):
    """2 gloo ranks, each its own share and its own state, against the local
    mesh: every metric and rank 0's params equal bit for bit on both wires
    (on the int8 wire the ranks' states differ from each other, as the
    local members' and the JAX package's devices' do); and the driver in
    torchrun's environment (WORLD_SIZE, LOCAL_RANK) trains over the world
    as ``--pods 2`` does on one device."""
    ranks = run_ranks(GLOO_STEP, 2, tmp_path)
    for wire in ("float32", "int8"):
        local = port_pod_run("gemma2-2b", 2, wire)
        rows = np.array([[r[k] for k in ("loss", "nll", "grad_norm", "lr")]
                         for r in local["rows"]])
        for r in ranks:
            assert np.array_equal(r[f"{wire}/rows"][:, :2], rows[:, :2]), wire  # loss, nll
        assert np.array_equal(ranks[0][f"{wire}/rows"], rows), wire
        assert all(np.array_equal(ranks[0][f"{wire}/{k}"], v)
                   for k, v in local["params"].items()), wire
    differ = [k for k in local["params"]
              if not np.array_equal(ranks[0][f"int8/{k}"], ranks[1][f"int8/{k}"])]
    assert differ  # the lossy wire's roundings
    pods = ttrain.main([*DRIVER_TRAIN, "--pods", "2", "--device", "cpu"])
    want = np.array([[r["loss"], r["grad_norm"]] for r in pods["steps"]])
    for r in ranks:
        assert int(r["driver_pods"]) == 2 and np.array_equal(r["driver"], want)


# ------------------------------------------------------------ the driver
def driver_lines(argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain.main([*argv, "--device", "cpu"])
    return buf.getvalue().splitlines()


def test_driver_grad_sync_line_equals_the_jax_drivers(jax_runs):
    """``--pods 4`` on the CPU is the JAX driver under 4 forced devices: the
    same [grad-sync] line, and its fallback for a batch of 6."""
    for argv in (DRIVER_ARGV, DRIVER_ARGV_ODD):
        got = [line for line in driver_lines([*argv, "--pods", "4"])
               if line.startswith("[grad-sync]")]
        assert got == jax_runs[" ".join(argv)], (got, jax_runs[" ".join(argv)])
        assert len(got) == 1


def test_driver_cosim_ring_is_the_pod_count(jax_runs):
    flags = ["--cosim-epochs", "4", "--cosim-kill-spine", "1", "--cosim-phi", "2",
             "--cosim-only", "--pods", "4", "--device", "cpu"]
    out = ttrain.main(flags)
    strip = [re.sub(r" builds \d+$", "", line) for line in out["cosim"]]
    assert strip == [re.sub(r" builds \d+$", "", line) for line in jax_runs["cosim"]]


def test_driver_trains_over_pods_and_counts_rounds():
    coll.permute_rounds = 0
    out = ttrain.main(["--arch", "granite-3-8b", "--reduced", "--steps", "2", "--batch", "4",
                       "--seq", "8", "--grad-sync", "seqbalance", "--pods", "2", "--device",
                       "cpu"])
    _, tcfg = configs("granite-3-8b")
    leaves = len(sharding.param_shapes(tcfg))
    assert coll.permute_rounds == 2 * leaves * 4 * 2
    assert len(out["steps"]) == 2 and all(np.isfinite(r["loss"]) for r in out["steps"])


# ------------------------------------------------------------ phase 20's reference
def test_grad_sync_reference_limits_sit_between_the_readings_and_the_faults():
    """grad_sync_reference.json (written by this file as a script) records
    the port's CPU runs of phase 20's case against the JAX package's pod
    runs within chip_smoke.grad_sync_limits (TRAIN_TOL, its norms only on
    the int8 wire), and each planted fault outside the limits of the run
    it was planted in."""
    ref = json.loads(REFERENCE.read_text())
    assert ref["case"] == chip_smoke.GRAD_SYNC_CASE
    runs = {r["name"]: r for r in chip_smoke.GRAD_SYNC_CASE["runs"]}
    assert set(ref["runs"]) == set(ref["port_cpu"]) == set(runs)
    for name, reading in ref["port_cpu"].items():
        tol = chip_smoke.grad_sync_limits(runs[name])
        assert all(reading[k] <= tol[k] for k in tol), (name, reading)
    tol = chip_smoke.grad_sync_limits(runs[ref["planted_run"]])
    for run in chip_smoke.GRAD_SYNC_CASE["runs"]:
        cfg = chip_smoke.grad_sync_cfg(ref["case"], run)
        assert ref["port_cpu_rounds"][run["name"]] == chip_smoke.rounds_of(
            cfg, ref["case"]["steps"], run["pods"], ref["case"]["chunks"])
    assert len(ref["rings"]) == len(chip_smoke.GRAD_SYNC_RINGS)
    assert ref["port_cpu_ring_bits_off"] == [0] * len(chip_smoke.GRAD_SYNC_RINGS)
    assert set(ref["planted"]) == set(PLANTED)
    for fault, reading in ref["planted"].items():
        assert any(reading[k] > tol[k] for k in tol), (fault, reading)


JAX_WRITER = textwrap.dedent("""
    import json, resource, sys
    import jax
    sys.path.insert(0, sys.argv[3])
    import test_torch_grad_sync as t

    what = sys.argv[1]
    out = t.jax_rings() if what == "rings" else t.jax_pod_readings(int(what))
    out = {"result": out, "devices": jax.device_count(),
           "max_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)
""")


def jax_rings() -> list:
    """Phase 19's cases through the JAX package's ring on 8 forced devices:
    each member's output at the case's sampled entries."""
    from jax.sharding import Mesh, PartitionSpec as P

    out = []
    for k in range(len(chip_smoke.GRAD_SYNC_RINGS)):
        n, wire, plan, x, idx = chip_smoke.ring_case(k)
        p = chip_smoke.ring_plan(jcoll, plan, wire)
        f = jax.jit(jax.shard_map(lambda v, p=p: jcoll.seqbalance_all_reduce(v, "pod", p),
                                  mesh=Mesh(np.array(jax.devices()[:n]), ("pod",)),
                                  in_specs=P("pod"), out_specs=P("pod")))
        got = np.asarray(f(x))
        out.append({"members": n, "wire": wire, "plan": plan,
                    "samples": got[:, idx].tolist()})
    return out


def jax_pod_readings(r: int) -> dict:
    """GRAD_SYNC_CASE's run r through the JAX package's pod step
    (``make_train_step(cfg, opt, make_pod_mesh(n), "seqbalance", plan)``
    under ``jax.jit``, the state donated), read as
    ``chip_smoke.train_readings`` reads the port's: the gradients from a
    probe around ``optimizer.update`` (device 0's mean), the update from
    device 0's params.  The JAX pod step reports no nll: gemma2-2b has no
    auxiliary loss, so its loss is the nll."""
    import gc

    from repro.configs import registry as jreg

    case = chip_smoke.GRAD_SYNC_CASE
    run = case["runs"][r]
    tcfg = chip_smoke.grad_sync_cfg(case, run)
    jcfg = (jreg.get_config(case["arch"], reduced=True).replace(dtype="float32")
            if run["reduced"] else
            jreg.get_config(case["arch"]).replace(dtype="float32", **case["replace"]))
    jp = to_jax(weights.numpy_params(tcfg, case["seed"]), jcfg)
    state = {"params": jp, "opt": jopt.init(jp)}
    del jp
    plan = jcoll.PathPlan(n_chunks=case["chunks"], wire_dtype=run["wire"])
    step = jsteps.make_train_step(jcfg, jopt.AdamWConfig(**case["opt"]),
                                  jmesh.make_pod_mesh(run["pods"]), "seqbalance", plan)
    captured, orig = [], jopt.update

    def probe(g, s, p, c):
        captured.append(g)
        return orig(g, s, p, c)

    def with_grads(state, batch):
        captured.clear()
        new, m = step(state, batch)
        return new, m, captured[0]

    f = jax.jit(with_grads, donate_argnums=(0,))
    dcfg = jpipe.DataConfig(vocab=jcfg.vocab, global_batch=case["batch"], seq_len=case["seq"],
                            seed=case["seed"])
    rows = []
    jopt.update = probe
    try:
        for i in range(case["steps"]):
            state, m, g = f(state, jpipe.batch_at(dcfg, i))
            grad = chip_smoke.leaf_readings(
                {k: torch.from_numpy(v) for k, v in leaf_dict(g).items()}, case["samples"])
            del g
            rows.append({"loss": float(m["loss"]), "nll": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                         "grad": grad})
    finally:
        jopt.update = orig
    final = leaf_dict(state["params"])
    del state
    gc.collect()
    p0 = leaf_dict(weights.numpy_params(tcfg, case["seed"]))
    delta = {k: torch.from_numpy(final[k] - p0[k]) for k in final}
    return {"steps": rows, "update": chip_smoke.leaf_readings(delta, case["samples"])}


def jax_subprocess(what: str) -> dict:
    path = pathlib.Path(os.environ.get("TMPDIR", "/tmp")) / f"grad_sync_{what}.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_WRITER, what, str(path),
                          str(ROOT / "tests")], capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(path.read_text())
    path.unlink()
    assert res["devices"] == 8
    return res


def write_grad_sync_reference() -> None:
    import gc

    t_start = time.time()
    case = chip_smoke.GRAD_SYNC_CASE
    t0 = time.time()
    rings = jax_subprocess("rings")["result"]
    print(f"jax rings: {time.time() - t0:.1f} s", flush=True)
    ring_bits = []
    for k, ring in enumerate(rings):
        n, wire, plan, x, idx = chip_smoke.ring_case(k)
        got = coll.seqbalance_all_reduce(torch.from_numpy(x), coll.LocalAxis(n, "cpu"),
                                         chip_smoke.ring_plan(coll, plan, wire)).numpy()
        ring_bits.append(chip_smoke.differing_bits(got[:, idx],
                                                   np.asarray(ring["samples"], np.float32)))
    print("port cpu ring bits off the JAX samples", ring_bits, flush=True)
    runs, walls = {}, {}
    for r, run in enumerate(case["runs"]):
        t0 = time.time()
        res = jax_subprocess(str(r))
        runs[run["name"]] = res["result"]
        walls[f"jax {run['name']}"] = {"s": time.time() - t0, "max_rss_gb": res["max_rss_gb"]}
        print(f"jax {run['name']}: {walls['jax ' + run['name']]}, losses "
              f"{[st['loss'] for st in runs[run['name']]['steps']]}", flush=True)
    port_cpu, rounds = {}, {}
    for run in case["runs"]:
        t0 = time.time()
        got = chip_smoke.grad_sync_readings(case, run, "cpu")
        port_cpu[run["name"]] = chip_smoke.train_agreement(got, runs[run["name"]])
        rounds[run["name"]] = got["rounds"]
        walls[f"port cpu {run['name']}"] = {"s": time.time() - t0}
        del got
        gc.collect()
        print(f"port cpu {run['name']} ({time.time() - t0:.1f} s)", port_cpu[run["name"]],
              flush=True)
    plant_run = next(run for run in case["runs"] if run["name"] == PLANTED_RUN)
    planted_readings = {}
    for fault in PLANTED:
        t0 = time.time()
        with planted(fault) as step_fn:
            got = chip_smoke.grad_sync_readings(case, plant_run, "cpu", step_fn)
        planted_readings[fault] = chip_smoke.train_agreement(got, runs[PLANTED_RUN])
        del got
        gc.collect()
        print(f"planted {fault} ({time.time() - t0:.1f} s)", planted_readings[fault], flush=True)
    REFERENCE.write_text(json.dumps({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_grad_sync.py "
                   "--write-grad-sync-reference",
        "source": "rings: repro.dist.collectives.seqbalance_all_reduce under shard_map on 8 "
                  "forced host devices, each member's output at chip_smoke.ring_case's "
                  "sampled entries; runs: repro.launch.steps.make_train_step(cfg, opt, "
                  "repro.launch.mesh.make_pod_mesh(pods), 'seqbalance', PathPlan(chunks, "
                  "wire)) under jax.jit on 8 forced host devices, weights "
                  "repro_torch.models.weights.numpy_params, batches "
                  "repro.data.pipeline.batch_at, gradients from a probe around "
                  "repro.train.optimizer.update (device 0's), read by "
                  "chip_smoke.leaf_readings; nll = loss (gemma2-2b has no auxiliary loss, and "
                  "the JAX pod step reports no nll); port_cpu: chip_smoke.train_agreement of "
                  "chip_smoke.grad_sync_readings on the CPU against each run; planted: the "
                  f"same under each fault of tests/test_torch_grad_sync.py::PLANTED, against "
                  f"the {PLANTED_RUN} run",
        "commit": commit(), "backend": "cpu", "case": case, "rings": rings,
        "port_cpu_ring_bits_off": ring_bits, "runs": runs, "port_cpu": port_cpu,
        "port_cpu_rounds": rounds, "planted_run": PLANTED_RUN, "planted": planted_readings,
        "walls": walls, "wall_s": time.time() - t_start}) + "\n")


# the run the planted faults are held against: 4 members make one scale
# shared by all of them, and the wire, matter most
PLANTED_RUN = "4pods-int8-reduced"


def commit() -> str:
    return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                          text=True).stdout.strip()


sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

if __name__ == "__main__":
    if sys.argv[1:] == ["--write-grad-sync-reference"]:
        write_grad_sync_reference()
    else:
        sys.exit("usage: test_torch_grad_sync.py --write-grad-sync-reference")
