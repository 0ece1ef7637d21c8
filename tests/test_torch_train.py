"""The port's training against the JAX package's, on the CPU: the data
pipeline, AdamW (with planted faults that its limits catch), the train
step, the checkpoints in both directions between the packages, and the
launch driver with its co-simulation plan.

Run as a script, it writes ``src/repro_torch/launch/train_reference.json``
(the JAX package training chip_smoke.py phase 17's case, gemma2-2b at
full width cut to 2 layers, in float32 and in bfloat16, and the JAX
driver's co-simulation plan of phase 18; about 0.75 B float32 parameters,
minutes on 8 cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py --write-train-reference
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
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import steps as jsteps, train as jtrain  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt, optimizer as jopt  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import steps as tsteps, train as ttrain  # noqa: E402
from repro_torch.models import model as tmodel, weights  # noqa: E402
from repro_torch.train import checkpoint as tckpt, optimizer as topt  # noqa: E402
from test_torch_models import configs, to_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "src" / "repro_torch" / "launch" / "train_reference.json"

# AdamW in float32 on the same gradients: the two packages round the same
# operations, the products and sums of a leaf in another order or fused, so
# each leaf's update p_k - p_0 is held by the norm of the difference over
# its own norm (never element by element: where a gradient lies within
# rounding noise of 0, the first step's g / (|g| + eps) moves the element
# by +-lr on one side only).  Read: up to 2.1e-6 over five updates.  The
# planted faults (PLANTED) read 0.033 (b1 and b2 swapped) to 2.3.
UPDATE_REL = 1e-5
# The train step: the gradients themselves differ by rounding (6e-7 to
# 1.1e-6 of a leaf's norm, test_torch_train_models.py), and AdamW's first
# steps turn a gradient entry near 0 into +-lr: the updates after 3 steps
# read up to 8.5e-6 (gemma2-2b) and 4.8e-5 (deepseek-moe-16b's experts);
# loss and grad norm up to 2.7e-7.
STEP_REL = 1e-5
STEP_UPDATE_REL = 2e-4
NORMS = ("ln", "final_norm", "enc_norm", "q_norm", "k_norm", "gn")


def leaf_dict(tree) -> dict:
    """leaf id -> numpy array of a JAX tree."""
    return {jckpt._leaf_id(path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_params(params) -> dict:
    """leaf name -> numpy array (stacked) of the port's masters."""
    return weights.stacked((n, i, t.detach().numpy().copy())
                           for n, i, t in weights.leaves(params))


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def within_ulp(got: float, want: float, ulps: int = 1) -> bool:
    got, want = np.float32(got), np.float32(want)
    return abs(got - want) <= ulps * np.spacing(want)


# ------------------------------------------------------------ data
@pytest.mark.parametrize("vocab,step,seed", [
    (256000, 0, 0), (256000, 2**31 + 12345, 7), (1000, 42, 3), (2, 5, 1),
    (32000, 2**32 - 1, 2**32 - 1)])
def test_batch_at_equals_reference(vocab, step, seed):
    j = jpipe.batch_at(jpipe.DataConfig(vocab, 4, 33, seed), step)
    t = tpipe.batch_at(tpipe.DataConfig(vocab, 4, 33, seed), step, device="cpu")
    for k in ("tokens", "labels"):
        assert t[k].dtype == torch.int32
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("warmup,total", [(5, 20), (1, 8), (100, 10000), (0, 3), (10, 4)])
def test_schedule_matches_reference(warmup, total):
    jc = jopt.AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    tc = topt.AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    for step in list(range(0, 40)) + [total, 9999, 10001, 2**20]:
        want = float(jopt.schedule(jnp.asarray(step, jnp.int32), jc))
        got = topt.schedule(torch.tensor(step, dtype=torch.int32), tc)
        assert got.dtype == torch.float32
        assert within_ulp(float(got), want), (step, float(got), want)


GRAD_NORMS = (0.3, 3.0, 12.0, 0.05, 6.0)  # clipped on three of the five steps


def random_grads(tree: dict, step: int) -> dict:
    """leaf id -> a gradient of global norm GRAD_NORMS[step]; one leaf's
    entries sit near eps, where the clip scale moves AdamW's update."""
    rng = np.random.default_rng(100 + step)
    g = {k: rng.standard_normal(v.shape, dtype=np.float32) for k, v in tree.items()}
    g["final_norm"] *= np.float32(1e-6)
    norm = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64))) for v in g.values()))
    return {k: v * np.float32(GRAD_NORMS[step] / norm) for k, v in g.items()}


def jax_updates(jp, grads_seq, cfg):
    """The JAX package's params after each update, lr and grad norm."""
    state, out = jopt.init(jp), []
    upd = jax.jit(lambda g, s, p: jopt.update(g, s, p, cfg))
    for grads in grads_seq:
        gtree = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(grads[jckpt._leaf_id(path)]), jp)
        jp, state, m = upd(gtree, state, jp)
        out.append((leaf_dict(jp), float(m["lr"]), float(m["grad_norm"])))
    return out


def port_updates(tree, tcfg, grads_seq, cfg, update=topt.update):
    params = weights.from_jax_params(tree, tcfg, "cpu", trainable=True)
    state, out = topt.init(params), []
    for grads in grads_seq:
        _, state, m = update({k: torch.from_numpy(v) for k, v in grads.items()}, state,
                             params, cfg)
        out.append((port_params(params), float(m["lr"]), float(m["grad_norm"])))
    return out


def update_errors(got, want, p0) -> dict:
    """Per update: the largest leaf error of p_k - p_0, and lr, grad norm."""
    rows = []
    for (gp, glr, ggn), (wp, wlr, wgn) in zip(got, want):
        rows.append({"update": max(rel(gp[k] - p0[k], wp[k] - p0[k]) for k in wp),
                     "lr_ulp": within_ulp(glr, wlr), "grad_norm": abs(ggn - wgn) / wgn})
    return rows


@pytest.fixture(scope="module")
def optimizer_case():
    """REDUCED deepseek-moe-16b's tree (stacked, shared and unread leaves),
    five gradients, the JAX package's updates."""
    jcfg, tcfg = configs("deepseek-moe-16b")
    tree = weights.numpy_params(tcfg, 0)
    jp = to_jax(tree, jcfg)
    p0 = leaf_dict(jp)
    grads_seq = [random_grads(p0, s) for s in range(len(GRAD_NORMS))]
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    want = jax_updates(jp, grads_seq, jopt.AdamWConfig(**cfg))
    return tree, tcfg, p0, grads_seq, cfg, want


def test_update_matches_reference(optimizer_case):
    tree, tcfg, p0, grads_seq, cfg, want = optimizer_case
    got = port_updates(tree, tcfg, grads_seq, topt.AdamWConfig(**cfg))
    for row in update_errors(got, want, p0):
        assert row["update"] <= UPDATE_REL and row["lr_ulp"], row
        assert row["grad_norm"] <= 1e-6, row


def test_update_decays_every_leaf_and_keeps_moments_by_leaf_name(optimizer_case):
    tree, tcfg, p0, _, _, _ = optimizer_case
    params = weights.from_jax_params(tree, tcfg, "cpu", trainable=True)
    state = topt.init(params)
    assert set(state.mu) == set(p0) and state.step.dtype == torch.int32
    assert all(state.mu[k].shape == p0[k].shape for k in p0)
    zero = {k: torch.zeros(v.shape) for k, v in p0.items()}
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.5)
    _, state, m = topt.update(zero, state, params, cfg)
    after = port_params(params)
    lr = float(m["lr"])
    for k in p0:  # no gradient: the step is the decay alone, on every leaf
        np.testing.assert_allclose(after[k], p0[k] * (1 - lr * 0.5), rtol=1e-6, atol=1e-9)
    assert int(state.step) == 1


# each planted fault: (what it replaces in optimizer.update's source, the
# replacement) or a config change
PLANTED = {
    "no_bias_correction": [("b1c = 1 - torch.pow(cfg.b1, t)", "b1c = torch.ones_like(t)"),
                           ("b2c = 1 - torch.pow(cfg.b2, t)", "b2c = torch.ones_like(t)")],
    "no_decay_on_norms": [("delta.add_(cfg.weight_decay * p)",
                           "delta.add_(cfg.weight_decay * p * "
                           "(name.rsplit('.', 1)[-1] not in NORMS))")],
    "no_clip": [("g = g.to(torch.float32) * scale", "g = g.to(torch.float32)")],
    "b1_b2_swapped": "swap",
}


def planted_update(fault: str):
    """(update, config change) with ``fault`` planted in a copy of the
    port's ``optimizer.update``."""
    if PLANTED[fault] == "swap":
        return topt.update, lambda c: dict(c, b1=0.95, b2=0.9)
    src = inspect.getsource(topt.update)
    for old, new in PLANTED[fault]:
        assert old in src, old
        src = src.replace(old, new)
    ns = dict(vars(topt), NORMS=NORMS)
    exec(compile(src, "<planted optimizer>", "exec"), ns)
    return types.FunctionType(ns["update"].__code__, ns), lambda c: c


@pytest.mark.parametrize("fault", list(PLANTED))
def test_planted_optimizer_faults_fail_the_limits(optimizer_case, fault):
    tree, tcfg, p0, grads_seq, cfg, want = optimizer_case
    update, change = planted_update(fault)
    got = port_updates(tree, tcfg, grads_seq, topt.AdamWConfig(**change(cfg)), update)
    worst = max(row["update"] for row in update_errors(got, want, p0))
    assert worst > 100 * UPDATE_REL, (fault, worst)


# ------------------------------------------------------------ the train step
def step_pair(arch: str, steps: int = 3, seed: int = 0):
    """``steps`` train steps of both packages on one REDUCED float32 case
    (phase 17's optimizer and data settings)."""
    jcfg, tcfg = configs(arch)
    tree = weights.numpy_params(tcfg, seed)
    jp = to_jax(tree, jcfg)
    jstate = {"params": jp, "opt": jopt.init(jp)}
    params = weights.from_jax_params(tree, tcfg, "cpu", trainable=True)
    tstate = {"params": params, "opt": topt.init(params)}
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=8)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**oc)))
    tstep = tsteps.make_train_step(tcfg, topt.AdamWConfig(**oc))
    dj = jpipe.DataConfig(vocab=tcfg.vocab, global_batch=2, seq_len=32, seed=0)
    dt = tpipe.DataConfig(vocab=tcfg.vocab, global_batch=2, seq_len=32, seed=0)
    rows = []
    for i in range(steps):
        jstate, jm = jstep(jstate, jpipe.batch_at(dj, i))
        tstate, tm = tstep(tstate, tpipe.batch_at(dt, i, device="cpu"))
        rows.append(({k: float(v) for k, v in tm.items()}, {k: float(v) for k, v in jm.items()}))
    return leaf_dict(jp), leaf_dict(jstate["params"]), port_params(tstate["params"]), rows


@pytest.mark.parametrize("arch", ("gemma2-2b", "deepseek-moe-16b"))
def test_train_steps_match_reference(arch):
    p0, jp, tp, rows = step_pair(arch)
    for tm, jm in rows:
        assert abs(tm["loss"] - jm["loss"]) <= STEP_REL * jm["loss"], (tm, jm)
        assert abs(tm["grad_norm"] - jm["grad_norm"]) <= STEP_REL * jm["grad_norm"], (tm, jm)
        assert within_ulp(tm["lr"], jm["lr"]), (tm, jm)
    errs = {k: rel(tp[k] - p0[k], jp[k] - p0[k]) for k in jp}
    assert max(errs.values()) <= STEP_UPDATE_REL, max(errs.items(), key=lambda kv: kv[1])


def test_seqbalance_step_without_a_pod_axis_is_the_single_device_step():
    """As in the JAX package, the seqbalance grad sync needs a pod axis of
    more than one member: without one (no mesh, a data x model mesh, one
    pod) the step is the single-device step, bit for bit, and runs no
    ring."""
    from repro_torch.dist import collectives as tcoll
    from repro_torch.launch import mesh as tmesh

    _, tcfg = configs("granite-3-8b")
    dc = tpipe.DataConfig(vocab=tcfg.vocab, global_batch=4, seq_len=16)
    runs = []
    for grad_sync, mesh in (("xla", None), ("seqbalance", None),
                            ("seqbalance", tmesh.make_mesh_like((2, 2), device="cpu")),
                            ("seqbalance", tmesh.make_pod_mesh(1, device="cpu")),
                            ("xla", tmesh.make_pod_mesh(2, device="cpu"))):
        state = tsteps.init_state(tcfg, 0, device="cpu")
        step = tsteps.make_train_step(tcfg, topt.AdamWConfig(lr=1e-3), mesh, grad_sync)
        tcoll.permute_rounds = 0
        state, m = step(state, tpipe.batch_at(dc, 0, device="cpu"))
        assert tcoll.permute_rounds == 0
        runs.append(({k: float(v) for k, v in m.items()}, port_params(state["params"])))
    for m, p in runs[1:]:
        assert m == runs[0][0]
        assert all(np.array_equal(p[k], runs[0][1][k]) for k in p)
    with pytest.raises(ValueError, match="grad_sync"):
        tsteps.make_train_step(tcfg, topt.AdamWConfig(), None, "ring")


# ------------------------------------------------------------ checkpoints
def tiny_state(trained: bool = True):
    """The port's REDUCED granite-3-8b state (float32), after one step."""
    _, tcfg = configs("granite-3-8b")
    state = tsteps.init_state(tcfg, 0, device="cpu")
    if trained:
        dc = tpipe.DataConfig(vocab=tcfg.vocab, global_batch=2, seq_len=16)
        state, _ = tsteps.make_train_step(tcfg, topt.AdamWConfig(lr=1e-3))(
            state, tpipe.batch_at(dc, 0, device="cpu"))
    return tcfg, state


def port_state_leaves(state) -> dict:
    return {lid: tckpt._host(leaf) for lid, leaf in tckpt._leaves(state)}


def test_checkpoint_written_by_the_port_restores_into_the_jax_package(tmp_path):
    tcfg, state = tiny_state()
    jcfg, _ = configs("granite-3-8b")
    tckpt.save(str(tmp_path), 1, state)
    jp = to_jax(weights.to_numpy_params(state["params"], tcfg), jcfg)
    like = jax.eval_shape(lambda: {"params": jp, "opt": jopt.init(jp)})
    restored = leaf_dict(jckpt.restore(str(tmp_path), 1, like))
    mine = port_state_leaves(state)
    assert set(restored) == set(mine)
    for k, v in mine.items():
        assert restored[k].dtype == v.dtype and np.array_equal(restored[k], v), k


def test_checkpoint_written_by_the_jax_package_restores_into_the_port(tmp_path):
    jcfg, tcfg = configs("granite-3-8b")
    jp = to_jax(weights.numpy_params(tcfg, 3), jcfg)
    jstate = {"params": jp, "opt": jopt.init(jp)}
    dc = jpipe.DataConfig(vocab=tcfg.vocab, global_batch=2, seq_len=16)
    jstate, _ = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig()))(
        jstate, jpipe.batch_at(dc, 0))
    jckpt.save(str(tmp_path), 4, jstate)
    assert tckpt.latest_step(str(tmp_path)) == 4
    _, like = tiny_state(trained=False)
    state = tckpt.restore(str(tmp_path), 4, like)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in state["params"].parameters())
    mine, want = port_state_leaves(state), leaf_dict(jstate)
    assert set(mine) == set(want)
    for k, v in want.items():
        assert np.array_equal(mine[k], v), k


def test_checkpoint_torn_write_bit_rot_and_shape(tmp_path):
    tcfg, state = tiny_state()
    d = str(tmp_path)
    tckpt.save(d, 3, state)
    torn = tmp_path / "step_00000007.tmp.1.2"  # a writer that died mid-save
    torn.mkdir()
    (torn / "params.embed.npy").write_bytes(b"torn")
    assert tckpt.latest_step(d) == 3
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    restored = tckpt.restore(d, 3, state)
    for (k, a), (_, b) in zip(sorted(port_state_leaves(state).items()),
                              sorted(port_state_leaves(restored).items())):
        assert np.array_equal(a, b), k
    other = tsteps.init_state(tcfg.replace(d_ff=2 * tcfg.d_ff), 0, "cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(d, 3, other)
    step_dir = tmp_path / "step_00000003"
    victim = max(step_dir.glob("*.npy"), key=lambda p: p.stat().st_size)
    arr = np.load(victim)
    flat = arr.reshape(-1).view(np.uint8).copy()
    flat[0] ^= 0xFF
    np.save(victim, flat.view(arr.dtype).reshape(arr.shape))
    with pytest.raises(IOError, match="integrity"):
        tckpt.restore(d, 3, state)


def test_async_checkpoint_save(tmp_path):
    _, state = tiny_state()
    t = tckpt.save(str(tmp_path), 9, state, blocking=False)
    t.join(timeout=120)
    assert not t.is_alive()
    assert tckpt.latest_step(str(tmp_path)) == 9
    got = port_state_leaves(tckpt.restore(str(tmp_path), 9, state))
    for k, v in port_state_leaves(state).items():
        assert np.array_equal(got[k], v), k


def test_checkpoint_restart_resumes_identically(tmp_path):
    """6 steps straight against 3, a save, a restore into a fresh state and
    3 more: the params and every metric equal bit for bit."""
    tcfg, _ = tiny_state(trained=False)
    dc = tpipe.DataConfig(vocab=tcfg.vocab, global_batch=4, seq_len=32, seed=1)
    step = tsteps.make_train_step(tcfg, topt.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                         total_steps=20))
    state = tsteps.init_state(tcfg, 0, device="cpu")
    straight = []
    for i in range(6):
        state, m = step(state, tpipe.batch_at(dc, i, device="cpu"))
        straight.append({k: float(v) for k, v in m.items()})
        if i == 2:
            tckpt.save(str(tmp_path), 2, state)
    again = tckpt.restore(str(tmp_path), 2, tsteps.init_state(tcfg, 1, device="cpu"))
    resumed = []
    for i in range(3, 6):  # skip-ahead: data is a pure function of step
        again, m = step(again, tpipe.batch_at(dc, i, device="cpu"))
        resumed.append({k: float(v) for k, v in m.items()})
    assert resumed == straight[3:]
    for (k, a), (_, b) in zip(sorted(port_state_leaves(state).items()),
                              sorted(port_state_leaves(again).items())):
        assert np.array_equal(a, b), k


# ------------------------------------------------------------ the driver
def test_driver_trains_and_the_loss_falls():
    """``python -m repro_torch.launch.train --arch granite-3-8b --reduced
    --steps 12 --device cpu``, as tests/test_system.py asks of the JAX
    package's loop."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "granite-3-8b", "--reduced", "--steps", "12", "--device", "cpu",
                          "--log-every", "1"], capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    losses = [float(x) for x in re.findall(r"^step +\d+ loss (\S+)", out.stdout, re.M)]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < 0.95 * np.mean(losses[:3]), losses


def test_driver_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--arch", "granite-3-8b", "--reduced", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    first = ttrain.main(argv + ["--steps", "4"])
    assert tckpt.latest_step(str(tmp_path)) == 3
    resumed = ttrain.main(argv + ["--steps", "6", "--resume"])
    assert "[resume] from step 3" in capsys.readouterr().out
    straight = ttrain.main(["--arch", "granite-3-8b", "--reduced", "--batch", "2", "--seq",
                            "16", "--device", "cpu", "--steps", "6"])
    assert [r["step"] for r in resumed["steps"]] == [4, 5]
    assert len(first["steps"]) == 4
    # the schedule is the 6-step run's in both, so steps 4-5 are its own
    for r, s in zip(resumed["steps"], straight["steps"][4:]):
        assert r["lr"] == s["lr"]
        assert np.isfinite(r["loss"])


def driver_args(epochs: int = 4, kill: int = 1, phi: int = 2):
    return ["--cosim-epochs", str(epochs), "--cosim-kill-spine", str(kill), "--cosim-phi",
            str(phi), "--cosim-only"]


def strip_builds(lines):
    """The lines without their build counts: the JAX package's count XLA
    programs compiled, the port's kernel libraries built."""
    return [re.sub(r" builds \d+$", "", line) for line in lines]


def jax_cosim_lines(epochs: int, kill: int, phi: int) -> list:
    args = jtrain.argparse.Namespace(cosim_epochs=epochs, cosim_kill_spine=kill,
                                     cosim_phi=phi, n_chunks=4)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jtrain._cosim_plan(args)
    return buf.getvalue().strip().splitlines()


@pytest.mark.parametrize("epochs,kill", [(4, 1), (6, -1)])
def test_cosim_only_prints_the_jax_drivers_plan(epochs, kill, capsys):
    out = ttrain.main(["--device", "cpu", *driver_args(epochs, kill)])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == out["cosim"] and out["steps"] == []
    want = jax_cosim_lines(epochs, kill, 2)
    assert strip_builds(printed) == strip_builds(want)
    assert len(printed) == epochs + 1


def test_driver_falls_back_to_one_device_for_one_pod_or_an_odd_batch(capsys):
    """``--pods 1``, and 4 pods for a batch of 6: the JAX driver's fallback
    line (its own, under this process's one JAX device), and the
    single-device step."""
    argv = ["--arch", "granite-3-8b", "--reduced", "--steps", "0", "--seq", "8",
            "--grad-sync", "seqbalance"]
    old_argv = sys.argv
    sys.argv = ["train", *argv, "--batch", "4"]
    try:
        jtrain.main()
    finally:
        sys.argv = old_argv
    want = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("[grad-sync]")]
    assert len(want) == 1 and "falling back" in want[0]
    for more in (["--pods", "1", "--batch", "4"], ["--pods", "4", "--batch", "6"]):
        out = ttrain.main([*argv, *more, "--device", "cpu"])
        got = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("[grad-sync]")]
        assert got == want and out["pods"] == 1, (more, got)


def test_training_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    _, tcfg = configs("granite-3-8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.batch_at(tpipe.DataConfig(vocab=100, global_batch=1, seq_len=4), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsteps.init_state(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodel.init_params(tcfg, trainable=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        weights.from_jax_params(weights.numpy_params(tcfg, 0), tcfg, trainable=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "granite-3-8b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(driver_args())


# ------------------------------------------------------------ phase 17's reference
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def test_train_reference_limits_sit_between_the_readings_and_the_faults():
    """train_reference.json (written by this file as a script) records the
    port's CPU runs of phase 17's case against the JAX package's float32
    run: the float32 run within chip_smoke.TRAIN_TOL, the bfloat16 run
    within chip_smoke.bf16_limits (which lie above the JAX package's own
    bfloat16 spread), and each planted optimizer fault outside both: no
    clip and b1, b2 swapped move the 3-step updates by less than bfloat16
    rounding does, but move the norms of the updates by more."""
    ref = json.loads(REFERENCE.read_text())
    assert ref["case"] == chip_smoke.TRAIN_CASE
    tol, limits = chip_smoke.TRAIN_TOL, chip_smoke.bf16_limits(ref)
    assert all(ref["port_cpu"]["float32"][k] <= tol[k] for k in tol), ref["port_cpu"]
    assert all(ref["port_cpu"]["bfloat16"][k] <= limits[k] for k in limits), ref["port_cpu"]
    assert all(limits[k] > ref["jax_bf16_spread"][k] for k in limits if k != "lr_ulps")
    assert set(ref["planted"]) == set(PLANTED)
    for fault, reading in ref["planted"].items():
        assert any(reading[k] > tol[k] for k in tol), (fault, reading)
        assert any(reading[k] > limits[k] for k in limits), (fault, reading)
    assert ref["cosim"]["flags"] == chip_smoke.TRAIN_COSIM
    args = ttrain.parser().parse_args(list(chip_smoke.TRAIN_ARGV))
    assert {k: getattr(args, k) for k in chip_smoke.TRAIN_COSIM} == chip_smoke.TRAIN_COSIM


def jax_train_run(case: dict, dtype: str) -> dict:
    """``case``'s steps of the JAX package's train step (``model.loss_fn``
    under ``jax.value_and_grad``, then ``optimizer.update``, as
    ``launch.steps.make_train_step`` composes them), read as
    ``chip_smoke.train_readings`` reads the port's."""
    import gc

    tcfg = chip_smoke.train_cfg(case, dtype)
    jcfg = jreg.get_config(case["arch"]).replace(dtype=dtype, **case["replace"])
    jp = to_jax(weights.numpy_params(tcfg, case["seed"]), jcfg)
    opt = jopt.init(jp)
    ocfg = jopt.AdamWConfig(**case["opt"])
    dcfg = jpipe.DataConfig(vocab=jcfg.vocab, global_batch=case["batch"],
                            seq_len=case["seq"], seed=case["seed"])
    vg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))
    upd = jax.jit(lambda g, s, p: jopt.update(g, s, p, ocfg), donate_argnums=(0, 1))
    rows = []
    for i in range(case["steps"]):
        (loss, aux), g = vg(jp, jpipe.batch_at(dcfg, i))
        grad = chip_smoke.leaf_readings(
            {k: torch.from_numpy(np.asarray(v)) for k, v in leaf_dict(g).items()},
            case["samples"])
        jp, opt, m = upd(g, opt, jp)
        rows.append({"loss": float(loss), "nll": float(aux["nll"]),
                     "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]), "grad": grad})
        del g
    del opt
    gc.collect()
    final = leaf_dict(jp)
    del jp
    p0 = leaf_dict(weights.numpy_params(tcfg, case["seed"]))
    delta = {k: torch.from_numpy(final[k] - p0[k]) for k in final}
    return {"steps": rows, "update": chip_smoke.leaf_readings(delta, case["samples"])}


def port_cpu_run(case: dict, dtype: str, fault: str | None = None) -> dict:
    tcfg = chip_smoke.train_cfg(case, dtype)
    tree = weights.numpy_params(tcfg, case["seed"])
    if fault is None:
        return chip_smoke.train_readings(tcfg, case, tree, "cpu")
    update, change = planted_update(fault)
    run_case = dict(case, opt=change(case["opt"]))
    return chip_smoke.train_readings(tcfg, run_case, tree, "cpu", update=update)


def write_train_reference() -> None:
    import gc

    t_start = time.time()
    case = chip_smoke.TRAIN_CASE
    runs = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.time()
        runs[dtype] = jax_train_run(case, dtype)
        gc.collect()
        print(f"jax {dtype}: {time.time() - t0:.1f} s, losses "
              f"{[r['loss'] for r in runs[dtype]['steps']]}", flush=True)
    ref32 = runs["float32"]
    out = {"jax_bf16_spread": chip_smoke.train_agreement(runs["bfloat16"], ref32)}
    print("jax bf16 spread", out["jax_bf16_spread"], flush=True)
    out["port_cpu"] = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.time()
        out["port_cpu"][dtype] = chip_smoke.train_agreement(port_cpu_run(case, dtype), ref32)
        gc.collect()
        print(f"port cpu {dtype} ({time.time() - t0:.1f} s)", out["port_cpu"][dtype],
              flush=True)
    out["planted"] = {}
    for fault in PLANTED:
        out["planted"][fault] = chip_smoke.train_agreement(
            port_cpu_run(case, "float32", fault), ref32)
        gc.collect()
        print("planted", fault, out["planted"][fault], flush=True)
    args = types.SimpleNamespace(**chip_smoke.TRAIN_COSIM)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        plan = jtrain._cosim_plan(args)
    cosim = {"flags": chip_smoke.TRAIN_COSIM, "lines": buf.getvalue().strip().splitlines(),
             "inactive": list(plan.inactive)}
    REFERENCE.write_text(json.dumps({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py "
                   "--write-train-reference",
        "source": "repro.models.model.loss_fn under jax.value_and_grad, then "
                  "repro.train.optimizer.update (repro.launch.steps.make_train_step's "
                  "single-device step), JAX package on the CPU, weights "
                  "repro_torch.models.weights.numpy_params, batches "
                  "repro.data.pipeline.batch_at; read by chip_smoke.leaf_readings; cosim: "
                  "repro.launch.train._cosim_plan's printed lines; port_cpu and planted: "
                  "chip_smoke.train_agreement of the port's CPU runs (planted: a fault of "
                  "tests/test_torch_train.py::PLANTED in the optimizer) against the JAX "
                  "float32 run",
        "commit": commit(), "backend": "cpu", "case": case, "runs": runs, **out,
        "cosim": cosim, "wall_s": time.time() - t_start}) + "\n")


def commit() -> str:
    return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                          text=True).stdout.strip()


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-train-reference"]:
        write_train_reference()
    else:
        sys.exit("usage: test_torch_train.py --write-train-reference")
