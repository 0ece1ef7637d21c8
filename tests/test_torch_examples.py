"""The examples' twins (``repro_torch.examples``) and the flight-log report
twin (``repro_torch.obs.report``) against the JAX package's own scripts,
on the CPU.

  * simulate_datacenter: the twin's ``simulate`` on a small fabric and
    trace against the JAX package's ``sweep.run_jobs`` and ``metrics`` on
    the same, at PERF §2's gates (completion 1e-3, avg 0.5 %, p99 2 %);
    its printed lines in the JAX example's format.
  * serve_decode: every registry architecture at REDUCED size in float32,
    the weights carried across (``models.weights``): the twin's greedy
    tokens equal the JAX example's (``model.prefill`` and
    ``make_serve_step``, jitted) up to each row's first near-tie
    (``serve.compare``'s rule).
  * quickstart: the printed lines equal the JAX example's.
  * obs report: the text equals ``scripts/obs_report.report``'s on a flight
    log written by the port's ``run_cosim``.

Run as a script, it writes ``src/repro_torch/examples/examples_reference.json``
(chip_smoke.py phase 24: the JAX example's five schemes on
``topology.sim_2tier()``, default and ``--elephants``, from its own code
path, whose printed lines are checked against it):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_examples.py --write-examples-reference
"""
import contextlib
import importlib.util
import io
import json
import pathlib
import runpy
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_collectives import ROOT, SRC  # noqa: E402  (puts the root on sys.path)
import chip_smoke  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.examples import quickstart, serve_decode, simulate_datacenter as tsd  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.serve import compare  # noqa: E402
from test_torch_models import configs, to_jax  # noqa: E402

REFERENCE = pathlib.Path(SRC) / "repro_torch" / "examples" / "examples_reference.json"
SMALL = dict(duration_s=4e-3, trace_s=1e-3)  # the fabric leaf_spine(2, 4, 4)
DECODE = dict(batch=2, prompt_len=16, tokens=6)


def captured(fn, *args, **kw) -> tuple[str, object]:
    """(stdout, result) of ``fn(*args, **kw)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue(), out


# -------------------------------------------------------- simulate_datacenter
def jax_simulate(elephants: bool, duration_s: float, trace_s: float, topo=None) -> dict:
    """The JAX example's code path (``examples/simulate_datacenter.py``) on
    ``topo`` (``None``: ``sim_2tier()``): scheme -> its stats."""
    from repro.netsim import engine, metrics, sweep, topology, workloads

    sweep.clear_cache()  # its executable cache keys out a topology's capacity
    topo = topology.sim_2tier() if topo is None else topo
    wl = "fixed:10e6" if elephants else "websearch"
    trace = workloads.poisson_trace(workloads.TraceConfig(
        workload=wl, load=0.6, duration_s=trace_s, n_hosts=topo.n_hosts,
        host_bw=100e9, seed=1, hosts_per_leaf=topo.hosts_per_leaf,
        load_base_bw=topo.n_leaf * topo.uplink_ids.shape[-1] * 100e9,
    ))
    jobs = [(topo, engine.SimConfig(scheme=s, duration_s=duration_s), [trace])
            for s in tsd.SCHEMES]
    out = sweep.run_jobs(jobs)
    stats = {}
    for s, (r, o) in zip(tsd.SCHEMES, out):
        st = metrics.fct_stats(r[0], trace, topo, 100e9)
        imb = metrics.throughput_imbalance(o[0])
        stats[s] = {**{k: float(v) for k, v in st.items()},
                    "imbalance_median": float(np.median(imb)) if len(imb) else -1.0}
    return {"workload": wl, "flows": int(trace.valid.sum()), "stats": stats}


def stat_failures(got: dict, want: dict) -> list:
    """The schemes' readings outside PERF §2's gates (chip_smoke.GATES)."""
    return [f"{scheme} {k}: {got[scheme][k]} against {w[k]}"
            for scheme, w in want.items()
            for k, d in chip_smoke.stat_diffs(got[scheme], w).items()
            if not d <= chip_smoke.GATES[k]]


def test_simulate_datacenter_matches_the_jax_example_on_a_small_fabric():
    """The five schemes on leaf_spine(2, 4, 4) over a 1 ms websearch trace
    at load 0.6 for 4 ms: FCT stats within the gates, the same flows, the
    JAX example's line format."""
    from repro.netsim import topology as jtopo
    from repro_torch.netsim import topology

    want = jax_simulate(False, topo=jtopo.leaf_spine(2, 4, 4, 100e9), **SMALL)
    run = tsd.simulate(topology.leaf_spine(2, 4, 4, 100e9, device="cpu"), device="cpu",
                       **SMALL)
    print("\n".join(tsd.lines(run)))
    assert run["flows"] == want["flows"] > 0
    assert not stat_failures(run["stats"], want["stats"]), stat_failures(run["stats"],
                                                                       want["stats"])
    lines = tsd.lines(run)
    assert lines[0] == f"workload=websearch load=0.6 flows={want['flows']}"
    assert [ln.split()[0] for ln in lines[1:-1]] == list(tsd.SCHEMES)


def test_examples_reference_holds_the_jax_example():
    """The committed reference: both runs of the five schemes, each printed
    line of the JAX script equal to the one formatted from its stats; the
    quickstart's lines the twin's."""
    ref = json.loads(REFERENCE.read_text())
    assert ref["quickstart"] == quickstart.run("cpu")
    for name in ("default", "elephants"):
        run = ref[name]
        assert set(run["stats"]) == set(tsd.SCHEMES)
        got = tsd.lines({**run, "engine": "active-window", "wall_s": 0.0})
        assert got[:-1] == run["jax_lines"][:-1], (got, run["jax_lines"])


# ------------------------------------------------------------- serve_decode
@pytest.mark.parametrize("arch", treg.ARCHS)
def test_serve_decode_tokens_equal_the_jax_example(arch):
    """The twin's decode against the JAX example's jitted prefill and serve
    step on the same weights and inputs: each row's tokens equal up to its
    first near-tie (a top-1 margin under NEAR_TIE x SERVE_TOL x the row's
    RMS in the JAX logits), and at least the first token of every row."""
    from repro.launch import steps as jsteps
    from repro.models import model as jmodel

    jcfg, tcfg = configs(arch)
    tree = weights.numpy_params(tcfg, 0)
    params = weights.from_jax_params(tree, tcfg, "cpu")
    batch = serve_decode.example_inputs(tcfg, DECODE["batch"], DECODE["prompt_len"], "cpu")
    run = serve_decode.decode(params, tcfg, batch, DECODE["tokens"])

    jp = to_jax(tree, jcfg)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    S = DECODE["prompt_len"]
    logits, cache = jax.jit(jmodel.prefill, static_argnums=(1, 3))(
        jp, jcfg, jbatch, S + DECODE["tokens"])
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    serve_step = jax.jit(jsteps.make_serve_step(jcfg))
    toks, lgs = [tok], [logits]
    for _ in range(DECODE["tokens"] - 1):
        tok, logits, cache = serve_step(jp, tok, cache)
        toks.append(tok)
        lgs.append(logits)
    want_tokens = np.concatenate([np.asarray(t) for t in toks], axis=1)
    want_logits = torch.from_numpy(np.stack([np.asarray(x) for x in lgs]).astype(np.float32))
    rms = want_logits.pow(2).mean(-1).sqrt()
    upto = compare.tokens_before_near_tie(compare.margins(want_logits), rms,
                                          compare.SERVE_TOL["float32"])
    got = run["tokens"].numpy()
    print(arch, upto, got[:, :4].tolist(), want_tokens[:, :4].tolist())
    for i, n in enumerate(upto):
        assert np.array_equal(got[i, :n], want_tokens[i, :n]), (i, n)
    assert min(upto) >= 1, upto


# --------------------------------------------------------------- quickstart
def test_quickstart_lines_equal_the_jax_example():
    jax_out, _ = captured(runpy.run_path, str(ROOT / "examples" / "quickstart.py"),
                          run_name="__main__")
    port_out, lines = captured(quickstart.main, ["--device", "cpu"])
    assert port_out == jax_out
    assert lines == jax_out.splitlines()


# --------------------------------------------------------------- obs report
def test_obs_report_equals_the_jax_script_on_a_port_flight_log(tmp_path):
    """A flight log of the port's run_cosim (the killed-spine scenario on
    leaf_spine(4, 4, 4)): the report twin's text equals the JAX script's,
    with a row per epoch."""
    from repro_torch.dist import cosim
    from repro_torch.netsim import topology
    from repro_torch.obs import report

    topo = topology.leaf_spine(4, 4, 4, 100e9, device="cpu")
    path = tmp_path / "flight.jsonl"
    hist = cosim.run_cosim(topo, cosim.ring_hosts(topo, 8), 4e6, scheme="seqbalance",
                           epochs=4, phi_steps=2, n_chunks=4,
                           faults=(cosim.kill_spine(topo, 2, epoch=1, recover_epoch=3),),
                           flight=str(path), device="cpu")
    spec = importlib.util.spec_from_file_location("obs_report", ROOT / "scripts" / "obs_report.py")
    jscript = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jscript)
    jax_out, jrc = captured(jscript.report, str(path), 3)
    port_out, rc = captured(report.main, [str(path), "--top", "3"])
    print(port_out)
    assert (port_out, rc) == (jax_out, jrc) and rc == 0
    assert chip_smoke.report_epoch_rows(port_out) == len(hist.records) == 4


# ------------------------------------------------------ phase 24's reference
def write_reference() -> None:
    """The JAX example's five schemes on sim_2tier, default and --elephants,
    through its own code path; the script itself run beside it, its lines
    kept."""
    t0 = time.time()
    ref = {}
    for name, elephants in (("default", False), ("elephants", True)):
        run = jax_simulate(elephants, tsd.SIM_S, tsd.TRACE_S)
        argv = sys.argv
        sys.argv = ["simulate_datacenter.py"] + (["--elephants"] if elephants else [])
        try:
            out, _ = captured(runpy.run_path, str(ROOT / "examples" / "simulate_datacenter.py"),
                              run_name="__main__")
        finally:
            sys.argv = argv
        run["load"] = 0.6
        run["jax_lines"] = out.splitlines()
        got = tsd.lines({**run, "engine": "active-window", "wall_s": 0.0})
        assert got[:-1] == run["jax_lines"][:-1], (got, run["jax_lines"])
        ref[name] = run
    out, _ = captured(runpy.run_path, str(ROOT / "examples" / "quickstart.py"),
                      run_name="__main__")
    ref["quickstart"] = out.splitlines()
    ref["wall_s"] = time.time() - t0
    REFERENCE.write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps(ref, indent=1))


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-examples-reference"]:
        write_reference()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
