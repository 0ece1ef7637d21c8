"""The rest of the paper's simulator in the port against the JAX package:
Table I's closed forms (``core/gbn.py``), the Fig. 8 testbed fabrics, and
Fig. 10, Fig. 11 and Table II run on them (``chip_smoke.testbed_readings``,
the copy of ``benchmarks/paper_benches.py:99-156`` that chip_smoke.py
phase 16 runs on the card), at ``chip_smoke.TESTBED_REDUCED``'s cut: 2 ms
with the pairs starting at 0, 0.5 and 1 ms and read from step 150, Table
II 1 ms; and each planted fault of ``chip_smoke.TESTBED_PLANTED`` caught
by the gates of its part.

Run as a script to regenerate ``src/repro_torch/netsim/testbed_reference.json``,
the JAX package's readings at the paper's scale with the port's planted
readings beside them (a few minutes on one core):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_testbed.py --write-testbed-reference
"""
import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gbn as jg  # noqa: E402
from repro.netsim import engine as je, metrics as jm, sweep as js, topology as jt  # noqa: E402
from repro.netsim import workloads as jw  # noqa: E402
from repro.netsim.dcqcn import DCQCNParams as JP  # noqa: E402
from repro_torch.core import gbn as tg  # noqa: E402
from repro_torch.netsim import engine as te, metrics as tm, sweep as ts, topology as tt  # noqa: E402
from repro_torch.netsim import workloads as tw  # noqa: E402
from repro_torch.netsim.dcqcn import DCQCNParams as TP  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

REFERENCE = ROOT / "src" / "repro_torch" / "netsim" / "testbed_reference.json"


# ------------------------------------------------------------- Table I
def _gbn_grid():
    """Sizes from 1 KB to 100 MB, hole positions over [0, 1) and NAK
    timeouts from 1 us to 1 ms, as a broadcast grid of float32 arrays."""
    rng = np.random.default_rng(0)
    sizes = np.geomspace(1e3, 1e8, 23).astype(np.float32)[:, None, None]
    frac = np.concatenate([[0.0, 0.5], rng.uniform(0.0, 1.0, 9)]).astype(np.float32)[None, :,
                                                                                    None]
    nak = np.geomspace(1e-6, 1e-3, 7).astype(np.float32)[None, None, :]
    return sizes, frac, nak


def test_gbn_table1_functions_match_reference():
    """ideal_fct, fct_with_one_delayed_packet and table1_inflation on a grid
    of sizes, hole positions and NAK timeouts, within 1e-6 relative of the
    JAX package's; Table I's 5.77x at 64 KB and 2.83x at 1 MB."""
    sizes, frac, nak = _gbn_grid()
    pairs = (
        (jg.ideal_fct(sizes, 40e9, 8e-6), tg.ideal_fct(sizes, 40e9, 8e-6, device="cpu")),
        (jg.fct_with_one_delayed_packet(sizes, 25e9, 4e-6, frac, nak, 0.5),
         tg.fct_with_one_delayed_packet(sizes, 25e9, 4e-6, frac, nak, 0.5, device="cpu")),
        (jg.table1_inflation(sizes, delayed_frac=frac, nak_timeout_s=nak),
         tg.table1_inflation(sizes, delayed_frac=frac, nak_timeout_s=nak, device="cpu")),
        (jg.table1_inflation(jnp.asarray(sizes)), tg.table1_inflation(torch.as_tensor(sizes))),
        (jg.table1_inflation(64e3), tg.table1_inflation(64e3, device="cpu")),
    )
    for want, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0.0)
    table1 = tg.table1_inflation(torch.tensor([64e3, 1e6]))
    np.testing.assert_allclose(table1.numpy(),
                               np.asarray(jg.table1_inflation(jnp.array([64e3, 1e6]))),
                               rtol=1e-6)
    assert [round(float(v), 2) for v in table1] == [5.77, 2.83]


# ------------------------------------------------------- Fig. 8 fabrics
@pytest.mark.parametrize("name", ["testbed_symmetric", "testbed_asymmetric"])
def test_testbed_fabric_matches_reference(name):
    """Field for field the JAX package's: capacities (the 80G overrides),
    static tables, every route of every host pair on every path, and the
    fault layer's link maps."""
    j = getattr(jt, name)()
    t = getattr(tt, name)(device="cpu")
    for f in ("kind", "n_leaf", "n_paths", "hosts_per_leaf", "n_links", "n_fabric_hops",
              "base_rtt_s", "n_hosts"):
        assert getattr(j, f) == getattr(t, f), f
    np.testing.assert_array_equal(np.asarray(j.capacity), t.capacity.numpy())
    np.testing.assert_array_equal(j.uplink_ids, t.uplink_ids)
    np.testing.assert_array_equal(j.path_link_table, t.path_link_table)
    src, dst, path = (a.ravel() for a in np.meshgrid(
        np.arange(j.n_hosts), np.arange(j.n_hosts), np.arange(j.n_paths), indexing="ij"))
    jr = j.subflow_links(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(path))
    tr = t.subflow_links(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(path))
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    for link in range(j.n_links + 1):
        assert jt.paths_for_link(j, link) == tt.paths_for_link(t, link), link
    for spine in range(j.n_paths):
        assert jt.spine_links(j, spine) == tt.spine_links(t, spine), spine
    fat = np.flatnonzero(t.capacity.numpy()[:-1] == np.float32(80e9))
    assert fat.tolist() == ([2, 5, 10, 11] if name == "testbed_asymmetric" else [])


# --------------------------------------------- Fig. 10, Fig. 11, Table II
def _jax_run(what, topo, cfg, traces):
    """One batch from an empty executable cache (the two fabrics share a
    shape, and the cache keys out capacities: ROADMAP.md §3)."""
    js.clear_cache()
    return js.run_batch(topo, cfg, traces)


def _jax_run_alone(what, topo, cfg, traces):
    """Each trace alone from an empty cache, as benchmarks/paper_benches.py
    runs them."""
    results, outs = [], []
    for trace in traces:
        r, o = _jax_run(what, topo, cfg, [trace])
        results += r
        outs += o
    return results, outs


def _port_run(what, topo, cfg, traces):
    return ts.run_batch(topo, cfg, traces, device="cpu")


def _jax_readings(scale, run=_jax_run):
    return chip_smoke.testbed_readings(run, je, jt, jw, jm, JP, {}, scale)


def _port_readings(scale, fault=None, parts=chip_smoke.TESTBED_PARTS):
    return chip_smoke.testbed_readings(_port_run, te, tt, tw, tm, TP, {"device": "cpu"},
                                       scale, fault, parts)


@functools.lru_cache(maxsize=None)
def _reduced_jax():
    return _jax_readings(chip_smoke.TESTBED_REDUCED)


def test_testbed_runs_match_reference_reduced():
    """Fig. 10, Fig. 11 and Table II at the reduced scale against a live
    JAX run, each scheme once: inside phase 16's gates, the per-path late
    means within 1e-5, and the paper's facts as the JAX package reads them
    (SeqBalance spreads less than ECMP, the fat path gains, no congestion
    packets to speak of)."""
    want = _reduced_jax()
    got = _port_readings(chip_smoke.TESTBED_REDUCED)
    errs, faults = chip_smoke.testbed_faults(got, want)
    assert not faults, faults
    assert max(v for k, v in errs.items() if k.endswith("per_path")) <= 1e-5, errs
    assert got["facts"] == want["facts"]
    assert want["facts"]["fig10_seqbalance_spread_below_ecmp"]
    assert want["facts"]["fig11_fat_gain_above_1"]


@pytest.mark.parametrize("fault", sorted(chip_smoke.TESTBED_PLANTED))
def test_planted_fault_fails_the_gates(fault):
    """Each planted fault, run by the port at the reduced scale on the part
    it belongs to, lands outside phase 16's gates against the JAX
    package's clean run."""
    part = chip_smoke.TESTBED_PLANTED[fault]
    _, faults = chip_smoke.testbed_faults(
        _port_readings(chip_smoke.TESTBED_REDUCED, fault, (part,)), _reduced_jax())
    assert faults, f"{fault} passes every gate"


def test_testbed_reference_covers_the_phase():
    """The file chip_smoke.py phase 16 holds the card to: the paper's
    scale, every reading, the facts true, and each planted fault's
    readings caught by the gates."""
    ref = json.loads(REFERENCE.read_text())
    assert ref["backend"] == "cpu" and ref["scale"] == {
        k: list(v) if isinstance(v, tuple) else v for k, v in chip_smoke.TESTBED_PAPER.items()}
    want = ref["readings"]
    assert chip_smoke.testbed_faults(ref["port_cpu"], want)[1] == []
    assert want["facts"]["fig10_seqbalance_spread_below_ecmp"]
    assert want["facts"]["fig11_fat_gain_above_1"]
    assert set(want["table2"]) == {str(n) for n in chip_smoke.TABLE2_SENDERS}
    for fault in chip_smoke.TESTBED_PLANTED:
        assert chip_smoke.testbed_faults(ref["planted"][fault], want)[1], fault


def write_testbed_reference() -> None:
    """Run the JAX package's Fig. 10, Fig. 11 and Table II at the paper's
    scale (each run from an empty executable cache), and the port on the
    CPU clean and with each planted fault."""
    scale = chip_smoke.TESTBED_PAPER
    readings = _jax_readings(scale, _jax_run_alone)
    port = _port_readings(scale)
    planted = {f: _port_readings(scale, f) for f in chip_smoke.TESTBED_PLANTED}
    for name, got in [("port_cpu", port)] + list(planted.items()):
        errs, faults = chip_smoke.testbed_faults(got, readings)
        print(name, json.dumps(errs), faults, flush=True)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip()
    REFERENCE.write_text(json.dumps({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_testbed.py "
                   "--write-testbed-reference",
        "source": "benchmarks/paper_benches.py::bench_fig10_symmetric, "
                  "bench_fig11_asymmetric, bench_table2_overhead (chip_smoke."
                  "testbed_readings), JAX package, each run from an empty cache; planted: "
                  "the port on the CPU with each chip_smoke.TESTBED_PLANTED fault",
        "commit": commit, "backend": "cpu", "scale": scale, "readings": readings,
        "port_cpu": port, "planted": planted,
    }, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-testbed-reference"]:
        write_testbed_reference()
    else:
        sys.exit("usage: test_torch_testbed.py --write-testbed-reference")
