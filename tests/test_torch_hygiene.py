"""The port stands alone: no JAX and nothing of the JAX package in
src/repro_torch or chip_smoke.py, and its entry points run on the card
unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_importing_the_sweep_leaves_jax_out():
    code = ("import sys; import repro_torch.netsim.sweep, repro_torch.netsim.carry, "
            "repro_torch.netsim.engine, repro_torch.kernels.ops, repro_torch.obs, "
            "repro_torch.dist, repro_torch.netsim.profile, repro_torch.core.gbn, "
            "repro_torch.configs.registry, repro_torch.models.model, "
            "repro_torch.models.weights, repro_torch.models.moe, repro_torch.models.recurrent, "
            "repro_torch.serve.engine, repro_torch.serve.compare, "
            "repro_torch.data.pipeline, repro_torch.train.optimizer, "
            "repro_torch.train.checkpoint, repro_torch.launch.steps, "
            "repro_torch.launch.train, repro_torch.dist.sharding, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.examples.simulate_datacenter, "
            "repro_torch.examples.serve_decode, repro_torch.examples.quickstart, "
            "repro_torch.obs.report; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro' "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_importing_the_dry_run_sets_no_environment_variable():
    """``repro.launch.dryrun`` sets XLA_FLAGS at its import (line 2); the
    port's dry run changes nothing of the environment."""
    code = ("import os, json; before = dict(os.environ); "
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh; "
            "print(json.dumps(sorted(k for k in set(before) | set(os.environ) "
            "if before.get(k) != os.environ.get(k))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.kernels import ops
    from repro_torch.netsim import compact, engine, sweep, topology, workloads

    topo = topology.leaf_spine(2, 4, 4, 100e9, device="cpu")
    trace = workloads.poisson_trace(workloads.TraceConfig(
        workload="alistorage", load=0.5, duration_s=1e-4, n_hosts=8, host_bw=100e9,
        hosts_per_leaf=4))
    cfg = engine.SimConfig(duration_s=1e-4)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.run_one(topo, cfg, trace)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.run_jobs([(topo, cfg, [trace])])
    with pytest.raises(RuntimeError, match="CUDA"):
        compact.simulate_compact(topo, cfg, trace)
    for fabric in (topology.sim_2tier, topology.testbed_symmetric, topology.testbed_asymmetric):
        with pytest.raises(RuntimeError, match="CUDA"):
            fabric()
    from repro_torch.core import gbn
    from repro_torch.netsim import profile

    with pytest.raises(RuntimeError, match="CUDA"):
        gbn.table1_inflation(64e3)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile.profile_phases(topo, cfg, trace, warm_steps=1, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile.quiescence_profile(topo, cfg, trace, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.simulate(topo, cfg, trace)
    q = np.zeros((1, 64, 2, 16), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.linkload(np.zeros((4, 2), np.int32), np.ones(4, np.float32),
                     np.zeros(3, np.float32), np.ones(3, np.float32), n_links=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.run_one(topo, cfg, trace, reorder=1.0)
    from repro_torch.dist import cosim

    with pytest.raises(RuntimeError, match="CUDA"):
        cosim.run_cosim(topo, cosim.ring_hosts(topo, 4), 1e6, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        cosim.run_cosim_grid([dict(topo=topo, hosts=[0, 4], size_bytes=1e6, epochs=1)])
    from repro_torch.configs import registry
    from repro_torch.models import model, weights
    from repro_torch.serve import engine as serve

    mcfg = registry.get_config("gemma2-2b", reduced=True)
    for arch in ("gemma2-2b", "deepseek-moe-16b", "recurrentgemma-9b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init_params(registry.get_config(arch, reduced=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        weights.from_jax_params(weights.numpy_params(mcfg, 0), mcfg)
    params = model.init_params(mcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.ServeEngine(mcfg, params, batch_size=2, max_len=16)
    from repro_torch.dist import collectives
    from repro_torch.launch import mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_pod_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        collectives.seqbalance_all_reduce(np.ones((2, 8), np.float32), collectives.LocalAxis(2))
    from repro_torch.examples import quickstart, serve_decode, simulate_datacenter

    for example in (quickstart, serve_decode, simulate_datacenter):
        with pytest.raises(RuntimeError, match="CUDA"):
            example.main([])


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card, and
    alone in a directory without the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             cwd=cwd, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_every_kernel_source_is_built_and_reached():
    """Each csrc/*.cu is a library of build.KERNELS, and a wrapper of
    kernels/ reaches each library's C entry through build.entry."""
    from repro_torch.kernels import build

    csrc = ROOT / "src" / "repro_torch" / "csrc"
    assert sorted(p.stem for p in csrc.glob("*.cu")) == sorted(build.KERNELS)
    wrappers = "".join(p.read_text() for p in (ROOT / "src" / "repro_torch" / "kernels")
                       .glob("*.py"))
    for name in build.KERNELS:
        entry = f"{name}_launch"
        assert f'extern "C" int {entry}(' in (csrc / f"{name}.cu").read_text()
        assert f'"{entry}"' in wrappers, f"no wrapper reaches {entry}"
