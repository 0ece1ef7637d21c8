"""The port's ring all-reduce against the JAX package's, on the CPU.

``repro_torch.dist.collectives.seqbalance_all_reduce`` on a ``LocalAxis``
(every member on one device) against ``repro.dist.collectives``' own under
``shard_map`` on 8 forced host devices (one subprocess runs every case):
rings of 2, 4 and 8, the three wires, the default plan, a plan with a path
quarantined and a ``PinnedPlan`` from ``replan_chunk_paths``, on member
sizes that need padding.  Then the ``ProcessAxis`` transport (gloo, 2 and 4
ranks with a ``file://`` rendezvous, one spawn a world size) against the
``LocalAxis`` bit for bit, ``quantize_int8`` against the JAX package's,
``tree_all_reduce_mean`` and the permute counter.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.dist import collectives as coll  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# (ring size, wire, plan, each member's shape): every plan and wire at each
# size; 37 and 65 entries a member are cut into 4 x n segments with padding
MEMBER_SHAPES = ((37,), (5, 13))
CASES = [(n, wire, plan, MEMBER_SHAPES[(i + j) % 2])
         for i, n in enumerate((2, 4, 8)) for wire in coll.WIRE_DTYPES
         for j, plan in enumerate(("default", "inactive", "pinned"))]
def member_inputs(n: int, shape: tuple, seed: int) -> np.ndarray:
    """[n, *shape] float32, each member at its own magnitude (1e-2 to 1e2),
    so that the int8 wire's scales differ between members."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-2, 2, n)
    x = rng.standard_normal((n, *shape)) * mag.reshape((n,) + (1,) * len(shape))
    return x.astype(np.float32)


def case_inputs(k: int) -> np.ndarray:
    n, _, _, shape = CASES[k]
    return member_inputs(n, shape, 1000 + k)


JAX_RING = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    sys.path.insert(0, sys.argv[3])
    from repro.dist import collectives as jcoll
    import test_torch_collectives as t

    out = {}
    for k, (n, wire, plan, shape) in enumerate(t.CASES):
        mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
        p = t.chip_smoke.ring_plan(jcoll, plan, wire)
        f = jax.jit(jax.shard_map(lambda x: jcoll.seqbalance_all_reduce(x, "pod", p),
                                  mesh=mesh, in_specs=P("pod"), out_specs=P("pod")))
        out[f"ring{k}"] = np.asarray(f(t.case_inputs(k)[:, None]))[:, 0]
    for k, x in enumerate(t.quantize_inputs()):
        q, s = jcoll.quantize_int8(x)
        out[f"q{k}"], out[f"s{k}"] = np.asarray(q), np.asarray(s)
    np.savez(sys.argv[1], **out)
    print(json.dumps({"devices": jax.device_count()}))
""")


def quantize_inputs() -> list:
    rng = np.random.default_rng(7)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 127.0, -3.5], np.float32)  # scale 1: ties
    return [rng.standard_normal(300).astype(np.float32) * 3, ties,
            np.zeros(5, np.float32), (rng.standard_normal((4, 9)) * 1e-3).astype(np.float32)]


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    """Every case's JAX output, from one subprocess on 8 forced devices."""
    path = tmp_path_factory.mktemp("jax_ring") / "out.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_RING, str(path), "", str(ROOT / "tests")],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["devices"] == 8
    return dict(np.load(path))


def local_ring(k: int, device="cpu") -> np.ndarray:
    n, wire, plan, _ = CASES[k]
    x = torch.from_numpy(case_inputs(k)).to(device)
    return coll.seqbalance_all_reduce(x, coll.LocalAxis(n, device),
                                      chip_smoke.ring_plan(coll, plan, wire)).cpu().numpy()


def differing(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.argwhere(got.view(np.uint32) != want.view(np.uint32))


@pytest.mark.parametrize("k", range(len(CASES)),
                         ids=[f"n{n}-{w}-{p}" for n, w, p, _ in CASES])
def test_ring_equals_the_jax_packages_bit_for_bit(jax_outputs, k):
    """Every member's output equal to the JAX package's, bit for bit, and
    within the wire's error of the exact sum.  Bit for bit on the int8 wire
    needs XLA's own roundings: absmax / 127 as a product by 1 / 127, and
    q * scale + acc in one fused multiply-add (each alone moves 305 and 815
    outputs of these cases by an ulp)."""
    n, wire, _, _ = CASES[k]
    got, want = local_ring(k), jax_outputs[f"ring{k}"]
    assert got.shape == want.shape and got.dtype == np.float32
    bad = differing(got, want)
    assert not len(bad), [(tuple(i), got[tuple(i)], want[tuple(i)]) for i in bad[:10]]
    x = case_inputs(k).astype(np.float64)
    exact = x.sum(0)
    err = np.abs(got - exact[None]).max()
    # the float32 wire: sums of n float32 terms; bfloat16: tests/test_collectives.py:66;
    # int8: n roundings of at most half a scale, each scale at most the
    # members' absmax sum / 127
    limit = {"float32": 1e-6 * np.abs(exact).max() * n,
             "bfloat16": 2e-2 * np.abs(exact).max(),
             "int8": n * np.abs(x).reshape(n, -1).max(1).sum() / 127 / 2}[wire]
    assert err <= limit, (err, limit)


def test_ring_members_differ_only_on_lossy_wires(jax_outputs):
    """On the float32 wire every member ends with the same sum; on the lossy
    wires a segment's owner keeps its exact sum and the others its decoded
    copy, in the JAX package as here."""
    for k, (n, wire, _, _) in enumerate(CASES):
        out = jax_outputs[f"ring{k}"]
        same = all(np.array_equal(out[0], out[m]) for m in range(n))
        assert same == (wire == "float32"), (CASES[k], same)


def test_a_scale_shared_by_all_members_fails_the_comparison(jax_outputs, monkeypatch):
    """Planted fault: one absmax over the whole [members, seg] payload, so
    every member sends at the largest member's scale."""
    def shared(x, wire):
        if wire == "int8":
            q, scale = coll.quantize_int8(x)
            return q, scale.expand(x.shape[0], 1)
        return orig(x, wire)

    orig = coll._encode
    monkeypatch.setattr(coll, "_encode", shared)
    moved = [k for k, (n, wire, _, _) in enumerate(CASES)
             if wire == "int8" and len(differing(local_ring(k), jax_outputs[f"ring{k}"]))]
    assert moved == [k for k, c in enumerate(CASES) if c[1] == "int8"]


def test_quantize_int8_equals_the_jax_packages(jax_outputs):
    for k, x in enumerate(quantize_inputs()):
        q, s = coll.quantize_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
        np.testing.assert_array_equal(q.numpy(), jax_outputs[f"q{k}"])
        assert s.numpy().view(np.uint32) == jax_outputs[f"s{k}"].view(np.uint32)
        back = coll.dequantize_int8(q, s).numpy()
        assert np.abs(back - x).max() <= s.item() / 2 * (1 + 1e-6)


def test_quantize_int8_per_member_scale():
    x = torch.from_numpy(member_inputs(4, (50,), 3))
    q, s = coll.quantize_int8(x, dim=-1)
    assert s.shape == (4, 1)
    for m in range(4):
        qm, sm = coll.quantize_int8(x[m])
        assert torch.equal(q[m], qm) and torch.equal(s[m, 0], sm)
    assert int(q.abs().amax(1).min()) == 127  # each member at its own full range


def test_permute_counter_counts_every_round():
    coll.permute_rounds = 0
    x = torch.from_numpy(member_inputs(4, (10, 3), 1))
    tree = {"a": x, "b": [x[:, :2], x[:, 0, 0]]}
    axis = coll.LocalAxis(4, "cpu")
    plan = coll.PathPlan(n_chunks=3)
    out = coll.tree_all_reduce_mean(tree, axis, plan)
    assert coll.permute_rounds == 3 * 2 * (4 - 1) * 3  # leaves x chunks x rounds
    want = x.double().mean(0)
    assert torch.allclose(out["a"].double(), want.expand(x.shape), rtol=0,
                          atol=1e-6 * float(x.abs().max()))
    assert out["b"][1].shape == (4,) and isinstance(out["b"], list)
    coll.permute_rounds = 0
    coll.seqbalance_all_reduce(x[:1], coll.LocalAxis(1, "cpu"), plan)
    assert coll.permute_rounds == 0  # a ring of one moves nothing


def test_tree_all_reduce_mean_keeps_dtypes_and_divides_in_float32():
    x = torch.from_numpy(member_inputs(2, (64,), 5))
    axis = coll.LocalAxis(2, "cpu")
    got = coll.tree_all_reduce_mean({"f": x, "h": x.to(torch.bfloat16)}, axis)
    assert got["f"].dtype == torch.float32 and got["h"].dtype == torch.bfloat16
    s = coll.seqbalance_all_reduce(x, axis)
    assert torch.equal(got["f"], s / 2)
    sh = coll.seqbalance_all_reduce(x.to(torch.bfloat16), axis)
    assert torch.equal(got["h"], (sh.float() / 2).to(torch.bfloat16))


def test_baseline_all_reduce_is_the_sum_over_members():
    x = torch.from_numpy(member_inputs(3, (7,), 2))
    got = coll.baseline_all_reduce(x, coll.LocalAxis(3, "cpu"))
    assert got.shape == x.shape
    assert torch.equal(got[1], x.sum(0))


def test_local_axis_refuses_a_tensor_elsewhere_or_of_another_size():
    axis = coll.LocalAxis(2, "cpu")
    with pytest.raises(ValueError, match="members"):
        coll.seqbalance_all_reduce(torch.zeros(3, 4), axis)
    with pytest.raises(ValueError, match="ring of 0"):
        coll.LocalAxis(0, "cpu")


# ------------------------------------------------------------ gloo ranks
def run_ranks(code: str, world: int, tmp_path, args=()) -> list:
    """``code`` in ``world`` processes at once, each a rank of a gloo group
    (``init()`` in the code joins it through a ``file://`` rendezvous in
    ``tmp_path``); each rank saves its outputs to OUT (an .npz); returns
    them by rank."""
    init = tmp_path / f"rendezvous_{world}"
    prelude = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        import torch
        import torch.distributed as dist
        RANK, WORLD = int(sys.argv[1]), {world}
        OUT = sys.argv[2]
        ARGS = sys.argv[3:]

        def init():
            dist.init_process_group("gloo", init_method="file://{init}", rank=RANK,
                                    world_size=WORLD)
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, str(ROOT / "tests")]),
               OMP_NUM_THREADS="1")
    outs = [tmp_path / f"rank{world}_{r}.npz" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", prelude + textwrap.dedent(code), str(r),
                               str(outs[r]), *args], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for e in errs]
    return [dict(np.load(o)) for o in outs]


GLOO_RING = """
    init()
    from repro_torch.dist import collectives as coll
    import test_torch_collectives as t

    axis = coll.ProcessAxis()
    out = {}
    for k, (n, wire, plan, shape) in enumerate(t.CASES):
        if n != WORLD:
            continue
        coll.permute_rounds = 0
        x = torch.from_numpy(t.case_inputs(k)[RANK])
        plan = t.chip_smoke.ring_plan(coll, plan, wire)
        out[f"ring{k}"] = coll.seqbalance_all_reduce(x, axis, plan).numpy()
        out[f"rounds{k}"] = np.array(coll.permute_rounds)
    x = torch.from_numpy(t.member_inputs(WORLD, (6, 5), 9)[RANK])
    out["baseline"] = coll.baseline_all_reduce(x, axis).numpy()
    tree = coll.tree_all_reduce_mean({"w": x, "v": [x[0], x.to(torch.bfloat16)]}, axis,
                                     coll.PathPlan(n_chunks=2, wire_dtype="int8"))
    out["mean_w"], out["mean_v0"] = tree["w"].numpy(), tree["v"][0].numpy()
    out["mean_v1"] = tree["v"][1].float().numpy()
    np.savez(OUT, **out)
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("world", (2, 4))
def test_process_transport_equals_the_local_one_bit_for_bit(world, tmp_path):
    ranks = run_ranks(GLOO_RING, world, tmp_path)
    for k, (n, wire, plan, _) in enumerate(CASES):
        if n != world:
            continue
        local = local_ring(k)
        for r in range(world):
            assert not len(differing(ranks[r][f"ring{k}"], local[r])), (CASES[k], r)
            assert int(ranks[r][f"rounds{k}"]) == 4 * 2 * (n - 1)
    x = torch.from_numpy(member_inputs(world, (6, 5), 9))
    axis = coll.LocalAxis(world, "cpu")
    want = coll.tree_all_reduce_mean({"w": x, "v": [x[:, 0], x.to(torch.bfloat16)]}, axis,
                                     coll.PathPlan(n_chunks=2, wire_dtype="int8"))
    for r in range(world):
        np.testing.assert_allclose(ranks[r]["baseline"], x.sum(0).numpy(), rtol=1e-6)
        assert np.array_equal(ranks[r]["mean_w"], want["w"][r].numpy())
        assert np.array_equal(ranks[r]["mean_v0"], want["v"][0][r].numpy())
        assert np.array_equal(ranks[r]["mean_v1"], want["v"][1][r].float().numpy())
