"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), on the CPU.

  * For every cell of the registry on both production meshes, the
    argument bytes counted from shapes, specs and dtypes
    (``dryrun.expected_argument_bytes``) in the JAX package's layout equal
    the count from the JAX package's own trees (``jax.eval_shape``) and
    specs, and the port's count differs from it by exactly the leaves whose
    stacked dim the rule shards (``sharding.stacked_drops``) and, for
    decode, the cache laid out a pod at a time.  No trace: fast.
  * On a (2, 2) and a (2, 2, 2) fake mesh at REDUCED size, the traced
    records of gemma2-2b (train, prefill, decode) and deepseek-moe-16b
    (train) against the JAX package's ``run_cell`` on 8 forced host devices
    (one subprocess): argument bytes each equal to its count, FLOPs within
    ``chip_smoke.DRYRUN_FLOPS_LIMIT`` of the JAX package's.
  * The collective counter's counts equal ``CommDebugMode``'s.
  * Planted faults: one spec replicated raises the argument bytes; a ring
    whose counter is removed records no collective-permute bytes.
  * recurrentgemma-9b at its widths, cut to one superblock and B 64 x S
    256, trains on a fake 2 x 16 x 16 group (a strided shard of a weight
    gradient's product rows failed it before the products were laid out
    as their weights, ``common.matmul``).
  * The recurrent loops traced one step and counted for all
    (``dryrun._loops_counted``: the sLSTM's time steps, the mLSTM's
    chunks) give a REDUCED xlstm-1.3b prefill's whole trace, number for
    number.
  * The expert-parallel MoE layer: on the (2, 2) and (2, 2, 2) fake
    meshes no collective inside a REDUCED deepseek-moe-16b MoE unit
    returns more than the tokens' bytes, where the whole-slot path
    (planted) gathers every expert's slots.
  * The dense cells' guards, under the production condition of gemma2-2b
    (its KV heads do not split over "model", nor a cache's stacked dim
    over "data"; REDUCED with one KV head) on the (2, 2) and (2, 2, 2)
    fake meshes, each beside a planted fault that fails it: decode
    attends where the cache lies (no collective inside an attention unit
    returns more than its q and output bytes); the filled cache moves by
    ``sharding.relayout`` (no collective inside ``shard_cache`` returns
    more than the device's share); xlstm-1.3b's mLSTM prefill at S = 512
    splits over the sequence (no collective inside an mLSTM unit returns
    a whole [B_local, S, H, hd]); ``common.on_rows`` moves each argument
    once.
  * The sharded prefill's guards on a fake 2 x 4 mesh, each beside a
    planted fault that fails it: the caches are made as shards (the
    largest tensor made while ``sharding.empty_cache`` runs is a device's
    share); the flash prefill splits over "model" where the heads do not
    (rank 0's and the last rank's flash FLOPs within 1.1x of a device's
    share, over the sequence and by the query heads); qwen3-32b's qk-norm
    reduces no whole float32 q; xlstm-1.3b's mLSTM prefix exchanges one
    state at a time and its sLSTM reduces no float32 gate inputs.
  * The committed reference: every cell OK, its FLOPs within
    ``DRYRUN_FLOPS_LIMIT`` of the JAX package's, the MoE cells too, and
    their FLOPs within ``DRYRUN_MOE_RECKONING_LIMIT`` of the model's own
    count a device; a prefill cell's flash FLOPs on rank 0 and on the last
    rank within ``DRYRUN_FLASH_LIMIT`` of the model's attention count a
    device; every cell's peak under the card's memory less
    ``SHARD_RANK_MARGIN``; each cell's collective bytes over the JAX
    package's (``coll_ratio``) within ``DRYRUN_COLL_LIMIT``.

The prefill_32k cell of each architecture on the 16 x 16 mesh (peak,
collectives over the JAX package's, flash FLOPs over the model's count on
rank 0 and the last rank), into ``DIR`` (the JAX records made once):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_dryrun.py --prefill-survey DIR

Run as a script, it writes ``src/repro_torch/launch/dryrun_reference.json``
(chip_smoke.py phase 22's cells, ``chip_smoke.DRYRUN_CELLS``, through the
JAX package's ``run_cell`` on 512 forced host devices, and through the
port's dry run on the CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_dryrun.py --write-dryrun-reference
"""
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_collectives import ROOT, SRC  # noqa: E402  (puts the root on sys.path)
import chip_smoke  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.dist import sharding as jshard  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeCell  # noqa: E402
from repro_torch.dist import collectives as coll, sharding  # noqa: E402
from repro_torch.launch import dryrun, mesh as tmesh  # noqa: E402

REFERENCE = pathlib.Path(SRC) / "repro_torch" / "launch" / "dryrun_reference.json"
MESHES = {"single_pod_16x16": False, "multi_pod_2x16x16": True}
# REDUCED cells traced on small fake meshes: (arch, kind, grad sync)
SMALL_CELLS = (("gemma2-2b", "train", "xla"), ("gemma2-2b", "prefill", "xla"),
               ("gemma2-2b", "decode", "xla"), ("deepseek-moe-16b", "train", "xla"))
SMALL_SHAPES = {"train": ShapeCell("train_small", 16, 8, "train"),
                "prefill": ShapeCell("prefill_small", 32, 8, "prefill"),
                "decode": ShapeCell("decode_small", 32, 8, "decode")}
SMALL_MESHES = ((2, 2), (2, 2, 2))


def abstract(shape):
    axes = tmesh.AXES[-len(shape):]
    return jax.sharding.AbstractMesh(tuple(shape), axes)


def local_bytes(leaf, spec, sizes: dict) -> int:
    if isinstance(leaf, int):  # a leaf left out
        return 0
    n = math.prod(leaf.shape)
    for entry in tuple(spec):
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            n //= sizes[a]
    return n * np.dtype(leaf.dtype).itemsize


def tree_bytes(tree, specs, sizes) -> int:
    P = jax.sharding.PartitionSpec
    leaves = jax.tree.leaves(tree)
    sleaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(sleaves)
    return sum(local_bytes(x, s, sizes) for x, s in zip(leaves, sleaves))


def jax_count(arch: str, shape, mesh_shape) -> int:
    """One device's argument bytes of the JAX package's program for a cell,
    from its own trees and specs: what ``run_cell``'s ``in_shardings``
    give each device."""
    cfg = jreg.get_config(arch)
    mesh = abstract(mesh_shape)
    sizes = dict(mesh.shape)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    params = jax.eval_shape(lambda k: jmodel.init_params(k, cfg), key)
    pspecs = jshard.param_specs(params, mesh)
    if shape.kind != "train" and not cfg.qk_norm:  # never read: jit leaves them out
        params, pspecs = (jax.tree_util.tree_map_with_path(
            lambda path, x: 0 if jckpt._leaf_id(path).endswith((".q_norm", ".k_norm")) else x,
            t, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            for t in (params, pspecs))
    total = tree_bytes(params, pspecs, sizes)
    if shape.kind == "train":
        total += 2 * total + 4  # the moments mirror the params; the step count
    batch = jreg.input_specs(cfg, shape)
    if shape.kind == "decode":
        batch = {"tokens": jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)}
        cache = jax.eval_shape(lambda: jmodel.init_cache(None, cfg, shape.global_batch,
                                                         shape.seq_len))
        total += tree_bytes(cache, jshard.cache_specs(cache, mesh), sizes)
    return total + tree_bytes(batch, jshard.batch_specs(batch, mesh), sizes)


def drop_bytes(cfg, shape, mesh) -> int:
    """The parameter bytes one device holds in the port beyond the JAX
    program's: each leaf of ``stacked_drops``, a superblock's tensor whole
    over the axis the rule put on the stacked dim, and in serving the
    qk-norm scales no step reads (jit leaves them out)."""
    sizes = dict(mesh.shape)
    specs, shapes = sharding.param_specs(cfg, mesh), sharding.param_shapes(cfg)
    dropped = sharding.stacked_drops(specs)
    unread = shape.kind != "train" and not cfg.qk_norm
    extra = 0
    for name, full in shapes.items():
        left_out = unread and name.endswith((".q_norm", ".k_norm"))
        if name not in dropped and not left_out:
            continue
        spec = specs[name]
        if name.startswith(sharding.STACKED):
            port = full[0] * dryrun._local(full[1:], sharding.port_spec(name, spec), sizes)
        else:
            port = dryrun._local(full, spec, sizes)
        extra += 4 * (port - (0 if left_out else dryrun._local(full, spec, sizes)))
    return extra * (3 if shape.kind == "train" else 1)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_argument_bytes_from_specs_equal_the_jax_programs_up_to_the_listed_leaves(arch,
                                                                                  mesh_name):
    multi = MESHES[mesh_name]
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    cfg = treg.get_config(arch)
    for shape in SHAPES:
        if not treg.cell_is_supported(arch, shape)[0]:
            continue
        want = jax_count(arch, shape, mesh.sizes)
        jax_layout = dryrun.expected_argument_bytes(cfg, shape, mesh, "jax")
        port = dryrun.expected_argument_bytes(cfg, shape, mesh)
        assert jax_layout == want, (shape.name, jax_layout, want)
        extra = drop_bytes(cfg, shape, mesh)
        if shape.kind != "decode":
            assert port - want == extra, (shape.name, port, want, extra)
        else:  # the cache's layout too: a pod's rows, each superblock whole
            cache = (dryrun._cache_bytes(cfg, shape, mesh, "port")
                     - dryrun._cache_bytes(cfg, shape, mesh, "jax"))
            assert port - want == extra + cache, (shape.name, port, want, extra, cache)


# ------------------------------------------------------ traced small cells
def small_cfg(arch: str, mod):
    return mod.get_config(arch, reduced=True).replace(remat="dots")


def port_small_records(mesh_shape) -> dict:
    """The port's traced records of SMALL_CELLS on a fake mesh."""
    mesh = tmesh.fake_mesh(mesh_shape)
    out = {}
    for arch, kind, grad_sync in SMALL_CELLS:
        cfg, shape = small_cfg(arch, treg), SMALL_SHAPES[kind]
        rec = dryrun.trace_cell(cfg, shape, mesh, grad_sync, "cpu")
        rec["expected"] = dryrun.expected_argument_bytes(cfg, shape, mesh)
        rec["expected_jax"] = dryrun.expected_argument_bytes(cfg, shape, mesh, "jax")
        out[f"{arch}/{kind}"] = rec
    return out


JAX_SMALL = textwrap.dedent("""
    import json, sys
    import jax
    jax.devices()  # the forced device count is read before dryrun's import sets its own
    sys.path.insert(0, sys.argv[1])
    import test_torch_dryrun as t
    from repro.configs import registry
    from repro.launch import dryrun, mesh

    shapes = {s.name: s for s in t.SMALL_SHAPES.values()}
    get_config, get_shape = registry.get_config, registry.get_shape
    dryrun.extrapolated_costs = lambda *a: {}  # flops_x and the like are not compared
    registry.get_config = lambda arch, reduced=False: get_config(arch, reduced=True)
    registry.get_shape = lambda name: shapes[name]
    out = {}
    for mesh_shape in t.SMALL_MESHES:
        m = mesh.make_mesh_like(mesh_shape)
        for arch, kind, grad_sync in t.SMALL_CELLS:
            try:
                rec = dryrun.run_cell(arch, t.SMALL_SHAPES[kind].name, m, str(mesh_shape),
                                      grad_sync)
            except Exception as e:
                rec = {"status": "FAIL", "error": f"{type(e).__name__}: {e}"[:500]}
            out[f"{mesh_shape}/{arch}/{kind}"] = rec
    print(json.dumps(out))
""")


@pytest.fixture(scope="module", autouse=True)
def jax_small_proc():
    """The JAX subprocess, started as the module's first test does, so that
    it runs beside the tests before the one that reads it."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([SRC, str(ROOT / "tests")]), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SMALL, str(ROOT / "tests")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_small(jax_small_proc):
    out, err = jax_small_proc.communicate(timeout=600)
    assert jax_small_proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_shape", SMALL_MESHES, ids=str)
def test_traced_records_match_the_jax_run_cell(jax_small, mesh_shape):
    """Each traced record's argument bytes equal the count from specs; the
    JAX package's equal its layout's count (so the two differ by the
    listed leaves alone); FLOPs within DRYRUN_FLOPS_LIMIT of the JAX
    package's."""
    try:
        port = port_small_records(mesh_shape)
    finally:
        torch.distributed.destroy_process_group()
    limit = chip_smoke.DRYRUN_FLOPS_LIMIT
    for key, rec in port.items():
        want = jax_small[f"{mesh_shape}/{key}"]
        print(mesh_shape, key, {k: rec[k] for k in ("flops", "argument_size_bytes",
                                                     "peak_bytes", "trace_s")},
              {k: want.get(k) for k in ("status", "flops", "argument_size_bytes")})
        assert rec["argument_size_bytes"] == rec["expected"], key
        assert rec["flops"] > 0, key
        assert want["status"] == "OK", want
        assert want["argument_size_bytes"] == rec["expected_jax"], (key, want, rec)
        ratio = (rec["flops"] - rec["flash_flops"]) / want["flops"]
        assert 1 / limit <= ratio <= limit, (key, ratio)


# ------------------------------------------------------- counters and faults
def small_trace(arch="gemma2-2b", kind="train", grad_sync="xla", mesh_shape=(2, 2)):
    mesh = tmesh.fake_mesh(mesh_shape)
    try:
        cfg, shape = small_cfg(arch, treg), SMALL_SHAPES[kind]
        return dryrun.trace_cell(cfg, shape, mesh, grad_sync, "cpu"), cfg, shape, mesh
    finally:
        torch.distributed.destroy_process_group()


def test_collective_counter_equals_comm_debug_mode():
    """The Counter's collectives, counted beside CommDebugMode on one traced
    step: the same count of each kind."""
    from torch.distributed.tensor.debug import CommDebugMode

    modes, enter, leave = [], dryrun.Counter.__enter__, dryrun.Counter.__exit__

    def entered(self):
        modes.append(CommDebugMode())
        modes[-1].__enter__()
        return enter(self)

    def left(self, *exc):
        out = leave(self, *exc)
        modes[-1].__exit__(*exc)
        return out

    dryrun.Counter.__enter__, dryrun.Counter.__exit__ = entered, left
    try:
        rec, *_ = small_trace()
    finally:
        dryrun.Counter.__enter__, dryrun.Counter.__exit__ = enter, leave
    counts = {k: 0 for k in dryrun.COLLECTIVE_OPS}
    for op, n in modes[-1].get_comm_counts().items():
        counts[dryrun._COLLECTIVE_KIND[str(op).split(".")[-1]]] += n
    print(counts, rec["collective_counts"])
    assert counts == rec["collective_counts"] and sum(counts.values()) > 0


def test_planted_replicated_spec_raises_the_argument_bytes():
    """One leaf's spec replicated: the traced record holds more than the count
    from the rule's specs."""
    clean, cfg, shape, mesh = small_trace()
    assert clean["argument_size_bytes"] == dryrun.expected_argument_bytes(cfg, shape, mesh)
    orig = sharding.param_specs

    def one_replicated(cfg, mesh):
        specs = orig(cfg, mesh)
        return dict(specs, embed=sharding.Spec())

    sharding.param_specs = one_replicated
    try:
        planted, *_ = small_trace()
    finally:
        sharding.param_specs = orig
    print(clean["argument_size_bytes"], planted["argument_size_bytes"])
    assert planted["argument_size_bytes"] > clean["argument_size_bytes"]


def test_planted_ring_without_its_counter_records_no_permutes():
    """The grad sync's ring on a (2, 2, 2) mesh records collective-permute
    bytes (2 (n - 1) rounds a chunk a leaf); with the ring's counter
    removed it records none."""
    clean, cfg, *_ = small_trace(grad_sync="seqbalance", mesh_shape=(2, 2, 2))
    leaves = len(sharding.param_shapes(cfg))
    assert clean["collectives"]["collective-permute"] > 0
    assert clean["collectives"]["count"] >= leaves * 4 * 2 * (2 - 1)
    orig = coll._permute

    def uncounted(payload, axis, d):
        return axis.permute(payload, d)

    coll._permute = uncounted
    try:
        planted, *_ = small_trace(grad_sync="seqbalance", mesh_shape=(2, 2, 2))
    finally:
        coll._permute = orig
    assert planted["collectives"]["collective-permute"] == 0


def test_recurrentgemma_trains_on_the_pod_mesh():
    """recurrentgemma-9b at its widths (one superblock: two RG-LRU units and
    an attention unit), B 64 x S 256, on a fake 2 x 16 x 16 group: the step
    traces (DTensor once split a weight gradient's product rows into a
    strided shard, whose redistribution it cannot plan on fake tensors),
    its argument bytes the count from specs."""
    cfg = treg.get_config("recurrentgemma-9b").replace(remat="dots", n_layers=3)
    shape = ShapeCell("train_small", 256, 64, "train")
    mesh = tmesh.fake_production_mesh(multi_pod=True)
    try:
        rec = dryrun.trace_cell(cfg, shape, mesh, "xla", "cpu")
    finally:
        torch.distributed.destroy_process_group()
    print({k: rec[k] for k in ("flops", "argument_size_bytes", "peak_bytes", "trace_s")})
    assert rec["argument_size_bytes"] == dryrun.expected_argument_bytes(cfg, shape, mesh)
    assert rec["flops"] > 0


# an H100's 80 GB less chip_smoke.SHARD_RANK_MARGIN, the room phase 23
# needs to run a rank (phase 22 gates at the card's own count)
FITS_A_CARD = 80e9 - chip_smoke.SHARD_RANK_MARGIN
GUARD_DEPTHS = (5, 8)  # one and two superblocks, each with the trailing pair


def recurrentgemma_peaks(plant=None) -> dict:
    """recurrentgemma-9b train_4k at its widths on a fake 16 x 16 group
    (rank 0), cut to each depth of GUARD_DEPTHS: n_layers -> peak bytes a
    device; ``plant``: (module, name, value) set for the traces."""
    held = plant and getattr(plant[0], plant[1])
    if plant:
        setattr(plant[0], plant[1], plant[2])
    out = {}
    try:
        for n in GUARD_DEPTHS:
            cfg = treg.get_config("recurrentgemma-9b").replace(remat="dots", n_layers=n)
            mesh = tmesh.fake_production_mesh(multi_pod=False)
            try:
                out[n] = dryrun.trace_cell(cfg, treg.get_shape("train_4k"), mesh, "xla",
                                           "cpu")["peak_bytes"]
            finally:
                torch.distributed.destroy_process_group()
    finally:
        if plant:
            setattr(plant[0], plant[1], held)
    return out


def whole_depth_peak(peaks: dict) -> float:
    """The peak of the published 38 layers (12 superblocks) from the cut
    depths: the peak falls in the first superblock's backward, where every
    superblock's saved state is held, so each superblock adds what it
    keeps under "dots", the difference between the depths."""
    from repro_torch.models import transformer

    n_super = transformer.block_program(treg.get_config("recurrentgemma-9b"))[2]
    (a, pa), (b, pb) = sorted(peaks.items())
    per_superblock = (pb - pa) / ((b - a) // 3)
    return pa + (n_super - 1) * per_superblock


def test_recurrentgemma_train_fits_a_card():
    """recurrentgemma-9b train_4k at its widths at 16 x 16, cut to 5 and 8
    layers (a few seconds each on fake tensors): the published depth's
    peak a device, extrapolated superblock by superblock
    (``whole_depth_peak``), within FITS_A_CARD; the RG-LRU run through
    ``common.on_rows`` at the whole R (planted: ``_channel_split`` finding
    no split, the path before the channel split) is not."""
    from repro_torch.models import recurrent

    clean = recurrentgemma_peaks()
    planted = recurrentgemma_peaks((recurrent, "_channel_split", lambda t, R: None))
    print({"clean": clean, "whole": whole_depth_peak(clean), "planted": planted,
           "planted_whole": whole_depth_peak(planted), "bound": FITS_A_CARD})
    assert whole_depth_peak(clean) < FITS_A_CARD < whole_depth_peak(planted)


def test_peak_sites_sum_to_the_peak():
    """``trace_cell(peak_sites=True)`` on REDUCED gemma2-2b's train cell and
    xlstm-1.3b's prefill (its loops counted from one step) on a fake (2,
    2) group: the live bytes at the peak by the line that made them sum to
    ``peak_bytes``, the arguments among them, and the other counts are
    those of a trace without sites."""
    cells = (("gemma2-2b", SMALL_SHAPES["train"]),
             ("xlstm-1.3b", ShapeCell("prefill_small", 512, 4, "prefill")))
    for arch, shape in cells:
        cfg, recs = small_cfg(arch, treg), {}
        for sites in (False, True):
            mesh = tmesh.fake_mesh((2, 2))
            try:
                recs[sites] = dryrun.trace_cell(cfg, shape, mesh, "xla", "cpu",
                                                peak_sites=sites)
            finally:
                torch.distributed.destroy_process_group()
        rec = recs[True]
        where = rec.pop("peak_sites")
        print(arch, rec["peak_bytes"], list(where.items())[:4])
        assert sum(where.values()) == rec["peak_bytes"]
        assert where["arguments"] == rec["argument_size_bytes"]
        assert ({k: v for k, v in rec.items() if k != "trace_s"}
                == {k: v for k, v in recs[False].items() if k != "trace_s"})


def test_loop_count_equals_the_whole_trace():
    """REDUCED xlstm-1.3b prefill, B 4 x S 512 (two mLSTM chunks) on a fake
    (2, 2) group: the record with the sLSTM's and the mLSTM's loops each
    counted from one step equals, number for number, the record with
    every step traced."""
    cfg, shape = small_cfg("xlstm-1.3b", treg), ShapeCell("prefill_small", 512, 4, "prefill")
    recs = {}
    for loop_count in (False, True):
        mesh = tmesh.fake_mesh((2, 2))
        try:
            recs[loop_count] = dryrun.trace_cell(cfg, shape, mesh, "xla", "cpu", loop_count)
        finally:
            torch.distributed.destroy_process_group()
    whole, counted = ({k: v for k, v in r.items() if k != "trace_s"} for r in recs.values())
    print(recs[False]["trace_s"], recs[True]["trace_s"], whole["flops"], whole["peak_bytes"])
    assert counted == whole
    assert whole["flops"] > 0 and whole["bytes_accessed"] > 0


class _Enter(torch.autograd.Function):
    """The identity on an MoE unit's output; its gradient enters the unit's
    backward."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        INSIDE["inside"] += 1
        return g


class _Leave(torch.autograd.Function):
    """The identity on an MoE unit's input; its gradient leaves the unit's
    backward."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        INSIDE["inside"] -= 1
        return g


INSIDE = {"inside": 0, "largest": 0, "made": 0}


class ScopeCounter(dryrun.Counter):
    """The dry run's counter, which also keeps the largest result of a
    collective made while the code a test watches runs (an MoE unit's
    forward or backward, an attention unit's decode, the cache's move, an
    mLSTM unit): ``INSIDE["inside"]`` is set there; and the bytes of the
    largest tensor made there (``INSIDE["made"]``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = sum(self.collectives[k] for k in dryrun.COLLECTIVE_OPS)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if INSIDE["inside"] and out is not NotImplemented:
            grown = sum(self.collectives[k] for k in dryrun.COLLECTIVE_OPS) - before
            INSIDE["largest"] = max(INSIDE["largest"], grown)
            made = [t.nbytes for t in dryrun._tensors(out) if t.device.type != "meta"]
            INSIDE["made"] = max([INSIDE.get("made", 0)] + made)
        return out


def whole_slot_apply(p, x, cfg, with_aux=True, routes=None, experts=None):
    """Planted: the sharded MoE unit as it was before the expert-parallel
    layer, for its collectives: the router logits and the tokens gathered
    whole on every device (and over the pods), the routing and the
    dispatch into every expert's slots [E, C, D] run whole, the products
    over the experts split over "data", and the slots' outputs gathered
    whole again for the combine."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import common, moe

    mesh, (B, S, D) = x.device_mesh, x.shape
    whole = [Replicate()] * mesh.ndim
    flat = common.rms_norm(x, p.ln).reshape(-1, D)
    logits = (flat.to(torch.float32) @ p.router.to(torch.float32)).redistribute(mesh, whole)
    logits, tokens = logits.to_local(), flat.redistribute(mesh, whole).to_local()
    pods = moe._pods()
    if pods is not None:
        logits, tokens = (moe._Gathered.apply(t, (pods,)) for t in (logits, tokens))
    r = moe._route_logits(logits, cfg)
    xe, w_of_slot = moe._dispatch(r, tokens)
    we = p.we_i, p.we_g, p.we_o
    if pods is not None:
        n = xe.shape[0] // pods[1]
        xe = xe[pods[2] * n:(pods[2] + 1) * n]
        we = tuple(w.narrow(0, pods[2] * n, n) for w in we)
    xe = DTensor.from_local(xe, mesh, whole, run_check=False).redistribute(
        mesh, [Replicate() if name == "model" else Shard(0) for name in mesh.mesh_dim_names])
    ye = common.matmul(F.silu(common.matmul(xe, we[1])) * common.matmul(xe, we[0]), we[2])
    ye = ye.redistribute(mesh, whole).to_local().reshape(-1, D)
    if pods is not None:
        ye = moe._Gathered.apply(ye, (pods,))
    out = moe._combine(ye * w_of_slot[:r.sentinel, None].to(ye.dtype), r)
    if pods is not None:
        out = out.chunk(pods[1])[pods[2]]
    out = DTensor.from_local(out, mesh, whole, run_check=False)
    aux = {k: DTensor.from_local(v, mesh, whole, run_check=False)
           for k, v in moe._aux(r, cfg.moe, cfg.moe.n_experts).items()} if with_aux else {}
    return x + out.view(B, S, D), aux


def moe_unit_largest(mesh_shape, apply=None) -> tuple[int, int]:
    """(the largest result of a collective inside an MoE unit's forward or
    backward, on a device; the tokens' bytes T x D x itemsize) of the
    REDUCED deepseek-moe-16b train cell on a fake mesh, traced with remat
    "none" (a recomputed superblock would run its attention's collectives
    inside the MoE unit's backward); ``apply`` in place of the sharded
    ``moe.apply`` (a planted fault)."""
    from repro_torch.models import moe

    cfg, shape = small_cfg("deepseek-moe-16b", treg).replace(remat="none"), SMALL_SHAPES["train"]
    orig, counter = moe.apply, dryrun.Counter
    inner = apply or orig

    def tagged(p, x, cfg, *args, **kw):
        x = _Leave.apply(x)
        INSIDE["inside"] += 1
        try:
            out, aux = inner(p, x, cfg, *args, **kw)
        finally:
            INSIDE["inside"] -= 1
        return _Enter.apply(out), aux

    INSIDE.update(inside=0, largest=0)
    moe.apply, dryrun.Counter = tagged, ScopeCounter
    mesh = tmesh.fake_mesh(mesh_shape)
    try:
        dryrun.trace_cell(cfg, shape, mesh, "xla", "cpu")
    finally:
        moe.apply, dryrun.Counter = orig, counter
        torch.distributed.destroy_process_group()
    assert INSIDE["inside"] == 0, INSIDE
    tokens = shape.global_batch * shape.seq_len * cfg.d_model * getattr(torch, cfg.dtype).itemsize
    return INSIDE["largest"], tokens


@pytest.mark.parametrize("mesh_shape", SMALL_MESHES, ids=str)
def test_no_moe_collective_returns_more_than_the_tokens(mesh_shape):
    """REDUCED deepseek-moe-16b train on the fake (2, 2) and (2, 2, 2)
    meshes: no collective inside an MoE unit (its forward and backward)
    returns more than the tokens' bytes on a device (at these widths an
    expert weight's FSDP gather, E x D / 2 x Fe bfloat16, equals them),
    where the whole-slot path (``whole_slot_apply``, planted) gathers every
    expert's slots."""
    largest, tokens = moe_unit_largest(mesh_shape)
    planted, _ = moe_unit_largest(mesh_shape, whole_slot_apply)
    print(mesh_shape, {"largest": largest, "tokens": tokens, "planted": planted})
    assert 0 < largest <= tokens < planted


# ------------------------------------------------- the dense cells' guards
GUARD_SHAPES = {"decode": ShapeCell("decode_guard", 32, 64, "decode"),
                "prefill": ShapeCell("prefill_guard", 32, 8, "prefill"),
                "xlstm": ShapeCell("prefill_guard", 512, 4, "prefill")}


def kv1_cfg():
    """REDUCED gemma2-2b with one KV head: as gemma2-2b's 4 on 16, its KV
    heads do not split over "model" on the small meshes."""
    return small_cfg("gemma2-2b", treg).replace(n_kv_heads=1)


def production_condition(cfg, mesh_shape) -> None:
    """The condition of gemma2-2b's cells at 16 x 16: the KV heads do not
    split over "model", and the stacked leading dim [n_super] of a cache
    leaf does not split over the data-parallel dims, so ``cache_specs``
    puts "model" on the cache's batch."""
    from repro_torch.models import transformer

    sizes = dict(zip(tmesh.AXES[-len(mesh_shape):], mesh_shape))
    n_super = transformer.block_program(cfg)[2]
    assert cfg.n_kv_heads % sizes["model"], cfg.n_kv_heads
    assert n_super % (sizes["data"] * sizes.get("pod", 1)), n_super


def largest_inside(where, name: str, cfg, shape, mesh_shape, rank: int = 0,
                   plant=None) -> dict:
    """The largest result of a collective on device ``rank`` while the
    function ``where.name`` (``where[name]`` of a dict) runs in a traced
    step of ``cfg`` at ``shape`` on a fake mesh (``INSIDE["largest"]``),
    and the largest local tensor that its last call returned
    (``INSIDE["out"]``); ``plant``: (module, name, value) set for the trace
    (a planted fault)."""
    table = where if isinstance(where, dict) else vars(where)
    orig, counter = table[name], dryrun.Counter
    planted = plant and getattr(plant[0], plant[1])

    def tagged(*args, **kw):
        INSIDE["inside"] += 1
        try:
            out = orig(*args, **kw)
        finally:
            INSIDE["inside"] -= 1
        INSIDE["out"] = max((t.to_local().nbytes for t in dryrun._tensors(out)
                             if hasattr(t, "to_local")), default=0)
        return out

    INSIDE.update(inside=0, largest=0, out=0, made=0)
    if rank:
        forget_meshes()
    table[name] = tagged
    if plant:
        setattr(plant[0], plant[1], plant[2])
    dryrun.Counter = ScopeCounter
    mesh = tmesh.fake_mesh(mesh_shape, rank)
    try:
        dryrun.trace_cell(cfg, shape, mesh, "xla", "cpu")
    finally:
        table[name] = orig
        if plant:
            setattr(plant[0], plant[1], planted)
        dryrun.Counter = counter
        torch.distributed.destroy_process_group()
        if rank:
            forget_meshes()
    return dict(INSIDE)


forget_meshes = dryrun.forget_meshes  # between the traces of two ranks in one process


@pytest.mark.parametrize("mesh_shape", SMALL_MESHES, ids=str)
def test_decode_attends_where_the_cache_lies(mesh_shape):
    """A decode step of REDUCED gemma2-2b with one KV head (B 64, a cache of
    32 positions) under the production condition: no collective inside an
    attention unit returns more than the unit's q [B, 1, H, hd] and output
    [B, 1, D] bytes, where the query-rows layout of ``_attend`` (planted:
    ``_cache_aligned`` finding no layout) gathers the cache whole over
    "model"."""
    from repro_torch.models import attention

    cfg, shape = kv1_cfg(), GUARD_SHAPES["decode"]
    production_condition(cfg, mesh_shape)
    item = getattr(torch, cfg.dtype).itemsize
    bound = shape.global_batch * (cfg.n_heads * cfg.hd + cfg.d_model) * item
    clean = largest_inside(attention, "apply_decode", cfg, shape, mesh_shape)
    planted = largest_inside(attention, "apply_decode", cfg, shape, mesh_shape,
                             plant=(attention, "_cache_aligned", lambda q, k, mask: None))
    print(mesh_shape, {"largest": clean["largest"], "bound": bound,
                       "planted": planted["largest"]})
    assert 0 < clean["largest"] <= bound < planted["largest"]


@pytest.mark.parametrize("mesh_shape", SMALL_MESHES, ids=str)
def test_the_filled_cache_moves_a_share_at_most(mesh_shape):
    """A prefill step of REDUCED gemma2-2b with one KV head under the
    production condition, seen from rank 1 (off the diagonal of the
    transposition, so that its block comes from another device): no
    collective inside ``shard_cache`` returns more than the device's
    largest cache leaf (its share: stricter than twice it, since on these
    meshes the whole batch is twice a share), where DTensor's own
    redistribution (planted in place of ``relayout``) gathers the whole
    batch."""
    cfg, shape = kv1_cfg(), GUARD_SHAPES["prefill"]
    production_condition(cfg, mesh_shape)

    def gathered(t, places):
        return t.redistribute(t.device_mesh, places)

    clean = largest_inside(sharding, "shard_cache", cfg, shape, mesh_shape, rank=1)
    planted = largest_inside(sharding, "shard_cache", cfg, shape, mesh_shape, rank=1,
                             plant=(sharding, "relayout", gathered))
    print(mesh_shape, {k: clean[k] for k in ("largest", "out")}, planted["largest"])
    assert 0 < clean["largest"] <= clean["out"] < planted["largest"]


@pytest.mark.parametrize("mesh_shape", SMALL_MESHES, ids=str)
def test_mlstm_prefill_gathers_no_whole_activation(mesh_shape):
    """A prefill of REDUCED xlstm-1.3b at S = 512, a whole number of
    256-token chunks on each "model" rank: no collective inside an mLSTM
    unit returns a whole [B_local, S, H, hd] in the compute dtype, where
    the rows path (planted: ``_sequence_split`` finding no split) makes q,
    k and v whole on every "model" rank."""
    from repro_torch.models import recurrent, transformer

    cfg, shape = small_cfg("xlstm-1.3b", treg), GUARD_SHAPES["xlstm"]
    sizes = dict(zip(tmesh.AXES[-len(mesh_shape):], mesh_shape))
    assert shape.seq_len // sizes["model"] % recurrent.MLSTM_CHUNK == 0
    P, H, hd = recurrent._mlstm_dims(cfg)
    rows = shape.global_batch // (sizes["data"] * sizes.get("pod", 1))
    whole = rows * shape.seq_len * H * hd * getattr(torch, cfg.dtype).itemsize
    clean = largest_inside(transformer._RECURRENT, "mlstm", cfg, shape, mesh_shape)
    planted = largest_inside(transformer._RECURRENT, "mlstm", cfg, shape, mesh_shape,
                             plant=(recurrent, "_sequence_split", lambda t, S: None))
    print(mesh_shape, {"largest": clean["largest"], "whole": whole,
                       "planted": planted["largest"]})
    assert 0 < clean["largest"] < whole <= planted["largest"]


def test_on_rows_moves_each_argument_once():
    """REDUCED xlstm-1.3b prefill at S = 16 (its mLSTM on the rows path, its
    sLSTM and the gates through ``common.on_rows``) on a fake (2, 2) mesh:
    each call of ``on_rows`` redistributes each argument once at most,
    where reading the rows' layout off a redistributed copy of the first
    (planted: ``batch_layout`` of it first) moves it twice."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import common

    cfg, shape = small_cfg("xlstm-1.3b", treg), SMALL_SHAPES["prefill"]
    calls, moves = [], [0]
    orig, move = common.on_rows, DTensor.redistribute

    def counted(t, *a, **kw):
        moves[0] += 1
        return move(t, *a, **kw)

    def watched(planted):
        def on_rows(fn, rows, whole):
            before = moves[0]
            if planted:
                common.batch_layout(next(t for t in rows if common.is_dtensor(t)))
            out = orig(fn, rows, whole)
            calls.append((moves[0] - before, len(rows) + len(whole)))
            return out
        return on_rows

    found = {}
    for planted in (False, True):
        calls.clear()
        common.on_rows, DTensor.redistribute = watched(planted), counted
        mesh = tmesh.fake_mesh((2, 2))
        try:
            dryrun.trace_cell(cfg, shape, mesh, "xla", "cpu")
        finally:
            common.on_rows, DTensor.redistribute = orig, move
            torch.distributed.destroy_process_group()
        found[planted] = list(calls)
    print(found)
    assert found[False] and all(n <= args for n, args in found[False])
    assert any(n > args for n, args in found[True])


# ------------------------------------------- the sharded prefill's guards
SPLIT_SHAPE = ShapeCell("prefill_guard", 64, 4, "prefill")
SPLIT_MESH = (2, 4)


MADE_AS_SHARDS = sharding.empty_cache


def whole_cache(cfg, mesh, batch, max_len, rows=False, device=None):
    """Planted: the cache as it was made before it was made as shards, the
    whole batch's ``model.init_cache`` on every device, each leaf then cut
    to the block that ``sharding.empty_cache`` makes."""
    from torch.distributed.tensor import distribute_tensor
    from torch.utils import _pytree as pytree

    from repro_torch.models import common, model

    class Where:
        pass

    where = Where()
    where.device = torch.device(device or "cpu")
    blocks = MADE_AS_SHARDS(cfg, mesh, batch, max_len, rows, device)

    def cut(whole, block):
        if not isinstance(whole, torch.Tensor):
            return whole
        return distribute_tensor(whole, block.device_mesh, block.placements,
                                 **common.no_source())
    return pytree.tree_map(cut, model.init_cache(where, cfg, batch, max_len), blocks)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_caches_are_made_as_shards(kind):
    """The prefill step's working cache and ``serving_cache`` (a decode
    cell's) of REDUCED gemma2-2b with one KV head on a fake 2 x 4 mesh:
    the largest tensor made while ``sharding.empty_cache`` runs is a
    device's share (its largest local leaf), where the whole
    ``init_cache``, planted, makes a leaf of the whole batch; the dry run
    records a decode cell's construction peak."""
    cfg, shape = kv1_cfg(), GUARD_SHAPES["prefill" if kind == "prefill" else "decode"]
    found, made = {}, sharding.empty_cache
    for planted in (False, True):
        sharding.empty_cache = whole_cache if planted else made
        try:
            found[planted] = largest_inside(sharding, "empty_cache", cfg, shape, SPLIT_MESH)
        finally:
            sharding.empty_cache = made
    print(kind, found)
    assert 0 < found[False]["made"] <= found[False]["out"] < found[True]["made"]
    if kind == "decode":
        rec, *_ = small_trace("gemma2-2b", "decode", mesh_shape=SPLIT_MESH)
        assert 0 < rec["cache_build_peak_bytes"] <= rec["argument_size_bytes"] <= rec["peak_bytes"]


def seq_cfg():
    """REDUCED gemma2-2b with three query heads on one KV head: none of them
    splits over "model", as gemma2-2b's 8 and 4 do not over 16."""
    return small_cfg("gemma2-2b", treg).replace(n_heads=3, n_kv_heads=1)


def flash_on_ranks(cfg, plant=None) -> dict:
    """A REDUCED prefill's flash FLOPs on rank 0 and on the last rank of the
    fake SPLIT_MESH, each over the model's own attention count a device."""
    from repro_torch.models import attention

    size = math.prod(SPLIT_MESH)
    whole = chip_smoke.attention_flops(cfg, SPLIT_SHAPE.global_batch, SPLIT_SHAPE.seq_len)
    orig = attention.flash_plan
    if plant:
        attention.flash_plan = plant
    out = {}
    try:
        for rank in (0, size - 1):
            forget_meshes()
            mesh = tmesh.fake_mesh(SPLIT_MESH, rank)
            try:
                rec = dryrun.trace_cell(cfg, SPLIT_SHAPE, mesh, "xla", "cpu")
            finally:
                torch.distributed.destroy_process_group()
            out[rank] = rec["flash_flops"] / (whole / size)
    finally:
        attention.flash_plan = orig
        forget_meshes()
    return out


@pytest.mark.parametrize("which", ["sequence", "kv_heads"])
def test_flash_prefill_splits_over_model_where_heads_do_not(which):
    """A REDUCED prefill (S 64) on a fake 2 x 4 mesh: with three query heads
    on one KV head (the queries split over the sequence, two mirrored
    blocks a "model" member, through gemma2-2b's windowed layers), and
    qwen3-32b's four on two (each member's query head against its one KV
    head), the flash FLOPs on rank 0 and on the last rank are each within
    1.1x of the model's own count a device, where the replicated layout
    (planted) runs the whole rows on every "model" member (4x)."""
    from repro_torch.models import attention

    cfg = seq_cfg() if which == "sequence" else small_cfg("qwen3-32b", treg)
    mesh = tmesh.fake_mesh(SPLIT_MESH)
    try:
        plan = attention.flash_plan(sharding.device_mesh(mesh), SPLIT_SHAPE.global_batch,
                                    SPLIT_SHAPE.seq_len, cfg.n_heads, cfg.n_kv_heads)
    finally:
        torch.distributed.destroy_process_group()
    assert plan == which
    clean = flash_on_ranks(cfg)
    planted = flash_on_ranks(cfg, plant=lambda *a: "replicated")
    print(which, clean, planted)
    assert all(1 / 1.1 <= v <= 1.1 for v in clean.values()), clean
    assert all(v > 1.1 for v in planted.values()), planted


def layout_after_norm(p, x, h, cfg, window, causal, plain=False):
    """Planted: the qk-norm and RoPE on q's and k's partial sums, then the
    flash layout (the port before the norm moved after the layout)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import attention, common

    S = h.shape[1]
    q, k, v = attention._qkv(p, h, torch.arange(S, device=h.device)[None, :], cfg)
    mesh, M = h.device_mesh, h.device_mesh.size(h.device_mesh.mesh_dim_names.index("model"))
    heads = Shard(2) if cfg.n_heads % M == 0 and cfg.n_kv_heads % M == 0 else Replicate()
    q, k, v = (attention._placed_for_flash(t, mesh, heads).contiguous() for t in (q, k, v))
    out = attention._self_attention(q, k, v, cfg, window, causal, plain)
    return attention._out(x, out, p.wo), k, v


def test_qk_norm_sends_no_whole_query():
    """A prefill of REDUCED qwen3-32b (its qk-norm) on a fake 2 x 4 mesh: no
    collective inside an attention unit returns a whole float32 q [B_local,
    S, H, hd]: q and k reach their layout before the norm, where norming
    their partial sums (planted) reduces them whole in float32."""
    from repro_torch.models import attention

    cfg, shape = small_cfg("qwen3-32b", treg), SPLIT_SHAPE
    assert cfg.qk_norm
    rows = shape.global_batch // SPLIT_MESH[0]
    whole = rows * shape.seq_len * cfg.n_heads * cfg.hd * 4
    clean = largest_inside(attention, "apply_prefill", cfg, shape, SPLIT_MESH)
    planted = largest_inside(attention, "apply_prefill", cfg, shape, SPLIT_MESH,
                             plant=(attention, "_sharded_self_attention", layout_after_norm))
    print({"largest": clean["largest"], "whole": whole, "planted": planted["largest"]})
    assert 0 < clean["largest"] < whole <= planted["largest"]


def gathered_prefix(run, M, r, group):
    """Planted: every member's run gathered to every member, then composed
    (the mLSTM prefill before its recursive-doubling scan)."""
    from repro_torch.models import recurrent

    c10d = torch.ops._c10d_functional
    flat = torch.cat([t.reshape(t.shape[0], -1) for t in run], dim=1)
    every = c10d.wait_tensor(c10d.all_gather_into_tensor(flat, M, group)).view(M, *flat.shape)
    runs = [tuple(a.view(t.shape) for a, t in zip(every[j].split([t[0].numel() for t in run],
                                                                  dim=1), run))
            for j in range(M)]
    prefix, total = None, runs[0]
    for j in range(1, M):
        if j == r:
            prefix = total
        total = recurrent.mlstm_compose(total, runs[j])
    return prefix, total


@pytest.mark.parametrize("mesh_shape", SMALL_MESHES, ids=str)
def test_mlstm_prefix_and_slstm_send_no_whole_state(mesh_shape):
    """A prefill of REDUCED xlstm-1.3b at S = 512 split over the sequence:
    no collective inside an mLSTM unit's ``mlstm_prefix`` returns more than
    one state (C, n, F) of the device's rows, where gathering every
    member's (planted) returns M of them; and no collective inside an sLSTM
    unit returns its whole float32 gate inputs [B_local, S, H, 4, hd],
    which the rows path (planted: ``_sequence_split`` finding no split)
    reduces whole."""
    from repro_torch.models import recurrent, transformer

    cfg, shape = small_cfg("xlstm-1.3b", treg), GUARD_SHAPES["xlstm"]
    sizes = dict(zip(tmesh.AXES[-len(mesh_shape):], mesh_shape))
    rows = shape.global_batch // (sizes["data"] * sizes.get("pod", 1))
    P, H, hd = recurrent._mlstm_dims(cfg)
    state = rows * (H * hd * hd + H * hd + H) * 4
    prefix = largest_inside(recurrent, "mlstm_prefix", cfg, shape, mesh_shape)
    scan, recurrent.mlstm_prefix = recurrent.mlstm_prefix, gathered_prefix
    try:
        planted = largest_inside(recurrent, "mlstm_prefix", cfg, shape, mesh_shape)
    finally:
        recurrent.mlstm_prefix = scan
    gates = rows * shape.seq_len * cfg.d_model * 4 * 4  # H * 4 * hd = 4 D, float32
    slstm = largest_inside(transformer._RECURRENT, "slstm", cfg, shape, mesh_shape)
    rows_path = largest_inside(transformer._RECURRENT, "slstm", cfg, shape, mesh_shape,
                               plant=(recurrent, "_sequence_split", lambda t, S: None))
    print(mesh_shape, {"prefix": prefix["largest"], "state": state,
                       "planted": planted["largest"], "slstm": slstm["largest"],
                       "gates": gates, "rows_path": rows_path["largest"]})
    assert 0 < prefix["largest"] <= state < planted["largest"]
    assert 0 < slstm["largest"] < gates <= rows_path["largest"]


def test_reference_holds_every_cell_within_the_limits():
    """dryrun_reference.json: phase 22's cells, each OK in both packages on
    both meshes, the port's argument bytes the count from specs, every
    cell's FLOPs ratio within DRYRUN_FLOPS_LIMIT (the MoE cells too), an
    MoE train cell within DRYRUN_MOE_RECKONING_LIMIT of the model's own
    count a device, a prefill cell's flash FLOPs on rank 0 and on the last
    rank within DRYRUN_FLASH_LIMIT of the model's attention count a
    device, every cell's peak under the card's memory less
    SHARD_RANK_MARGIN, and every cell's collective bytes over the JAX
    package's, recorded in ``coll_ratio``, within DRYRUN_COLL_LIMIT."""
    ref = json.loads(REFERENCE.read_text())
    assert [tuple(c) for c in ref["cells"]] == list(chip_smoke.DRYRUN_CELLS)
    limit = chip_smoke.DRYRUN_FLOPS_LIMIT
    assert ref["flops_limit"]["value"] == limit
    for label, multi in MESHES.items():
        for arch, shape in chip_smoke.DRYRUN_CELLS:
            key = f"{label}/{arch}/{shape}"
            port, want = ref["port_cpu"][key], ref["jax"][key]
            assert port["status"] == want["status"] == "OK", key
            assert port["argument_size_bytes"] == port["expected"], key
            assert want["argument_size_bytes"] == port["expected_jax"], key
            ratio = (port["flops"] - port["flash_flops"]) / want["flops"]
            assert ratio == ref["flops_ratio"][key], (key, ratio)
            cfg, cell = treg.get_config(arch), treg.get_shape(shape)
            if (arch, shape) in chip_smoke.DRYRUN_FLOPS_FROM_MODEL:
                model = chip_smoke.prefill_flops(cfg, cell.global_batch, cell.seq_len)
                over = (port["flops"] - port["flash_flops"]) / (model / port["n_devices"])
                held = chip_smoke.DRYRUN_PREFILL_RECKONING_LIMIT
                assert 1 / held <= over <= held, (key, over)
            else:
                assert 1 / limit <= ratio <= limit, (key, ratio)
            coll = port["coll_x"] / want["coll_x"]
            assert coll == ref["coll_ratio"][key], (key, coll)
            assert coll <= chip_smoke.DRYRUN_COLL_LIMIT, (key, coll)
            assert port["peak_bytes"] <= FITS_A_CARD, (key, port["peak_bytes"])
            if cell.kind == "train" and cfg.family == "moe":
                reckoned = chip_smoke.train_flops(cfg, cell.global_batch, cell.seq_len)
                over = port["flops"] / (reckoned / port["n_devices"])
                assert over <= chip_smoke.DRYRUN_MOE_RECKONING_LIMIT, (key, over)
            attn = chip_smoke.attention_flops(cfg, cell.global_batch, cell.seq_len)
            if cell.kind == "prefill" and attn:
                flash = chip_smoke.DRYRUN_FLASH_LIMIT
                for who in ("flash_flops", "last_rank_flash_flops"):
                    over = port[who] / (attn / port["n_devices"])
                    assert 1 / flash <= over <= flash, (key, who, over)


# ------------------------------------------------------ phase 22's reference
JAX_CELLS = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, sys.argv[1])
    from repro.launch import dryrun, mesh  # sets 512 forced host devices
    import chip_smoke

    out = {}
    for label, multi in (("single_pod_16x16", False), ("multi_pod_2x16x16", True)):
        m = mesh.make_production_mesh(multi_pod=multi)
        for arch, shape in chip_smoke.DRYRUN_CELLS:
            t0 = time.time()
            try:
                rec = dryrun.run_cell(arch, shape, m, label)
            except Exception as e:
                rec = {"arch": arch, "shape": shape, "mesh": label, "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}"[:1000]}
            rec["wall_s"] = time.time() - t0
            out[f"{label}/{arch}/{shape}"] = rec
            print(json.dumps({"done": f"{label}/{arch}/{shape}", "s": rec["wall_s"]}),
                  file=sys.stderr, flush=True)
    print(json.dumps(out))
""")


def write_reference() -> None:
    """Phase 22's reference: the JAX package's run_cell of DRYRUN_CELLS on
    both production meshes (512 forced host devices), the port's CPU
    records of the same cells, and the FLOPs limit from the dense cells."""
    import resource

    t0 = time.time()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, str(ROOT)]), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_CELLS, str(ROOT)], capture_output=True,
                         text=True, env=env, timeout=7200)
    assert out.returncode == 0, out.stderr[-3000:]
    jax_records = json.loads(out.stdout.strip().splitlines()[-1])
    jax_wall = time.time() - t0
    port = {}
    for label, multi in MESHES.items():
        for arch, shape in chip_smoke.DRYRUN_CELLS:
            rec = dryrun.run_cell(arch, shape, label, device="cpu")
            cfg, cell = treg.get_config(arch), treg.get_shape(shape)
            mesh = tmesh.make_production_mesh(multi_pod=multi)
            if cell.kind == "prefill":  # the flash FLOPs of the last rank too
                torch.distributed.destroy_process_group()
                forget_meshes()
                last_rank = tmesh.fake_production_mesh(multi_pod=multi, rank=mesh.size - 1)
                last = dryrun.run_cell(arch, shape, label, device="cpu", mesh=last_rank)
                torch.distributed.destroy_process_group()
                forget_meshes()
                rec["last_rank_flash_flops"] = last["flash_flops"]
            rec["expected"] = dryrun.expected_argument_bytes(cfg, cell, mesh)
            rec["expected_jax"] = dryrun.expected_argument_bytes(cfg, cell, mesh, "jax")
            port[f"{label}/{arch}/{shape}"] = rec
            print(json.dumps({"port": f"{label}/{arch}/{shape}", "trace_s": rec["trace_s"]}),
                  flush=True)
    ratios = {k: (port[k]["flops"] - port[k]["flash_flops"]) / r["flops"]
              for k, r in jax_records.items() if r.get("status") == "OK" and r.get("flops")}
    limit = chip_smoke.DRYRUN_FLOPS_LIMIT
    held = {k: v for k, v in ratios.items()
            if tuple(k.split("/")[1:]) not in chip_smoke.DRYRUN_FLOPS_FROM_MODEL}
    assert all(1 / limit <= v <= limit for v in held.values()), (ratios, limit)
    reckoned = {}
    for k, rec in port.items():
        label, arch, shape = k.split("/")
        cfg, cell = treg.get_config(arch), treg.get_shape(shape)
        if cell.kind == "train":
            reckoned[k] = rec["flops"] / (chip_smoke.train_flops(cfg, cell.global_batch,
                                                                 cell.seq_len) / rec["n_devices"])
    why = ("the port's FLOPs a device less the flash kernel's (XLA's count of the JAX "
           "package's Pallas call holds none) over the JAX package's lie within "
           f"{min(held.values()):.3g}-{max(held.values()):.3g} on these cells (those of "
           "chip_smoke.DRYRUN_FLOPS_FROM_MODEL apart, whose JAX count XLA takes from one "
           "layer: held against the model's own count, chip_smoke.prefill_flops); XLA's "
           "cost analysis reads low and unevenly (prefill_32k's count a device grows from "
           "256 devices to 512, train_4k's is a third of 6 N tokens a device); the limit, "
           f"{limit:g}, lies above them, and a product left unsharded moves a count by 16 "
           "or 256.  Every cell is held, the MoE ones too, since the products are laid out "
           "as their weights (common.matmul); the train cells' FLOPs over the model's own "
           "count a device (chip_smoke.train_flops): "
           + ", ".join(f"{k} {v:.3g}" for k, v in sorted(reckoned.items())))
    coll = {k: port[k]["coll_x"] / r["coll_x"]
            for k, r in jax_records.items() if r.get("status") == "OK" and r.get("coll_x")}
    ref = {"cells": [list(c) for c in chip_smoke.DRYRUN_CELLS], "jax": jax_records,
           "port_cpu": port, "flops_ratio": ratios, "flops_over_reckoning": reckoned,
           "flops_limit": {"value": limit, "why": why}, "coll_ratio": coll,
           "jax_wall_s": jax_wall, "wall_s": time.time() - t0,
           "max_rss_gb": max(resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss,
                             resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) / 1e6}
    REFERENCE.write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps({k: ref[k] for k in ("flops_ratio", "flops_over_reckoning", "coll_ratio",
                                           "jax_wall_s", "wall_s", "max_rss_gb")}, indent=1))


# ------------------------------------------------- the prefill cells' survey
JAX_SURVEY = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    from repro.configs import registry
    from repro.launch import dryrun, mesh  # sets 512 forced host devices

    m = mesh.make_production_mesh(multi_pod=False)
    out = {}
    for arch in registry.ARCHS:
        try:
            rec = dryrun.run_cell(arch, "prefill_32k", m, "single_pod_16x16")
        except Exception as e:
            rec = {"status": "FAIL", "error": f"{type(e).__name__}: {e}"[:1000]}
        out[arch] = {k: rec.get(k) for k in ("status", "coll_x", "flops", "peak_bytes")}
    print(json.dumps(out))
""")


def prefill_survey(out_dir: str) -> None:
    """The prefill_32k cell of each architecture on the 16 x 16 mesh, CPU:
    the port's peak a device, its collective bytes over the JAX package's
    (``coll_x``), and its flash FLOPs on rank 0 and on the last rank over
    the model's own attention count a device (``chip_smoke.attention_flops``
    over the devices).  The JAX package's records are kept in
    ``out_dir/jax_prefill_survey.json`` (made once); the port's are traced
    here, unless ``out_dir/port_prefill_survey.json`` holds them (a record
    of another tree: copy it there)."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    jpath, ppath = out / "jax_prefill_survey.json", out / "port_prefill_survey.json"
    if not jpath.exists():
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
        run = subprocess.run([sys.executable, "-c", JAX_SURVEY, SRC], capture_output=True,
                             text=True, env=env, timeout=7200)
        assert run.returncode == 0, run.stderr[-3000:]
        jpath.write_text(run.stdout.strip().splitlines()[-1] + "\n")
    jax_records = json.loads(jpath.read_text())
    if ppath.exists():
        port = json.loads(ppath.read_text())
    else:
        port = {}
        for arch in treg.ARCHS:
            recs = {}
            for rank in (0, 255):
                forget_meshes()
                mesh = tmesh.fake_production_mesh(rank=rank)
                recs[rank] = dryrun.run_cell(arch, "prefill_32k", "single_pod_16x16",
                                             device="cpu", mesh=mesh)
                torch.distributed.destroy_process_group()
            forget_meshes()
            port[arch] = {**recs[0], "last_rank_flash_flops": recs[255]["flash_flops"]}
        ppath.write_text(json.dumps(port, indent=1) + "\n")
    print("| arch | peak GB | coll / JAX | flash / reckoning, rank 0 | last rank |")
    for arch in treg.ARCHS:
        rec, want = port[arch], jax_records[arch]
        cfg, cell = treg.get_config(arch), treg.get_shape("prefill_32k")
        reckoned = chip_smoke.attention_flops(cfg, cell.global_batch, cell.seq_len) / 256
        last = rec.get("last_rank_flash_flops")

        def over(n):
            return "no attention" if not reckoned else f"{n / reckoned:.3g}"
        print(f"| {arch} | {rec['peak_bytes'] / 1e9:.2f} | "
              f"{rec['coll_x'] / want['coll_x']:.3g} | {over(rec['flash_flops'])} | "
              + ("not traced" if last is None else over(last)) + " |")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-dryrun-reference"]:
        write_reference()
    elif sys.argv[1:2] == ["--prefill-survey"]:
        prefill_survey(sys.argv[2])
    else:
        sys.exit(pytest.main([__file__, "-q"]))
