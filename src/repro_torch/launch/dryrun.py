"""Multi-pod dry run of the port, mirroring ``repro.launch.dryrun``: trace
every (arch x shape x mesh) cell's real step with the production FSDP + TP
sharding, allocating nothing, and record what one device would hold, run
and send.

For each live cell it traces the real step (``launch.steps``' train step
for train_4k, prefill step for prefill_32k, serve step for the decode
shapes) on state made DTensors by ``dist.sharding`` over the 16 x 16 mesh
AND the 2 x 16 x 16 mesh, with this process one rank of a "fake"
``torch.distributed`` group of 256 or 512 ranks (``launch.mesh.fake_group``:
its collectives return at once and move nothing) and every tensor a fake
tensor (``FakeTensorMode``: shapes, dtypes and devices, no memory; on
"cuda" where a card is present, so that nothing is allocated on it
either).  A dispatch mode (``Counter``) sees each operation on the local
shards and records, as the JAX package's record does:

  * ``flops``: ``torch.utils.flop_counter``'s count of each product on the
    local shards (``FlopCounterMode`` around DTensor code counts the global
    shapes), plus the flash kernel's products (``flash_flops`` apart: the
    pairs its mask keeps);
  * ``bytes_accessed``: the bytes of each operation's inputs and outputs on
    the local shards, views left out.  Nothing is fused, so this reads
    above XLA's count of a fused program;
  * ``argument_size_bytes``, ``output_size_bytes``, ``temp_size_bytes`` and
    ``peak_bytes``: the bytes of the live local tensors of one device (each
    storage once): the step's inputs, its outputs, the most held at once
    above the inputs, and that most (for a decode cell also while its
    cache is made, ``cache_build_peak_bytes`` the most the construction
    held: a prefill step makes its cache inside the step);
  * ``collectives`` by kind (all-gather, all-reduce, reduce-scatter,
    all-to-all, collective-permute), each its ``count`` and the bytes of
    its results on one device, as ``collective_bytes`` sums each HLO
    collective's result; the grad sync's ring is counted from
    ``dist.collectives.permute_rounds`` and its payloads
    (``permute_bytes``);
  * ``flops_x``, ``bytes_x`` and ``coll_x``: the same numbers.  The JAX
    package extrapolates them from depths 1 and 2 because XLA's cost
    analysis counts a scan body once; the port runs each superblock as
    its own code, so the direct counts are whole.

A serving step's recurrent loops (the sLSTM's time steps, the mLSTM's
chunks) are traced one step and counted for all (``_loops_counted``):
the same record, number for number, as tracing every step, which took
xlstm-1.3b's prefill_32k past an hour a mesh.  ``trace_s`` (the wall of
the traced step) takes the place of ``lower_s`` and ``compile_s``.  Results append to ``<out>/dryrun_<mesh>_<grad
sync>.json``; a cell already there as OK or SKIP is not traced again.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both [--grad-sync seqbalance]
  python -m repro_torch.launch.dryrun --arch xlstm-1.3b --shape prefill_32k --sites
    (each collective's bytes by the line of the port that made it)
  python -m repro_torch.launch.dryrun --arch recurrentgemma-9b --shape train_4k --peak-sites
    (the live bytes at the peak by the line of the port that made each storage)
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.dist import collectives, sharding
from repro_torch.launch import mesh as mesh_mod, steps
from repro_torch.models import model
from repro_torch.train import optimizer as opt_mod

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
)
MESHES = {"single_pod_16x16": False, "multi_pod_2x16x16": True}
DEFAULT_OUT = "dryrun_out"  # git-ignored

# the communication ops a step's local shards go through -> the JAX record's kind
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
}
# a collective's result is written into an argument: (op name -> the argument)
_RESULT_ARG = {"allgather_": 0, "_allgather_base_": 0, "reduce_scatter_": 0,
               "_reduce_scatter_base_": 0, "alltoall_base_": 0, "alltoall_": 0,
               "allreduce_": 0, "allreduce_coalesced_": 0}
_SKIPPED = ("wait_tensor", "send", "recv_", "recv_any_source_", "barrier", "broadcast_")


def _tensors(tree):
    """Every plain tensor of a pytree (lists, tuples, dicts, NamedTuples)."""
    from torch.utils import _pytree as pytree

    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def flash_pairs(Sq: int, Sk: int, q_offset: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the flash kernel's mask keeps for Sq query
    rows at positions ``q_offset`` on against Sk keys (the kernel skips the
    blocks it drops)."""
    if not causal:
        return Sq * Sk

    def upto(n):  # the pairs of query rows 0 .. n - 1
        w = window if window and window < n else n
        return w * (w + 1) // 2 + (n - w) * w

    return upto(q_offset + Sq) - upto(q_offset)


def _flash_flops(q, k, v, causal, window, softcap, q_offset=0) -> int:
    """The flash kernel's products: the scores and their product with v,
    2 * 2 * B * H * hd a (query, key) pair the mask keeps."""
    B, Sq, H, hd = q.shape
    return 4 * B * H * hd * flash_pairs(Sq, k.shape[1], q_offset, causal, window)


class Counter(TorchDispatchMode):
    """Counts the operations on local tensors while it is entered (inside a
    ``FakeTensorMode``): FLOPs, bytes accessed, collectives by kind and
    the live bytes of one device, each storage once (``track``).  An
    operation on DTensors is left to DTensor (its sharding propagation,
    which runs the operation on global shapes, is not counted), which
    then runs the local operations that this mode sees."""

    def __init__(self, sites: bool = False, peak_sites: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.flops = self.flash_flops = 0
        self.bytes_accessed = 0
        self.collectives = {k: 0 for k in COLLECTIVE_OPS}
        self.collectives["count"] = 0
        self.counts = {k: 0 for k in COLLECTIVE_OPS}  # by kind
        self.live = self.peak = 0
        self._sizes: dict = {}
        self._propagating = 0
        # (kind, the innermost frame of the port that made it) -> result bytes
        self.sites = {} if sites else None
        # the line of the port that made each live storage -> its bytes, now
        # and at the peak
        self.live_sites = {} if peak_sites else None
        self.peak_sites: dict = {}
        self._made_at: dict = {}

    def readings(self) -> dict:
        """The counts that grow with each operation (FLOPs, bytes accessed,
        collectives), for ``add``."""
        return {"flops": self.flops, "flash_flops": self.flash_flops,
                "bytes_accessed": self.bytes_accessed,
                "collectives": dict(self.collectives), "counts": dict(self.counts)}

    def add(self, since: dict, times: int) -> None:
        """The counts made since the readings ``since``, added ``times``
        more times (the steps of a loop counted once)."""
        now = self.readings()
        for k in ("flops", "flash_flops", "bytes_accessed"):
            setattr(self, k, getattr(self, k) + times * (now[k] - since[k]))
        for k in ("collectives", "counts"):
            d = getattr(self, k)
            for kind in d:
                d[kind] += times * (now[k][kind] - since[k][kind])

    # ------------------------------------------------------------ memory
    def track(self, t: torch.Tensor, site: str | None = None) -> int:
        """Count ``t``'s storage live until it is freed (once); returns its
        bytes if it was new, else 0.  With ``peak_sites`` the storage is
        keyed by ``site``, or by the line of the port that made it and the
        line that called it (``_site``)."""
        if t.device.type == "meta":  # shapes only (a cache's leaves): no memory on a device
            return 0
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return 0
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        if self.live_sites is not None:
            where = self._made_at[key] = site or _site(2)
            self.live_sites[where] = self.live_sites.get(where, 0) + n
        if self.live > self.peak:
            self.peak = self.live
            if self.live_sites is not None:
                self.peak_sites = dict(self.live_sites)
        weakref.finalize(st, self._free, key)
        return n

    def adjust(self, n: int) -> None:
        """``n`` bytes more live (fewer where negative) that no storage of
        the trace holds: the steps of a loop counted once
        (``_loops_counted``)."""
        self.live += n
        if self.live_sites is not None:
            self.live_sites[_COUNTED] = self.live_sites.get(_COUNTED, 0) + n

    def _free(self, key) -> None:
        n = self._sizes.pop(key, 0)
        self.live -= n
        if self.live_sites is not None and key in self._made_at:
            self.live_sites[self._made_at.pop(key)] -= n

    # ----------------------------------------------------------- dispatch
    def __enter__(self):
        from torch.distributed.tensor import _sharding_prop as sp

        orig = sp.ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def propagate(self, op_schema):
            counter._propagating += 1
            try:
                return orig(self, op_schema)
            finally:
                counter._propagating -= 1

        self._restore = (sp.ShardingPropagator, orig)
        sp.ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._restore
        cls._propagate_tensor_meta_non_cached = orig
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it, and this mode sees its local ops
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        name = func._schema.name.split("::")[-1]
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        kind = _COLLECTIVE_KIND.get(name)
        if kind is not None:
            res = outs if name not in _RESULT_ARG else _tensors(args[_RESULT_ARG[name]])
            self.collectives[kind] += sum(t.nbytes for t in res)
            self.collectives["count"] += 1
            self.counts[kind] += 1
            if self.sites is not None:
                key = (kind, _site())
                self.sites[key] = self.sites.get(key, 0) + sum(t.nbytes for t in res)
        if name in _SKIPPED or kind is not None:
            for t in outs:
                self.track(t)
            return out
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += self.flop_registry[packet](*args, **kwargs, out_val=out)
        elif name == "flash_attention":
            self.flash_flops += _flash_flops(*args)
            self.flops += _flash_flops(*args)
        in_storages = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs if t.untyped_storage()._cdata not in in_storages]
        if fresh:  # a view or an in-place op moves nothing of its own
            self.bytes_accessed += sum(t.nbytes for t in ins) + sum(t.nbytes for t in fresh)
        for t in outs:
            self.track(t)
        return out


_COUNTED = "the loop steps counted from one (dryrun._loops_counted)"


def _site(depth: int = 1) -> str:
    """"file:line function" of the innermost frame of the port (outside
    this module) on the stack, or "autograd" for a backward that DTensor
    runs from the engine; with ``depth`` > 1, that many frames of the port
    from the innermost out, joined by " <- "."""
    f, found = sys._getframe(1), []
    while f is not None and len(found) < depth:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith("dryrun.py"):
            found.append(f"{name.split('repro_torch/')[-1]}:{f.f_lineno} {f.f_code.co_name}")
        f = f.f_back
    return " <- ".join(found) or "autograd"


def _nbytes(t) -> int:
    """The bytes of a fresh contiguous tensor shaped as ``t``."""
    return t.numel() * t.element_size()


def _loops_counted(counter):
    """(``recurrent._slstm_scan``, ``recurrent._mlstm_scan``) for ``counter``:
    each loop's first step (an sLSTM time step, an mLSTM chunk) traced,
    its counts added for the other steps (each runs the same operations on
    tensors of the same shapes), and the outputs made as the loop makes
    them; the live bytes carry what the whole loop would hold at its last
    step and its stack (the earlier steps' outputs, and the state the last
    step starts from), so that the peak is the whole loop's.  Without
    autograd only (a training pass keeps each step's graph for its
    backward), and for more than one step."""
    from repro_torch.models import recurrent

    slstm, mlstm = recurrent._slstm_scan, recurrent._mlstm_scan

    def slstm_scan(gx, c, n, h, m, r, b=None):
        S = gx.shape[1]
        if S < 2 or torch.is_grad_enabled():
            return slstm(gx, c, n, h, m, r, b)
        held = _nbytes(h)  # each state tensor [B, H, hd]
        counter.adjust((S + 2) * held)  # h_0 .. h_{S-2}; c, n, m before the last step
        since = counter.readings()
        g = gx[:, 0] if b is None else gx[:, 0].to(torch.float32) + b
        state = recurrent._slstm_cell(recurrent.SLSTMCache(c=c, n=n, h=h, m=m), g, r)
        counter.add(since, S - 1)
        counter.adjust(-3 * held)  # the last step's predecessor state freed
        hs = torch.stack([state.h] * S, dim=1)
        counter.adjust(-(S - 1) * held)  # the list of hidden states freed on return
        return hs, state

    def mlstm_scan(q, k, v, i, logf, C0, n0, scale: float):
        S = q.shape[1]
        L = min(recurrent.MLSTM_CHUNK, S)
        K = S // L
        if K < 2 or torch.is_grad_enabled():
            return mlstm(q, k, v, i, logf, C0, n0, scale)
        out, state = _nbytes(q) // K, _nbytes(C0) + _nbytes(n0)
        counter.adjust((K - 1) * out + state)  # h of chunks 0 .. K-2; (C, n) before the last
        since = counter.readings()
        C1, n1, h = recurrent._mlstm_chunk(C0, n0, *(t[:, :L] for t in (q, k, v, i, logf)),
                                           scale)
        counter.add(since, K - 1)
        counter.adjust(-state)
        h = torch.cat([h] * K, dim=1)
        counter.adjust(-(K - 1) * out)
        return h, C1, n1

    return slstm_scan, mlstm_scan


def local_tensors(tree) -> list:
    """The local tensors of every DTensor and the plain tensors of a
    pytree (a Params module's masters included)."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    out = []
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.nn.Module):
            out += [p.to_local() if isinstance(p, DTensor) else p for p in leaf.parameters()]
        elif isinstance(leaf, DTensor):
            out.append(leaf.to_local())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def storage_bytes(tensors) -> int:
    """The bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def forget_meshes() -> None:
    """DTensor's caches of sharding propagation and redistribution plans
    emptied: they key a mesh by its shape and ranks, so a fake group of
    another rank in this process would be given the earlier group's
    meshes (their process groups destroyed).  Call it between the traces
    of two ranks in one process."""
    from torch.distributed.tensor import DTensor, _redistribute

    prop = DTensor._op_dispatcher.sharding_propagator
    for fn in (prop.propagate_op_sharding, getattr(prop, "_propagate_tensor_meta_cached", None),
               getattr(_redistribute, "_gen_transform_infos", None)):
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    if hasattr(_redistribute, "clear_redistribute_planner_cache"):
        _redistribute.clear_redistribute_planner_cache()
    if hasattr(torch._C, "_clear_DTensor_sharding_propagator_cache"):  # its C++ fast path's
        torch._C._clear_DTensor_sharding_propagator_cache()


# ------------------------------------------------------------------- a cell
def _inputs(cfg, shape, device) -> dict:
    """The cell's model inputs (``registry.input_specs``), zeros."""
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in registry.input_specs(cfg, shape).items()}


def _build(cfg, shape, mesh, grad_sync: str, device):
    """(the step, its arguments, the Counter of a decode cell's cache
    construction or ``None``) of a cell on fake tensors, the state sharded
    over ``mesh``."""
    if shape.kind == "train":
        state = steps.init_state(cfg, 0, device=device)
        sharding.shard_params(state["params"], cfg, mesh)
        state["opt"] = sharding.shard_opt_state(state["opt"], cfg, mesh)
        plan = collectives.PathPlan(n_chunks=4) if grad_sync == "seqbalance" else None
        step = steps.make_train_step(cfg, opt_mod.AdamWConfig(), mesh, grad_sync, plan)
        return step, (state, sharding.shard_batch(_inputs(cfg, shape, device), mesh)), None
    # float32 masters, cast at each use, as the JAX package serves them
    params = sharding.shard_params(model.init_params(cfg, 0, device=device, trainable=True),
                                   cfg, mesh)
    if shape.kind == "prefill":
        step = steps.make_prefill_step(cfg, shape.seq_len)
        return step, (params, sharding.shard_batch(_inputs(cfg, shape, device), mesh)), None
    made = Counter()  # the cache's construction, as a prefill's is counted in its step
    with made:
        cache = steps.serving_cache(params, cfg, shape.global_batch, shape.seq_len)
    tokens = sharding.shard_batch(_inputs(cfg, shape, device), mesh)["tokens"]
    return steps.make_serve_step(cfg), (params, tokens, cache), made


def trace_cell(cfg, shape, mesh, grad_sync: str = "xla", device=None,
               loop_count: bool = True, sites: bool = False,
               peak_sites: bool = False) -> dict:
    """Trace one step of ``cfg`` at ``shape`` over ``mesh`` (a "process"
    mesh of a fake group) on fake tensors on ``device`` (``None``: "cuda"
    where a card is present, else "cpu"); the record's counts.  With
    ``loop_count`` a serving step's recurrent loops (the sLSTM's time
    steps, the mLSTM's chunks) are traced one step and counted for all
    (``_loops_counted``: the same counts, number for number); else every
    step is traced.  With ``sites`` the record also holds
    ``collective_sites``: each collective's result bytes by kind and the
    line of the port that made it (``_site``), largest first; with
    ``peak_sites``, ``peak_sites``: the live bytes at the peak by the line
    of the port that made each storage and the line that called it
    ("arguments" for the step's inputs), largest first, summing to
    ``peak_bytes``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import recurrent

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, made = _build(cfg, shape, mesh, grad_sync, device)
        counter = Counter(sites, peak_sites)
        arguments = local_tensors(args)
        for t in arguments:
            counter.track(t, "arguments")
        arg_bytes = counter.live
        # a decode cell's peak while its cache is made: the other arguments
        # held, and the most its construction held
        built = (arg_bytes - storage_bytes(local_tensors(args[-1])) + made.peak
                 if made is not None else 0)
        rounds, sent = collectives.permute_rounds, collectives.permute_bytes
        whole = recurrent._slstm_scan, recurrent._mlstm_scan
        if loop_count:
            recurrent._slstm_scan, recurrent._mlstm_scan = _loops_counted(counter)
        try:
            with counter, torch.set_grad_enabled(shape.kind == "train"):
                out = step(*args)
        finally:
            recurrent._slstm_scan, recurrent._mlstm_scan = whole
        permutes = collectives.permute_rounds - rounds
        outputs = local_tensors(out)
        out_bytes = storage_bytes(outputs)
        del args, step
    coll = dict(counter.collectives)
    coll["collective-permute"] += collectives.permute_bytes - sent
    coll["count"] += permutes
    coll["total"] = sum(coll[k] for k in COLLECTIVE_OPS)
    extra = {} if made is None else {"cache_build_peak_bytes": float(made.peak)}
    if sites:
        extra["collective_sites"] = {f"{kind} {where}": float(n) for (kind, where), n in
                                     sorted(counter.sites.items(), key=lambda kv: -kv[1])}
    if peak_sites:
        extra["peak_sites"] = {where: float(n) for where, n in
                               sorted(counter.peak_sites.items(), key=lambda kv: -kv[1]) if n}
    return {
        "n_devices": mesh.size,
        "flops": float(counter.flops),
        # the flash kernel's share, which XLA's count of the JAX package's
        # Pallas call does not hold
        "flash_flops": float(counter.flash_flops),
        "bytes_accessed": float(counter.bytes_accessed),
        "argument_size_bytes": float(arg_bytes),
        "output_size_bytes": float(out_bytes),
        "temp_size_bytes": float(counter.peak - arg_bytes),
        "peak_bytes": float(max(counter.peak, built)),
        "collectives": coll,
        "collective_counts": {**counter.counts,
                              "collective-permute": counter.counts["collective-permute"]
                              + permutes},
        "trace_s": round(time.time() - t0, 1),
        **extra,
    }


def run_cell(arch: str, shape_name: str, mesh_label: str, grad_sync: str = "xla",
             remat: str = "dots", device=None, mesh=None, sites: bool = False,
             peak_sites: bool = False) -> dict:
    """The record of one cell, as ``repro.launch.dryrun.run_cell`` writes
    it (``trace_s`` for ``lower_s``/``compile_s``); ``mesh``: the
    production mesh of ``mesh_label`` over a fake group, unless given."""
    cfg = registry.get_config(arch).replace(remat=remat)
    shape = registry.get_shape(shape_name)
    ok, why = registry.cell_is_supported(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_label, "status": "SKIP",
                "reason": why}
    if mesh is None:
        mesh = mesh_mod.fake_production_mesh(multi_pod=MESHES[mesh_label])
    rec = trace_cell(cfg, shape, mesh, grad_sync, device, sites=sites, peak_sites=peak_sites)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_label, "status": "OK",
            "grad_sync": grad_sync, "remat": remat, **rec,
            # each superblock runs as code of its own: the counts are whole
            "flops_x": rec["flops"], "bytes_x": rec["bytes_accessed"],
            "coll_x": float(rec["collectives"]["total"])}


def _local(full, spec, sizes: dict) -> int:
    """The entries of one device's block of a tensor of shape ``full``
    under ``spec`` (the rule only assigns axes that divide)."""
    n = math.prod(full)
    for entry in spec:
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            n //= sizes[a]
    return n


_UNREAD = (".q_norm", ".k_norm")  # without qk-norm no serving step reads them


def expected_argument_bytes(cfg, shape, mesh, layout: str = "port") -> int:
    """The argument bytes of a cell on one device from shapes, specs and
    dtypes alone (no trace).  ``layout="port"``: each float32 master's
    local shard under the port's placements (``port_spec``: a superblock's
    tensor replicated over an axis the rule puts on the stacked dim), in
    training with its two moments and the step count; each input's under
    ``batch_specs``; for decode each cache leaf as
    ``launch.steps.serving_cache`` lays it out (a pod's share of the rows
    under ``cache_specs`` over the mesh without "pod"; a KV cache's write
    position an int, no bytes).  ``layout="jax"``: the same count for the
    JAX package's program: the stacked leaves under their whole spec, and
    the cache in its [n_super, B, S, K, hd] layout under its rule over the
    whole mesh, each position an int32, and without the qk-norm scales
    where a serving step never reads them (jit leaves such arguments
    out)."""
    sizes = dict(mesh.shape)
    train = shape.kind == "train"
    specs = sharding.param_specs(cfg, mesh)
    total = 4 if train else 0  # the step count
    for name, full in sharding.param_shapes(cfg).items():
        if layout == "jax" and not train and not cfg.qk_norm and name.endswith(_UNREAD):
            continue  # jit leaves out the arguments a program never reads
        if layout == "port" and name.startswith(sharding.STACKED):  # a tensor a superblock
            held = full[0] * _local(full[1:], sharding.port_spec(name, specs[name]), sizes)
        else:
            held = _local(full, specs[name], sizes)
        total += (3 if train else 1) * 4 * held  # float32 masters (and moments)
    inputs = registry.input_specs(cfg, shape)
    bspecs = sharding.batch_specs({k: s for k, (s, _) in inputs.items()}, mesh)
    total += sum(_local(s, bspecs[k], sizes) * dt.itemsize for k, (s, dt) in inputs.items())
    if shape.kind == "decode":
        total += _cache_bytes(cfg, shape, mesh, layout)
    return total


def _cache_bytes(cfg, shape, mesh, layout: str) -> int:
    """``expected_argument_bytes``' count of a decode cell's cache."""
    sizes = dict(mesh.shape)
    if layout == "port":
        rest = tuple(a for a in mesh.axis_names if a != "pod")
        sub = mesh_mod.Mesh(rest, tuple(sizes[a] for a in rest))
        pods, dp = sizes.get("pod", 1), math.prod(sizes[a] for a in ("pod", "data")
                                                   if a in sizes)
        # a pod's share of the rows, where the batch splits over pod x data
        B = shape.global_batch // pods if shape.global_batch % dp == 0 else shape.global_batch
        specs = sharding.cache_specs(cfg, sub, B, shape.seq_len)
        total = 0
        for name, (full, _) in sharding.cache_shapes(cfg, B, shape.seq_len).items():
            if name.startswith(sharding.STACKED):
                held = full[0] * _local(full[1:], sharding.port_spec(name, specs[name]), sizes)
            else:
                held = _local(full, specs[name], sizes)
            total += _cache_itemsize(cfg, name) * held
        return total
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    n = math.prod(sizes[a] for a in dp)
    total = 0
    for name, (full, perm) in sharding.cache_shapes(cfg, shape.global_batch,
                                                    shape.seq_len).items():
        jshape = tuple(full[d] for d in perm)  # the JAX package's layout
        spec = [None] * len(jshape)  # ``repro.dist.sharding.cache_specs``' rule
        if jshape and n > 1 and jshape[0] % n == 0:
            spec[0] = dp
        for i in range(1, len(jshape)):
            if jshape[i] % sizes["model"] == 0:
                spec[i] = "model"
                break
        total += (_cache_itemsize(cfg, name) or 4) * _local(jshape, spec, sizes)
    return total


def _cache_itemsize(cfg, name: str) -> int:
    """A cache leaf's bytes an entry, from the port's own cache init (0 for
    a KV cache's write position, an int in the port where the JAX package
    holds an int32 scalar)."""
    from repro_torch.models import transformer

    group, j, field = name.split(".")
    prelude, sb, _, trailing = transformer.block_program(cfg)
    unit = {"prelude": prelude, "main": sb, "trailing": trailing}[group][int(j)]
    c = transformer.unit_cache_init(cfg, unit, 1, 8, getattr(torch, cfg.dtype), device="meta")
    leaf = c._asdict()[field] if hasattr(c, "_asdict") else c[int(field)]
    return leaf.dtype.itemsize if isinstance(leaf, torch.Tensor) else 0  # a KV cache's pos


# ---------------------------------------------------------------- the CLI
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--grad-sync", default="xla", choices=["xla", "seqbalance"])
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None, help="the fake tensors' device (default: "
                                                   "cuda where a card is present, else cpu)")
    ap.add_argument("--sites", action="store_true",
                    help="record each collective's bytes by the line of the port that made it")
    ap.add_argument("--peak-sites", action="store_true",
                    help="record the live bytes at the peak by the line of the port that made "
                         "each storage")
    args = ap.parse_args(argv)

    labels = [label for label, multi in MESHES.items()
              if args.mesh == "both" or (args.mesh == "multi") == multi]
    if args.all:
        cells = [(arch, shape.name) for arch, shape, _, _ in
                 registry.list_cells(include_skipped=True)]
    else:
        cells = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    records = {}
    for label in labels:
        path = os.path.join(args.out, f"dryrun_{label}_{args.grad_sync}.json")
        existing = {}
        if os.path.exists(path):
            for r in json.load(open(path)):
                existing[(r["arch"], r["shape"])] = r
        for arch, shape_name in cells:
            if existing.get((arch, shape_name), {}).get("status") in ("OK", "SKIP"):
                print(f"[cached] {label} {arch} {shape_name}")
                continue
            print(f"[dryrun] {label} {arch} {shape_name} ...", flush=True)
            try:
                rec = run_cell(arch, shape_name, label, args.grad_sync, args.remat,
                               args.device, sites=args.sites, peak_sites=args.peak_sites)
            except Exception as e:
                rec = {"arch": arch, "shape": shape_name, "mesh": label, "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
            existing[(arch, shape_name)] = rec
            with open(path, "w") as f:
                json.dump(list(existing.values()), f, indent=1)
            extra = ""
            if rec["status"] == "OK":
                extra = (f" flops={rec['flops']:.3e} coll={rec['collectives']['total']:.3e}B"
                         f" peak={rec['peak_bytes']:.3e}B trace={rec['trace_s']}s")
                for where, n in list(rec.get("collective_sites", {}).items())[:8]:
                    extra += f"\n    {n:.3e} B {where}"
                for where, n in list(rec.get("peak_sites", {}).items())[:12]:
                    extra += f"\n    {n:.3e} B at the peak {where}"
            print(f"[{rec['status']}] {label} {arch} {shape_name}{extra}", flush=True)
        records[label] = existing
    return records


if __name__ == "__main__":
    main()
