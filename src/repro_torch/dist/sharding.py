"""FSDP + TP sharding rules for the production meshes, mirroring
``repro.dist.sharding``, as pure functions of shapes and axis sizes.

One shape-driven rule serves all ten architectures: for every parameter
matrix the largest dim divisible by the ``model`` axis takes tensor
parallelism and the largest remaining dim divisible by the ``data`` axis
takes FSDP; vectors (norms, biases) stay replicated, and the ``pod`` axis
is never used for params (across pods the model is data-parallel, and the
grad sync goes through ``dist.collectives``).

The rule reads the JAX package's layout, where it was written: a "main" or
"encoder" leaf stacked on [n_super] (so at 16 x 16 ``data`` may land on
the stacked axis: qwen3-32b's ``main.0.ln`` (64, 5120) is ``("data",
"model")``), and KV caches as [B, S, K, hd].  So ``param_specs`` and
``cache_specs`` take a config, compute that layout's shapes from the
port's field tables without allocating anything, and key each spec by the
JAX leaf name (``models.weights.leaves``' names: "main.1.wq"); a cache's
spec is then carried to the port's head-major [B, K, S, hd].

A ``Spec`` is a trimmed tuple, one entry a dim: an axis name, a tuple of
axis names (major first) or ``None``, as ``PartitionSpec`` carries them;
``placements`` turns one into DTensor placements over a mesh.

``shard_params``, ``shard_opt_state``, ``shard_batch`` and ``shard_cache``
turn the port's tensors into DTensors with those placements, which the
steps of ``launch.steps`` then run as FSDP + TP.  The port holds each
superblock as a tensor of its own where the JAX layout stacks them, so an
axis the rule puts on the stacked dim is dropped (``port_spec``,
``stacked_drops``): whisper-large-v3 has 13 such leaves, qwen3-32b and
internvl2-26b 4, nemotron-4-15b 5 and granite-moe-3b-a800m 8 at the
production meshes, the other five configurations none.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import common, transformer


class Spec(tuple):
    """A PartitionSpec's entries: ``Spec("data", "model")``, ``Spec()``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _axis_sizes(mesh) -> dict:
    """axis name -> size of a ``launch.mesh.Mesh`` or a ``DeviceMesh``."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_names(mesh) -> tuple:
    return tuple(getattr(mesh, "axis_names", None) or mesh.mesh_dim_names)


def device_mesh(mesh):
    """The DeviceMesh of a "process" ``launch.mesh.Mesh``, or ``mesh`` itself
    where it is one (a submesh)."""
    return mesh.to_device_mesh() if hasattr(mesh, "to_device_mesh") else mesh


def _trim(assign: list) -> Spec:
    while assign and assign[-1] is None:
        assign.pop()
    return Spec(*assign)


def _matrix_spec(shape, data: int | None, model: int | None) -> Spec:
    if len(shape) < 2:
        return Spec()  # norms / biases / scalars: replicate
    order = sorted(range(len(shape)), key=lambda i: (-shape[i], i))
    assign: list = [None] * len(shape)
    mi = next((i for i in order if model and shape[i] % model == 0), None)
    if mi is not None:
        assign[mi] = "model"
    di = next((i for i in order if i != mi and data and shape[i] % data == 0), None)
    if di is not None:
        assign[di] = "data"
    return _trim(assign)


def _groups(cfg):
    """(group, units, n): the stacks of ``cfg`` in ``weights.leaves``' order,
    n the stacked superblocks (``None`` for an unstacked group)."""
    prelude, sb, n_super, trailing = transformer.block_program(cfg)
    out = [("prelude", prelude, None), ("trailing", trailing, None), ("main", sb, n_super)]
    if cfg.is_encoder_decoder:
        out.append(("encoder", *transformer.encoder_program(cfg)))
    return out


def param_shapes(cfg) -> dict:
    """leaf name -> shape in the JAX package's layout (a "main" or "encoder"
    leaf with its leading [n_super]), from the field tables."""
    D = cfg.d_model
    out = {"embed": (cfg.vocab, D), "final_norm": (D,)}
    if cfg.is_encoder_decoder:
        out["enc_norm"] = (D,)
    if not cfg.tie_embeddings:
        out["lm_head"] = (D, cfg.vocab)
    for group, units, n in _groups(cfg):
        if n == 0:
            continue
        for j, u in enumerate(units):
            for f, field in transformer.unit_shapes(cfg, u).items():
                out[f"{group}.{j}.{f}"] = (() if n is None else (n,)) + tuple(field.shape)
    return out


def param_specs(cfg, mesh) -> dict:
    """leaf name -> Spec of each parameter of ``cfg`` (and of its AdamW
    moments, which mirror it), the rule applied to the JAX layout's
    shape."""
    sizes = _axis_sizes(mesh)
    data, model = sizes.get("data"), sizes.get("model")
    return {name: _matrix_spec(shape, data, model)
            for name, shape in param_shapes(cfg).items()}


def _dp(sizes: dict):
    """The data-parallel axes present and their product."""
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    return dp, math.prod(sizes[a] for a in dp)


def batch_specs(batch: dict, mesh) -> dict:
    """Inputs shard their leading (global batch) dim over pod x data
    (``batch``: name -> a tensor, or its shape)."""
    dp, n = _dp(_axis_sizes(mesh))

    def spec(leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        if not shape or n <= 1 or shape[0] % n:
            return Spec()
        return Spec(dp if len(dp) > 1 else dp[0])

    return {k: spec(v) for k, v in batch.items()}


HEAD_MAJOR = (0, 2, 1, 3)  # the port's [B, K, S, hd] -> the JAX package's [B, S, K, hd]


def cache_shapes(cfg, batch: int, max_len: int) -> dict:
    """leaf name -> (the port's shape, the permutation of its dims that gives
    the JAX package's layout) of each cache leaf of ``cfg`` ("main.0.k":
    a stacked leaf with its leading [n_super], as in the JAX package; KV
    caches head-major in the port), read from the port's own cache init on
    the meta device."""
    out = {}
    for group, units, n in _groups(cfg):
        if group == "encoder" or n == 0:
            continue  # the encoder keeps no cache
        for j, u in enumerate(units):
            c = transformer.unit_cache_init(cfg, u, batch, max_len,
                                            getattr(torch, cfg.dtype), device="meta")
            named = c._asdict().items() if hasattr(c, "_asdict") else enumerate(c)
            lead = () if n is None else (n,)
            for f, leaf in named:
                shape = tuple(getattr(leaf, "shape", ()))
                perm = HEAD_MAJOR if u.kind in ("attn", "cross") and f != "pos" else None
                perm = tuple(range(len(shape))) if perm is None else perm
                out[f"{group}.{j}.{f}"] = (lead + shape,
                                           tuple(range(len(lead))) + tuple(d + len(lead)
                                                                           for d in perm))
    return out


def _carry(spec: Spec, perm: tuple) -> Spec:
    """A spec over the JAX layout's dims (``perm[j]`` the port's dim of JAX
    dim j) as a spec over the port's dims."""
    assign = [None] * len(perm)
    for j, entry in enumerate(spec):
        assign[perm[j]] = entry
    return _trim(assign)


def cache_specs(cfg, mesh, batch: int, max_len: int) -> dict:
    """leaf name -> Spec of each KV / recurrent cache leaf in the port's
    layout: the JAX package's rule (the leading dim over pod x data, plus
    ``model`` on the first later dim it divides) applied to the JAX
    layout's [B, S, K, hd] (S where the axis divides it, where the port's
    own [B, K, S, hd] would give K), then carried to the port's dims."""
    sizes = _axis_sizes(mesh)
    model = sizes.get("model")
    dp, n = _dp(sizes)

    def spec(shape) -> Spec:
        assign: list = [None] * len(shape)
        if shape and n > 1 and shape[0] % n == 0:
            assign[0] = dp if len(dp) > 1 else dp[0]
        for i in range(1, len(shape)):
            if model and shape[i] % model == 0:
                assign[i] = "model"
                break
        return _trim(assign)

    out = {}
    for name, (shape, perm) in cache_shapes(cfg, batch, max_len).items():
        out[name] = _carry(spec(tuple(shape[d] for d in perm)), perm)
    return out


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``'s dims: ``Shard(d)`` on
    each mesh dim that shards tensor dim d, else ``Replicate()``; a tuple
    entry ("pod", "data") is ``Shard(d)`` on both, the major one first, as
    DTensor splits a dim over mesh dims in their order."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    where = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{entry} is not in the mesh's order {names}")
        for a in axes:
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate() for a in names)



# ------------------------------------------------------- the port's DTensors
STACKED = ("main.", "encoder.")  # the groups stacked on [n_super] in the JAX layout


def port_spec(name: str, spec: Spec) -> Spec:
    """The spec of the port's tensor of leaf ``name``: a stacked leaf's
    spec without its stacked dim.  The port holds each superblock as a
    tensor of its own, so an axis the JAX layout puts on the stacked dim
    cannot be carried across: it is dropped (the port's tensor is
    replicated over it)."""
    if name.startswith(STACKED):
        return _trim(list(spec[1:]))
    return spec


def stacked_drops(specs: dict) -> dict:
    """leaf name -> the axis entry on the stacked dim, for each leaf of
    ``specs`` (``param_specs``' or ``cache_specs``' names) whose JAX spec
    puts one there: what ``port_spec`` drops."""
    return {name: spec[0] for name, spec in specs.items()
            if name.startswith(STACKED) and spec and spec[0] is not None}


def distribute(t: torch.Tensor, mesh, spec: Spec, requires_grad: bool | None = None):
    """``t`` (the whole tensor, the same on every rank) as a DTensor over
    ``mesh`` (a "process" ``launch.mesh.Mesh`` or a DeviceMesh) with
    ``spec``'s placements: each rank keeps its own block,
    and nothing is sent (every rank already holds the whole)."""
    from torch.distributed.tensor import distribute_tensor

    out = distribute_tensor(t.detach(), device_mesh(mesh), placements(spec, mesh),
                            **common.no_source())
    if requires_grad:
        out.requires_grad_(True)
    return out


def shard_params(params, cfg, mesh):
    """``params`` (``models.model.Params``) with each tensor replaced, in
    place, by a DTensor over ``mesh`` with the placements of its
    ``param_specs`` (FSDP over ``data``, TP over ``model``, replicated over
    ``pod``), less the stacked dim (``port_spec``); returns ``params``."""
    from torch import nn

    from repro_torch.models import weights

    specs = param_specs(cfg, mesh)
    for name, _, module, attr in weights.slots(params):
        p = module._parameters[attr]
        module._parameters[attr] = nn.Parameter(
            distribute(p, mesh, port_spec(name, specs[name])), requires_grad=p.requires_grad)
    return params


def shard_opt_state(opt, cfg, mesh):
    """The AdamW state with each moment (the JAX layout's, a stacked leaf
    stacked on [n_super]) a DTensor over ``mesh`` that mirrors its
    parameter's placements (ZeRO: the moments are sharded as the params
    are), the stacked dim replicated; the step count stays a tensor."""
    specs = param_specs(cfg, mesh)

    def one(moments: dict) -> dict:
        out = {}
        for name, m in moments.items():
            spec = port_spec(name, specs[name])
            out[name] = distribute(m, mesh, Spec(None, *spec) if name.startswith(STACKED)
                                   else spec)
        return out

    return type(opt)(step=opt.step, mu=one(opt.mu), nu=one(opt.nu))


def shard_batch(batch: dict, mesh) -> dict:
    """Each input (the global batch, the same on every rank) as a DTensor
    with its ``batch_specs`` placements: dim 0 over pod x data."""
    specs = batch_specs(batch, mesh)
    return {k: distribute(v, mesh, specs[k]) for k, v in batch.items()}


def _cache_leaves(cache: dict):
    """(name, superblock, unit index, field) of each tensor of a cache of
    ``models.model.init_cache``, under ``cache_specs``' names."""
    for group in ("prelude", "trailing"):
        for j, c in enumerate(cache[group]):
            for f, leaf in (c._asdict().items() if hasattr(c, "_asdict") else enumerate(c)):
                if isinstance(leaf, torch.Tensor):
                    yield f"{group}.{j}.{f}", None, j, f
    for i, sb in enumerate(cache["main"]):
        for j, c in enumerate(sb):
            for f, leaf in (c._asdict().items() if hasattr(c, "_asdict") else enumerate(c)):
                if isinstance(leaf, torch.Tensor):
                    yield f"main.{j}.{f}", i, j, f


def _block(shape, places, sizes, coord) -> tuple:
    """A device's block of a tensor of ``shape`` under ``places`` (Shard or
    Replicate on each mesh dim of ``sizes``), at mesh coordinate
    ``coord``: (lo, hi) a dim.  A dim split over several mesh dims is
    split in their order, the first major, as DTensor splits it."""
    lo, n = [0] * len(shape), [1] * len(shape)
    for p, size, c in zip(places, sizes, coord):
        if p.is_shard():
            lo[p.dim] = lo[p.dim] * size + c
            n[p.dim] *= size
    return tuple((i * (d // k), (i + 1) * (d // k)) for i, d, k in zip(lo, shape, n))


def _meet(a: tuple, b: tuple):
    """The intersection of two blocks, or ``None``."""
    out = tuple((max(x[0], y[0]), min(x[1], y[1])) for x, y in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


_PLANS: dict = {}  # (mesh, this device, shape, placements before and after) -> _plan's


def _plan(mesh, shape, src, dst) -> dict:
    """``relayout``'s exchange, the same on every rank: each device's block
    under ``dst`` cut where the blocks under ``src`` meet it; a piece that
    the device holds itself is copied, any other comes from one holder,
    the holders of a block taken in turn by the devices that need it (a
    transposition of two mesh dims is then a permutation).  Returns, for
    this rank: its blocks before and after, the pieces it keeps, those it
    receives and sends (each by global rank, in the order both ends list
    them), and whether any rank sends at all."""
    import itertools

    sizes, mine = tuple(mesh.shape), tuple(mesh.get_coordinate())
    with common.real_tensors():
        ranks = mesh.mesh.flatten().tolist()
    key = (sizes, tuple(ranks), mine, tuple(shape), src, dst)
    if key in _PLANS:
        return _PLANS[key]
    coords = list(itertools.product(*map(range, sizes)))
    rank_of = dict(zip(coords, ranks))
    held = {c: _block(shape, src, sizes, c) for c in coords}
    holders: dict = {}
    for c in coords:
        holders.setdefault(held[c], []).append(c)
    turn = dict.fromkeys(holders, 0)
    keep, recv, send, anyone = [], [], [], False
    for c in coords:
        block = _block(shape, dst, sizes, c)
        for b, who in holders.items():
            piece = _meet(block, b)
            if piece is None:
                continue
            if held[c] == b:
                if c == mine:
                    keep.append(piece)
                continue
            giver = who[turn[b] % len(who)]
            turn[b] += 1
            anyone = True
            if c == mine:
                recv.append((rank_of[giver], piece))
            if giver == mine:
                send.append((rank_of[c], piece))
    plan = {"held": held[mine], "block": _block(shape, dst, sizes, mine), "keep": keep,
            "recv": sorted(recv), "send": sorted(send), "any": anyone}
    _PLANS[key] = plan
    return plan


def relayout(t, places):
    """The DTensor ``t`` laid out as ``places``, where its layout and
    ``places`` split dims only (no partial sums) and evenly: each device
    keeps what it already holds of its new block and gets the rest in one
    all-to-all over the default group (every rank runs it; a device of
    another pod's mesh exchanges nothing with this one), each piece from
    one device that holds it.  So a device receives at most its own block.
    DTensor's own redistribution from a batch split over "data" to one
    split over "model" (a filled cache moved to ``cache_specs``, the
    mLSTM's and the RG-LRU's states with it) gathers the whole batch on
    every device and slices it again: 16 times the device's share at 16 x
    16.  Else (a partial sum, an uneven split) DTensor's redistribution.
    For caches: no gradient."""
    import torch.distributed as dist

    mesh, src, dst = t.device_mesh, tuple(t.placements), tuple(places)
    if src == dst:
        return t
    sizes = tuple(mesh.shape)
    counts = [[1] * t.dim() for _ in range(2)]
    for side, pl in zip(counts, (src, dst)):
        for p, n in zip(pl, sizes):
            if p.is_shard():
                side[p.dim] *= n
    if (any(not (p.is_shard() or p.is_replicate()) for p in src + dst)
            or any(d % k for side in counts for d, k in zip(t.shape, side))):
        return t.redistribute(mesh, dst)
    plan = _plan(mesh, t.shape, src, dst)

    def at(piece, block):
        return tuple(slice(lo - b0, hi - b0) for (lo, hi), (b0, _) in zip(piece, block))

    local = t.to_local()
    out = local.new_empty([hi - lo for lo, hi in plan["block"]])
    for piece in plan["keep"]:
        out[at(piece, plan["block"])] = local[at(piece, plan["held"])]
    if plan["any"]:
        world = dist.get_world_size()
        ins, outs = [0] * world, [0] * world
        parts = []
        for rank, piece in plan["send"]:
            parts.append(local[at(piece, plan["held"])].reshape(-1))
            ins[rank] += parts[-1].numel()
        for rank, piece in plan["recv"]:
            outs[rank] += math.prod(hi - lo for lo, hi in piece)
        ops = torch.ops._c10d_functional
        got = ops.wait_tensor(ops.all_to_all_single(
            torch.cat(parts) if parts else local.new_empty(0), outs, ins,
            dist.group.WORLD.group_name))
        at_ = 0
        for _, piece in plan["recv"]:
            n = math.prod(hi - lo for lo, hi in piece)
            out[at(piece, plan["block"])] = got[at_:at_ + n].view(
                [hi - lo for lo, hi in piece])
            at_ += n
    return common.from_local(out, mesh, dst, t.shape)


def empty_cache(cfg, mesh, batch: int, max_len: int, rows: bool = False, device=None) -> dict:
    """The empty cache of ``model.init_cache(params, cfg, batch, max_len)``
    (each leaf at its initial value: zeros, the sLSTM's stabilizer at -10),
    each tensor a DTensor laid out by ``cache_specs`` (less the stacked
    dim, ``port_spec``), or with ``rows`` as the batch
    (``common.batch_placements``: the prefill's working cache, which its
    units fill where their rows lie), of which only this
    device's block is ever allocated, on ``device``: the whole batch's
    cache, 275 GB at qwen3-32b prefill_32k, is never made on a device.
    The ints (a KV cache's ``pos``) as ``init_cache`` makes them."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    specs = cache_specs(cfg, mesh, batch, max_len)
    dm = device_mesh(mesh)
    dtype = getattr(torch, cfg.dtype)

    def unit(u, group: str, j: int):
        shapes = transformer.unit_cache_init(cfg, u, batch, max_len, dtype, device="meta")
        with common.real_tensors():  # one entry of each leaf: its initial value
            values = transformer.unit_cache_init(cfg, u, 1, 1, dtype, device="cpu")

        def make(f, leaf, value):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            to = (common.batch_placements(dm, leaf.shape[0]) if rows else
                  _cache_placements(specs, mesh, f"{group}.{j}.{f}"))
            with common.real_tensors():
                local = compute_local_shape_and_global_offset(leaf.shape, dm, to)[0]
                fill = value.flatten()[0].item()
                assert bool((value == fill).all()), f"{group}.{j}.{f} starts at several values"
            block = torch.full(local, fill, dtype=leaf.dtype, device=device)
            return common.from_local(block, dm, to, leaf.shape)
        if hasattr(shapes, "_asdict"):
            return type(shapes)(**{f: make(f, a, getattr(values, f))
                                   for f, a in shapes._asdict().items()})
        return tuple(make(f, a, b) for f, (a, b) in enumerate(zip(shapes, values)))

    prelude, sb, n_super, trailing = transformer.block_program(cfg)
    return {"prelude": tuple(unit(u, "prelude", j) for j, u in enumerate(prelude)),
            "main": [tuple(unit(u, "main", j) for j, u in enumerate(sb))
                     for _ in range(n_super)],
            "trailing": tuple(unit(u, "trailing", j) for j, u in enumerate(trailing))}


def _cache_placements(specs: dict, mesh, name: str) -> tuple:
    """The placements of cache leaf ``name`` under ``cache_specs``' specs
    (less the stacked dim, ``port_spec``)."""
    return placements(port_spec(name, specs[name]), mesh)


def shard_cache(cache: dict, cfg, mesh, batch: int, max_len: int) -> dict:
    """A sharded prefill's filled cache (DTensors laid out as its rows) with
    each tensor moved by ``relayout`` to its ``cache_specs`` placements
    (less the stacked dim, ``port_spec``); the structure and the ints (a
    KV cache's ``pos``) kept.  The superblocks are taken out of
    ``cache["main"]`` as they are moved, and the groups out of ``cache``,
    so that each leaf's old layout is freed once its new one is made (the
    filled cache's two layouts are never held whole together)."""
    specs = cache_specs(cfg, mesh, batch, max_len)

    def unit(c, group: str, j: int):
        def put(f, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            return relayout(leaf, _cache_placements(specs, mesh, f"{group}.{j}.{f}"))
        if hasattr(c, "_asdict"):
            return type(c)(**{f: put(f, v) for f, v in c._asdict().items()})
        return tuple(put(f, v) for f, v in enumerate(c))

    out = {}
    for group in ("prelude", "trailing"):
        units, cache[group] = cache[group], ()
        out[group] = tuple(unit(c, group, j) for j, c in enumerate(units))
        del units
    main, out["main"] = cache["main"], []
    for i in range(len(main)):
        sb, main[i] = main[i], None
        out["main"].append(tuple(unit(c, "main", j) for j, c in enumerate(sb)))
        del sb
    return out
