"""SeqBalance's multipath collective, mirroring ``repro.dist.collectives``:
the gradient bucket is cut into ``n_chunks`` chunks, and each chunk runs its
own ring all-reduce (reduce-scatter, then all-gather) in its path's
direction; quarantined paths are skipped by the round-robin chunk -> path
map, so in-flight chunks never move.  With ``flowcells > 1`` each chunk is
cut further into token cells sprayed over the active paths (the reordering
the paper's rule avoids), and ``reorder_budget`` is the NIC's out-of-order
absorption in packets, the simulator's ``reorder`` operand.

The plans: ``PathPlan`` (with its wire dtype and version), ``PinnedPlan``
(an explicit chunk -> path table, the output of in-epoch replanning),
``apply_plan`` (the no-reordering rule across plan versions) and
``replan_chunk_paths``.

The ring: ``seqbalance_all_reduce`` over an axis of ring members, with
the chunks on the wire as float32, bfloat16 (the raw bits) or int8 (a
scale per segment and member, ``quantize_int8``), summed in float32;
``baseline_all_reduce`` (one all-reduce, the single-path elephant flow)
and ``tree_all_reduce_mean`` (the data-parallel grad sync).  The ring body
is written once, over two transports of an axis:

  * ``ProcessAxis``: this process is one member of a ``torch.distributed``
    group, and a round is one ``batch_isend_irecv`` (NCCL across cards,
    gloo on the CPU);
  * ``LocalAxis``: all n members are held on one device as the leading
    [n] dim of one tensor, and a round is a ``torch.roll`` over it (how one
    card runs a pod axis: NCCL refuses two ranks on one GPU).

``permute_rounds`` counts the ring's rounds (one a chunk a round, whatever
the transport): 2 (n - 1) a chunk of every leaf; ``permute_bytes`` the
bytes those rounds delivered to one member (the dry run's
collective-permute bytes).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device

WIRE_DTYPES = ("float32", "bfloat16", "int8")


def _active(inactive) -> list[int]:
    """The paths not quarantined; with every path quarantined, the primary
    path (traffic must still flow)."""
    return [p for p, dead in enumerate(inactive) if not dead] or [0]


def _check_cells(flowcells: int, reorder_budget: float) -> None:
    if flowcells < 1:
        raise ValueError(f"flowcells {flowcells} < 1")
    if not reorder_budget >= 0.0:
        raise ValueError(f"reorder_budget {reorder_budget} < 0")


@dataclasses.dataclass(frozen=True)
class PathPlan:
    """``directions`` holds one ring direction (+1 / -1) per path;
    ``inactive`` flags the paths that congestion feedback quarantined.
    ``wire_dtype`` is the chunks' dtype on the wire; ``version`` the plan's
    monotone generation number (the planning epoch that made it), which
    ``apply_plan`` compares.  ``flowcells`` cuts each chunk into that many
    equal cells round-robined over the active paths (``flowcell_paths``);
    1 is the classic plan.  ``reorder_budget`` (packets, >= 0) rides along
    to the simulator."""

    n_chunks: int = 4
    directions: tuple[int, ...] = (1, -1)
    inactive: tuple[bool, ...] | None = None
    wire_dtype: str = "float32"
    version: int = 0
    flowcells: int = 1
    reorder_budget: float = 0.0

    def __post_init__(self):
        if self.n_chunks < 1:
            raise ValueError(f"n_chunks {self.n_chunks} < 1")
        if any(d not in (1, -1) for d in self.directions):
            raise ValueError(f"directions {self.directions} are not all +1 / -1")
        if self.inactive is None:
            object.__setattr__(self, "inactive", (False,) * len(self.directions))
        if len(self.inactive) != len(self.directions):
            raise ValueError("inactive and directions differ in length")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype {self.wire_dtype!r} not in {WIRE_DTYPES}")
        _check_cells(self.flowcells, self.reorder_budget)

    @property
    def n_paths(self) -> int:
        return len(self.directions)

    def chunk_paths(self) -> tuple[int, ...]:
        """Round-robin chunk -> path assignment over the active paths."""
        active = _active(self.inactive)
        return tuple(active[c % len(active)] for c in range(self.n_chunks))

    def flowcell_paths(self) -> tuple[tuple[int, ...], ...]:
        """Per-chunk flowcell -> path table: chunk c's cell j rides
        ``active[(c + j) % n_active]``.  Cell 0 keeps the chunk's
        round-robin path, so ``flowcells=1`` is ``chunk_paths`` exactly."""
        active = _active(self.inactive)
        return tuple(tuple(active[(c + j) % len(active)] for j in range(self.flowcells))
                     for c in range(self.n_chunks))


@dataclasses.dataclass(frozen=True)
class PinnedPlan:
    """A plan whose chunk -> path table is explicit (``paths[c]``), the
    output of in-epoch replanning (``replan_chunk_paths``).  It has
    ``PathPlan``'s fields and methods, so whatever reads a plan
    (``workloads.collective_trace``) takes it, but ``chunk_paths()``
    returns the pinned table as it is."""

    n_chunks: int
    directions: tuple[int, ...]
    inactive: tuple[bool, ...]
    paths: tuple[int, ...]
    wire_dtype: str = "float32"
    version: int = 0
    flowcells: int = 1
    reorder_budget: float = 0.0

    def __post_init__(self):
        if len(self.paths) != self.n_chunks:
            raise ValueError(f"{len(self.paths)} pinned paths for {self.n_chunks} chunks")
        if len(self.inactive) != len(self.directions):
            raise ValueError("inactive and directions differ in length")
        if not all(0 <= p < len(self.directions) for p in self.paths):
            raise ValueError(f"pinned paths {self.paths} outside [0, {len(self.directions)})")
        _check_cells(self.flowcells, self.reorder_budget)

    @property
    def n_paths(self) -> int:
        return len(self.directions)

    def chunk_paths(self) -> tuple[int, ...]:
        return tuple(self.paths)

    def flowcell_paths(self) -> tuple[tuple[int, ...], ...]:
        """Cell 0 keeps the pinned path (replanning chose it); later cells
        walk the active paths from the pinned one."""
        active = _active(self.inactive)
        out = []
        for p0 in self.paths:
            base = active.index(p0) if p0 in active else 0
            out.append((p0,) + tuple(active[(base + j) % len(active)]
                                     for j in range(1, self.flowcells)))
        return tuple(out)


def apply_plan(current, candidate) -> tuple[object, bool]:
    """Versioned plan application, the no-reordering rule across plans:
    ``(applied, took_candidate)``.  The candidate replaces the current
    plan only when its ``version`` is higher; a stale (reordered) or
    repeated (duplicated) delivery is refused and the current table stays
    (applying an older table would move chunks already committed to the
    newer one's paths).  A refusal is not an error: the caller counts it."""
    if candidate.version <= current.version:
        return current, False
    return candidate, True


def replan_chunk_paths(paths: tuple[int, ...], directions: tuple[int, ...],
                       inactive: tuple[bool, ...],
                       in_flight: tuple[int, ...] = ()) -> tuple[int, ...]:
    """Mid-collective replan: move chunks off newly quarantined paths onto
    surviving ones without reordering any chunk.  Per chunk:

      * a chunk in ``in_flight`` keeps its path (its packets are already on
        the wire, and a move would race them);
      * a moving chunk goes only to a path of the same ring direction (a
        flip renumbers the segments it has already reduced);
      * with no surviving path of its direction the chunk stays on its
        quarantined path (late but in order).

    Chunks on healthy paths stay; movers spread round-robin over the
    survivors of their direction."""
    if len(directions) != len(inactive):
        raise ValueError("inactive and directions differ in length")
    in_flight_set = set(in_flight)
    survivors: dict[int, list[int]] = {}
    for p, d in enumerate(directions):
        if not inactive[p]:
            survivors.setdefault(d, []).append(p)
    out: list[int] = []
    rr: dict[int, int] = {}
    for c, p in enumerate(paths):
        same_dir = survivors.get(directions[p], [])
        if c in in_flight_set or not inactive[p] or not same_dir:
            out.append(p)
            continue
        k = rr.get(directions[p], 0)
        out.append(same_dir[k % len(same_dir)])
        rr[directions[p]] = k + 1
    return tuple(out)


# ------------------------------------------------------------ the ring's axes
permute_rounds = 0  # ring rounds run (one a chunk a round), by _permute
permute_bytes = 0  # the bytes those rounds delivered to one member


class LocalAxis:
    """All ``n`` ring members on one device (``None`` means ``"cuda"``): a
    member's tensor is row m of the leading [n] dim, and a round rolls the
    payloads over it (member m receives member m - d's)."""

    def __init__(self, n: int, device=None):
        if n < 1:
            raise ValueError(f"a ring of {n} members")
        self.size, self.members = n, n
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev

    def own(self, x) -> torch.Tensor:
        """``x`` ([n, ...], one row a member) as a tensor on the axis's
        device (an array is put there; a tensor elsewhere is refused)."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=self.device)
        if x.device != self.device:
            raise ValueError(f"a tensor on {x.device} for a ring on {self.device}")
        if x.dim() < 1 or x.shape[0] != self.size:
            raise ValueError(f"{tuple(x.shape)} has no leading dim of the {self.size} members")
        return x

    def unown(self, out: torch.Tensor) -> torch.Tensor:
        """Every member's result, [n, ...]."""
        return out

    def index(self) -> torch.Tensor:
        return torch.arange(self.size, device=self.device)

    def permute(self, payload: tuple, d: int) -> tuple:
        return tuple(torch.roll(a, d, 0) for a in payload)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x, 0, keepdim=True).expand(x.shape)


class ProcessAxis:
    """This process as one member of a ``torch.distributed`` group (``None``:
    the default group): its tensor is its own, and a round sends to rank
    + d and receives from rank - d in one ``batch_isend_irecv``, each
    payload as raw bytes (so that neither backend needs the wire dtype)."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.size, self.members = dist.get_world_size(group), 1
        self.rank = dist.get_rank(group)

    def own(self, x) -> torch.Tensor:
        """``x`` (this member's tensor) with a leading member dim of 1."""
        return torch.as_tensor(x)[None]

    def unown(self, out: torch.Tensor) -> torch.Tensor:
        """This member's result, without the member dim."""
        return out[0]

    def index(self) -> torch.Tensor:
        return torch.tensor([self.rank])

    def _peer(self, rank: int) -> int:
        import torch.distributed as dist

        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def permute(self, payload: tuple, d: int) -> tuple:
        import torch.distributed as dist

        to, frm = self._peer((self.rank + d) % self.size), self._peer((self.rank - d) % self.size)
        sent = [a.contiguous().view(torch.uint8) for a in payload]
        got = [torch.empty_like(b) for b in sent]
        ops = [dist.P2POp(dist.isend, b, to, self.group) for b in sent]
        ops += [dist.P2POp(dist.irecv, b, frm, self.group) for b in got]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(b.view(a.dtype) for a, b in zip(payload, got))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return out


# ------------------------------------------------------------- wire dtypes
INV_127 = float(torch.tensor(1 / 127, dtype=torch.float32))  # exact in float64 too


def quantize_int8(x: torch.Tensor, dim=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Absmax int8 quantization: (q int8, scale float32) with x ~= q * scale
    and |x - q * scale| <= scale / 2 (round to nearest, ties to even).  The
    absmax is taken over ``dim`` (kept as a dim of 1), or over all of
    ``x`` (a scalar scale, the JAX package's function).  absmax / 127 is
    rounded as XLA compiles it, a product by the float32 1 / 127."""
    a = torch.abs(x)
    m = torch.amax(a) if dim is None else torch.amax(a, dim=dim, keepdim=True)
    scale = torch.clamp(m.to(torch.float32) * INV_127, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _encode(x: torch.Tensor, wire: str) -> tuple:
    """A round's payload of x [members, seg]: the bfloat16 wire ships the
    raw bits (an int16 view), the int8 one each member's segment with its
    own scale."""
    if wire == "bfloat16":
        return (x.to(torch.bfloat16).view(torch.int16),)
    if wire == "int8":
        return quantize_int8(x, dim=-1)
    return (x,)


def _decode(y: tuple, wire: str) -> torch.Tensor:
    if wire == "bfloat16":
        return y[0].view(torch.bfloat16).to(torch.float32)
    if wire == "int8":
        return dequantize_int8(*y)
    return y[0]


def _add_decoded(acc: torch.Tensor, y: tuple, wire: str) -> torch.Tensor:
    """acc + the decoded payload.  On the int8 wire the JAX package's
    compiled ring contracts q * scale + acc into one fused multiply-add
    (XLA emits an FMA), which rounds once; so does this, in float64, where
    q * scale is exact."""
    if wire == "int8":
        q, scale = y
        return (acc.double() + q.double() * scale.double()).to(torch.float32)
    return acc + _decode(y, wire)


def _permute(payload: tuple, axis, d: int) -> tuple:
    global permute_rounds, permute_bytes
    permute_rounds += 1
    permute_bytes += sum(a.nbytes for a in payload) // axis.members
    return axis.permute(payload, d)


# ------------------------------------------------------------ ring engine
def _ring_all_reduce(v: torch.Tensor, axis, d: int, n: int, wire: str) -> torch.Tensor:
    """One chunk's ring all-reduce, in place: ``v`` is float32 [members, n,
    seg] (segment s of each member), direction ``d`` the chunk's path.
    2 (n - 1) rounds: reduce-scatter, after which member i holds segment
    i + d summed, then all-gather of the summed segments the same way
    around the ring.  Segment indices are floor-mod n, as in the JAX
    package (``%`` on tensors is ``torch.remainder``)."""
    if n == 1:
        return v
    i = axis.index().to(v.device)
    rows = torch.arange(v.shape[0], device=v.device)

    def seg(idx):
        return v[rows, idx % n]

    def put(val, idx):
        v[rows, idx % n] = val

    for s in range(n - 1):
        recv = _permute(_encode(seg(i - s * d), wire), axis, d)
        ridx = i - (s + 1) * d
        put(_add_decoded(seg(ridx), recv, wire), ridx)
    for s in range(n - 1):
        recv = _decode(_permute(_encode(seg(i + d - s * d), wire), axis, d), wire)
        put(recv, i - s * d)
    return v


def seqbalance_all_reduce(x, axis, plan=None) -> torch.Tensor:
    """Multipath chunked ring all-reduce of ``x`` over ``axis`` (a
    ``LocalAxis``: x is [n, ...], one row a member; a ``ProcessAxis``: x is
    this member's tensor).  Returns each member's sum, of ``x``'s shape and
    dtype: the flattened tensor padded to chunks x n x seg, one ring a
    chunk in ``plan.directions[plan.chunk_paths()[k]]``, float32 sums."""
    plan = PathPlan() if plan is None else plan
    x = axis.own(x)
    n, members = axis.size, axis.members
    flat = x.reshape(members, -1)
    m, c = flat.shape[1], plan.n_chunks
    seg = -(-max(m, 1) // (c * n))
    buf = torch.zeros((members, c * n * seg), dtype=torch.float32, device=x.device)
    buf[:, :m] = flat
    chunks = buf.view(members, c, n, seg)
    paths = plan.chunk_paths()
    for k in range(c):
        _ring_all_reduce(chunks[:, k], axis, int(plan.directions[paths[k]]), n,
                         plan.wire_dtype)
    return axis.unown(buf[:, :m].reshape(x.shape).to(x.dtype))


# ----------------------------------------------------------- conveniences
def baseline_all_reduce(x, axis) -> torch.Tensor:
    """One all-reduce: ``dist.all_reduce`` on a ``ProcessAxis``, the sum over
    the members (each member's row a view of it) on a ``LocalAxis`` -- the
    single-path elephant flow of the paper's motivation."""
    return axis.unown(axis.sum(axis.own(x)))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_all_reduce_mean(tree, axis, plan=None):
    """Grad sync: each leaf of ``tree`` (dicts, lists and tuples of tensors)
    through ``seqbalance_all_reduce``, then divided by the axis size in
    float32 (the data-parallel mean), leaf by leaf."""
    n = axis.size

    def one(g):
        s = seqbalance_all_reduce(g, axis, plan).to(torch.float32)
        return s.div_(n).to(torch.as_tensor(g).dtype)

    return _tree_map(one, tree)
