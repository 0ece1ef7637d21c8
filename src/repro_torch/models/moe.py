"""Fine-grained Mixture-of-Experts channel mixer (DeepSeekMoE / Granite-MoE),
mirroring ``repro.models.moe``.

Top-k routing with shared (always-on) experts.  Dispatch is the JAX
package's sort-based fixed-shape algorithm: token replicas are bucketed
per expert up to a capacity C, the earliest tokens first (a stable sort by
expert), the rest dropped; the expert FFNs run as batched products over
[E, C, D].  The router runs in float32.

The combine differs in its means, not its sums: the JAX package
scatter-adds the weighted expert outputs into the tokens' rows, which on
the card would be float atomics in no fixed order.  Here each token
gathers its kept slots (at most top_k) and adds them in ascending slot
order, which is expert order, in the compute dtype: the order of the JAX
package's scatter on the CPU, and the same bits from run to run.

On DTensors (a sharded step) the layer is expert-parallel, as GSPMD
partitions the JAX package's: the experts are split over the
data-parallel ranks (and the pods, inside ``routed_over``), and no device
holds every expert's slots.  Each rank routes its own rows
(``route_rank``: a replica's place in its expert's group counts that
expert's replicas on the ranks before it, so capacity, drops and the
earliest-first order are those of one routing over the global batch),
gathers every rank's slots, weights and tokens (the tokens split over
"model": T x D / m a device), fills its own experts' slots, runs each
"model" rank's 1 / m share of them with whole rows (an all-to-all each
way), and sends each token's weighted outputs back to the token's rank in
a reduce-scatter.  Experts that do not split over the owners are padded
with empty ones (granite-moe-3b-a800m's 40 to 48 over 16).  A token's sum
is then its experts on each device in expert order, then the devices in
rank order: within float32 rounding of the one-device combine, not bit
for bit.

Aux losses (Switch load balance and router z-loss) are returned as the
JAX package returns them, for ``forward_train``.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import common


class MoEParams(common.ParamModule):
    """ln [D]; router [D, E] (float32); we_i, we_g [E, D, Fe]; we_o [E, Fe,
    D]; ws_i, ws_g [D, Fs], ws_o [Fs, D]: the shared experts (Fs =
    n_shared * d_expert, 0 without)."""

    FIELDS = ("ln", "router", "we_i", "we_g", "we_o", "ws_i", "ws_g", "ws_o")


def shapes(cfg) -> dict:
    """field -> ``common.Field``."""
    D, m = cfg.d_model, cfg.moe
    E, Fe = m.n_experts, m.d_expert
    Fs = m.n_shared * m.d_expert
    dense = common.dense
    return {"ln": common.norm((D,)), "router": dense((D, E), D, f32=True),
            "we_i": dense((E, D, Fe), D), "we_g": dense((E, D, Fe), D),
            "we_o": dense((E, Fe, D), Fe), "ws_i": dense((D, Fs), D),
            "ws_g": dense((D, Fs), D), "ws_o": dense((Fs, D), Fs)}


def _capacity(T: int, E: int, k: int, cf: float) -> int:
    c = int(T * k * cf / E) + 1
    return max(8, min(c, T))


class Routing(NamedTuple):
    """The dispatch of T tokens: router logits and probabilities [T, E]
    (float32), each token's experts by falling probability and their
    renormalized weights [T, k], and each replica's slot [T, k] (expert *
    C + its place among the expert's replicas; ``E * C`` where it overflowed
    the capacity C and was dropped).  A rank's routing (``route_rank``)
    holds its own rows, their slots those of the whole batch."""

    logits: torch.Tensor
    probs: torch.Tensor
    gate_idx: torch.Tensor
    gate_vals: torch.Tensor
    slot: torch.Tensor
    capacity: int

    @property
    def sentinel(self) -> int:
        return self.probs.shape[-1] * self.capacity

    @property
    def dropped(self) -> torch.Tensor:
        """The count of dropped replicas (a tensor, so no host read)."""
        return (self.slot == self.sentinel).sum()


def _route(p: MoEParams, flat: torch.Tensor, cfg, experts=None) -> Routing:
    """``moe.py:59-80`` of the JAX package on the normed tokens [T, D];
    with ``experts`` [T, k], those experts instead of the top-k."""
    return _route_logits(flat.to(torch.float32) @ p.router.to(torch.float32), cfg, experts)


def _route_logits(logits: torch.Tensor, cfg, experts=None) -> Routing:
    """``_route`` from the router's logits [T, E] (float32)."""
    return route_rank(logits, None, logits.shape[0], cfg, experts)


def expert_counts(gate_idx: torch.Tensor, E: int) -> torch.Tensor:
    """[E]: each expert's replicas among the rows of ``gate_idx`` [T, k]
    (int64, a fixed shape: no host read)."""
    e = gate_idx.reshape(-1)
    return torch.zeros(E, dtype=torch.long, device=e.device).index_add_(
        0, e, torch.ones_like(e))


def route_rank(logits: torch.Tensor, before, T: int, cfg, experts=None) -> Routing:
    """One rank's share of the routing of a batch of T tokens routed as one:
    ``logits`` [T_r, E] (float32) are the rank's rows, and ``before`` [E]
    counts each expert's replicas on the ranks before it in the global
    token order (``None``: none, the rank holds the whole batch).  The
    capacity is cut over T, and a replica's place in its expert's group is
    ``before`` plus its place among the rank's own replicas of that expert
    (the earliest first), so the ranks' slots, concatenated in order, are
    ``_route_logits``' on the whole batch.  ``experts`` [T_r, k]: those
    experts instead of the top-k."""
    m = cfg.moe
    Tr = logits.shape[0]
    E, k = m.n_experts, m.top_k
    C = _capacity(T, E, k, m.capacity_factor)
    probs = torch.softmax(logits, dim=-1)
    if experts is None:
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1, sorted=True)
    else:
        gate_idx = experts.to(device=logits.device, dtype=torch.long)
        gate_vals = probs.gather(-1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # group the replicas by expert, the earliest token first (a stable sort)
    e_flat = gate_idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    grp_start = torch.searchsorted(e_sorted, torch.arange(E, device=logits.device),
                                  right=False)
    pos = torch.arange(Tr * k, device=logits.device) - grp_start[e_sorted]
    if before is not None:
        pos = pos + before[e_sorted]
    slot_sorted = torch.where(pos < C, e_sorted * C + pos, E * C)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)  # replica order
    return Routing(logits, probs, gate_idx, gate_vals, slot.view(Tr, k), C)


def routing(p: MoEParams, x: torch.Tensor, cfg) -> Routing:
    """The dispatch that ``apply`` makes of x [B, S, D] (for the checks:
    the experts each token went to and the replicas dropped)."""
    return _route(p, common.rms_norm(x, p.ln).reshape(-1, x.shape[-1]), cfg)


def _dispatch(r: Routing, flat: torch.Tensor):
    """The replicas' tokens by slot, xe [E, C, D], and each slot's weight
    [E * C + 1] (float32; a dropped replica writes the sentinel slot E * C,
    which nothing reads)."""
    T, D = flat.shape
    E, k = r.probs.shape[-1], r.gate_idx.shape[-1]
    C, EC = r.capacity, r.sentinel
    slot = r.slot.reshape(-1)
    tok = torch.arange(T, device=flat.device).repeat_interleave(k)
    tok_of_slot = torch.full((EC + 1,), T, dtype=torch.long, device=flat.device)
    tok_of_slot.scatter_(0, slot, tok)
    w_of_slot = torch.zeros(EC + 1, dtype=torch.float32, device=flat.device)
    w_of_slot.scatter_(0, slot, r.gate_vals.reshape(-1))
    flat_pad = torch.cat([flat, flat.new_zeros((1, D))])  # sentinel token T
    return flat_pad[tok_of_slot[:EC]].view(E, C, D), w_of_slot


def _combine(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """Each token's kept slots of ye [E * C, D] added in ascending (expert)
    order: [T, D]."""
    ye = torch.cat([ye, ye.new_zeros((1, ye.shape[-1]))])  # the sentinel slot: zeros
    by_expert = torch.argsort(r.gate_idx, dim=-1)
    parts = ye[r.slot.gather(-1, by_expert)]  # [T, k, D]
    out = parts[:, 0]
    for j in range(1, parts.shape[1]):
        out = out + parts[:, j]
    return out


def _aux(r: Routing, m, E: int) -> dict:
    """Switch load balance, E * sum_e (frac_tokens_e * mean_prob_e), and the
    router z-loss."""
    frac = F.one_hot(r.gate_idx[:, 0], E).to(torch.float32).mean(0)
    mean_prob = r.probs.mean(0)
    return {"lb_loss": m.aux_loss * E * torch.sum(frac * mean_prob),
            "z_loss": m.router_z_loss * torch.mean(torch.logsumexp(r.logits, -1) ** 2)}


# ------------------------------------------------- the expert-parallel layer
def owned_slots(slot: torch.Tensor, first: int, n: int, C: int, E: int, width: int):
    """The slots of experts [first, first + n) (an owner's share) from
    every replica's slot [T, k] of the whole batch, each expert's C slots
    laid out in ``width`` (>= C) of which the last ``width - C`` stay
    empty: the token in each [n * width] (T where the slot is empty) and
    each replica's place among them [T, k] (``n * width`` where another
    device owns its expert or it was dropped)."""
    T = slot.shape[0]
    local = slot - first * C
    mine = (slot < E * C) & (local >= 0) & (local < n * C)
    dest = torch.where(mine, local // C * width + local % C, n * width)
    tok = torch.arange(T, device=slot.device).repeat_interleave(slot.shape[1])
    tok_of_slot = torch.full((n * width + 1,), T, dtype=torch.long, device=slot.device)
    tok_of_slot.scatter_(0, dest.reshape(-1), tok)
    return tok_of_slot[:n * width], dest


def owned_weights(dest: torch.Tensor, gate_vals: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Each owned slot's weight [n_slots] (float32) from every replica's
    place ``dest`` [T, k] (``owned_slots``) and weight [T, k]."""
    w = torch.zeros(n_slots + 1, dtype=torch.float32, device=dest.device)
    return w.scatter(0, dest.reshape(-1), gate_vals.reshape(-1).to(torch.float32))[:n_slots]


def _picked(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row r of the result: the sum over j of the rows ``idx[r, j]`` of t
    [N, D], in order of j, where row N is zeros."""
    t = torch.cat([t, t.new_zeros((1, t.shape[-1]))])
    out = t[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        out = out + t[idx[:, j]]
    return out


class _Picked(torch.autograd.Function):
    """``_picked(t, there)``, whose gradient is ``_picked(g, back)``: the
    owner's dispatch (rows of the tokens into the slots) and combine (rows
    of the slots into the tokens) are each other's adjoint, a slot holding
    one replica at most, so either way is a gather and neither gradient
    adds into a row from many (the empty slot's and the other owners'
    replicas would all land on one row, which serializes the card's
    indexed accumulation)."""

    @staticmethod
    def forward(ctx, t, there, back):
        ctx.save_for_backward(back)
        return _picked(t, there)

    @staticmethod
    def backward(ctx, g):
        back, = ctx.saved_tensors
        return _picked(g, back), None, None


def dispatch_owned(tokens: torch.Tensor, tok_of_slot: torch.Tensor,
                   dest: torch.Tensor) -> torch.Tensor:
    """An owner's slots [n * W, D] from every token [T, D] (zeros where a
    slot is empty), of ``owned_slots``' ``tok_of_slot`` and ``dest``."""
    return _Picked.apply(tokens, tok_of_slot[:, None], torch.sort(dest, dim=-1).values)


def combine_owned(yw: torch.Tensor, dest: torch.Tensor,
                  tok_of_slot: torch.Tensor) -> torch.Tensor:
    """An owner's share of the combine: each token's kept replicas among
    the weighted slots ``yw`` [n * W, D] added in ascending slot (so
    expert) order, zeros where it has none: [T, D]."""
    return _Picked.apply(yw, torch.sort(dest, dim=-1).values, tok_of_slot[:, None])


def _ops():
    return torch.ops._c10d_functional


def _all_gather(t: torch.Tensor, groups) -> torch.Tensor:
    """Every rank's rows (dim 0) of ``t`` over ``groups`` ((group, size,
    rank), major first), in the global row order."""
    for g, n, _ in reversed(groups):
        t = _ops().wait_tensor(_ops().all_gather_into_tensor(t.contiguous(), n, g.group_name))
    return t


def _reduce_scatter(t: torch.Tensor, groups) -> torch.Tensor:
    """The sum over the ranks of ``groups`` of ``t`` [rows of every rank,
    ...], this rank's rows of it."""
    for g, n, _ in groups:
        t = _ops().wait_tensor(_ops().reduce_scatter_tensor(t.contiguous(), "sum", n,
                                                            g.group_name))
    return t


def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    for g, _, _ in groups:
        t = _ops().wait_tensor(_ops().all_reduce(t.contiguous(), "sum", g.group_name))
    return t


class _Gathered(torch.autograd.Function):
    """``_all_gather``, whose gradient is the ``_reduce_scatter`` of the
    gathered tensor's gradient: each rank uses every rank's rows in a sum
    of its own."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _all_gather(t, groups)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.groups), None


class _Scattered(torch.autograd.Function):
    """``_reduce_scatter``, whose gradient is the ``_all_gather`` of this
    rank's rows' gradients."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _reduce_scatter(t, groups)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.groups), None


class _Summed(torch.autograd.Function):
    """``_all_reduce`` over ``groups``, its gradient all-reduced over
    ``back`` (the pods: each pod's loss holds the sum as a term of its own,
    and the pods' gradients are averaged) and kept as it is over the rest
    (a mesh dim, over which the loss is one replicated value)."""

    @staticmethod
    def forward(ctx, t, groups, back):
        ctx.back = back
        return _all_reduce(t, groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.back), None, None


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of ``t``'s dim 0 (m equal chunks) to rank j of ``group``, of
    m ranks; chunk j of the result from rank j."""
    g, m, _ = group
    return _ops().wait_tensor(_ops().all_to_all_single(
        t.contiguous(), [t.shape[0] // m] * m, [t.shape[0] // m] * m, g.group_name))


def _to_rows(t: torch.Tensor, groups) -> torch.Tensor:
    """[n, W, D / m], this rank's columns of every slot, to [n, W / m, D],
    its rows (slots) with every column, over the m ranks of ``groups``
    (the "model" group, or none)."""
    if not groups:
        return t
    m = groups[0][1]
    n, W, Dm = t.shape
    y = _all_to_all(t.view(n, m, W // m, Dm).transpose(0, 1).reshape(m * n, W // m, Dm),
                    groups[0])
    return y.view(m, n, W // m, Dm).permute(1, 2, 0, 3).reshape(n, W // m, m * Dm)


def _to_columns(t: torch.Tensor, groups) -> torch.Tensor:
    """``_to_rows``' inverse: [n, W / m, D] to [n, W, D / m]."""
    if not groups:
        return t
    m = groups[0][1]
    n, Wm, D = t.shape
    y = _all_to_all(t.view(n, Wm, m, D // m).permute(2, 0, 1, 3).reshape(m * n, Wm, D // m),
                    groups[0])
    return y.view(m, n, Wm, D // m).transpose(0, 1).reshape(n, m * Wm, D // m)


class _Rows(torch.autograd.Function):
    """``_to_rows``, its gradient ``_to_columns``'s."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _to_rows(t, groups)

    @staticmethod
    def backward(ctx, g):
        return _to_columns(g, ctx.groups), None


class _Columns(torch.autograd.Function):
    """``_to_columns``, its gradient ``_to_rows``'s."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _to_columns(t, groups)

    @staticmethod
    def backward(ctx, g):
        return _to_rows(g, ctx.groups), None


_PODS = []  # the pods' process group while ``routed_over`` is entered


@contextlib.contextmanager
def routed_over(group):
    """Inside, a sharded unit routes the tokens of every member of the
    process group ``group`` (the pods of a mesh, each running its own rows
    of the global batch, pod-major, over the mesh without "pod") as one
    batch: the capacity cut over all of them, each pod's ranks owning
    their share of the experts, and each rank given back its own rows of
    the combine.  This is what GSPMD computes where the JAX package leaves
    the pod axis to it.  A step enters it around its forward and backward
    (remat recomputes the forward there).  ``None`` or a group of one:
    nothing changes."""
    _PODS.append(group)
    try:
        yield
    finally:
        _PODS.pop()


def _pods():
    """(group, size, rank) of the pods ``routed_over`` names, or ``None``."""
    import torch.distributed as dist

    group = _PODS[-1] if _PODS else None
    if group is None or dist.get_world_size(group) == 1:
        return None
    return group, dist.get_world_size(group), dist.get_rank(group)


class _Ranks(NamedTuple):
    """How a sharded unit's T tokens [T, D] (a DTensor over ``mesh``) lie
    on the ranks: ``rows``, their placements (the batch split over every
    data-parallel dim of the mesh where T divides, else replicated; whole
    over "model"); ``split``, the groups that split the rows, major first
    ((group, size, rank): the pods first); ``spread``, the mesh's
    data-parallel groups over which the rows are replicated; ``owner`` of
    ``owners``, this device's place among the owners of the experts (pod
    major, then the mesh's dims in order), and ``row_rank``, its rows'
    place in the global order; ``dp``, the mesh's data-parallel dims of
    more than one member, which split the experts."""

    mesh: object
    rows: list
    split: tuple
    spread: tuple
    owner: int
    owners: int
    row_rank: int
    dp: tuple
    model: int | None  # the "model" dim of the mesh
    columns: tuple  # its group, as ``split``'s, or ()

    def grads(self, placements) -> list:
        """The placements of the gradient of a local tensor laid out as
        ``placements``: where the rows are replicated over the
        data-parallel dims, each rank uses them for its own experts, so
        their gradients are partial sums there."""
        from torch.distributed.tensor import Partial

        return [Partial() if self.spread and i in self.dp else pl
                for i, pl in enumerate(placements)]


def _ranks(flat, pods) -> _Ranks:
    from torch.distributed.tensor import Replicate, Shard

    mesh = flat.device_mesh
    names = mesh.mesh_dim_names
    dp = [i for i, name in enumerate(names) if name != "model" and mesh.size(i) > 1]
    groups = [(mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i)) for i in dp]
    n_dp = math.prod(n for _, n, _ in groups)
    split = flat.shape[0] % n_dp == 0
    rows = [Shard(0) if split and i in dp else Replicate() for i in range(mesh.ndim)]
    local = 0
    for _, n, r in groups:
        local = local * n + r
    pod, n_pods = (pods[2], pods[1]) if pods is not None else (0, 1)
    model = names.index("model") if "model" in names else None
    columns = (() if model is None or mesh.size(model) == 1 else
               ((mesh.get_group(model), mesh.size(model), mesh.get_local_rank(model)),))
    return _Ranks(mesh, rows, ((pods,) if pods else ()) + (tuple(groups) if split else ()),
                  () if split else tuple(groups), pod * n_dp + local, n_pods * n_dp,
                  pod * (n_dp if split else 1) + (local if split else 0), tuple(dp), model,
                  columns)


def _placed(ranks: _Ranks, row, model_dim: int | None):
    """Placements over ranks.mesh: ``row`` on each data-parallel dim,
    Shard(model_dim) on "model" (Replicate for ``None``)."""
    from torch.distributed.tensor import Replicate, Shard

    out = list(row)
    if ranks.model is not None:
        out[ranks.model] = Replicate() if model_dim is None else Shard(model_dim)
    return out


def _local(t, placements, grads=None):
    """A DTensor's local tensor laid out as ``placements``, its gradient so
    (or as ``grads``)."""
    t = t if list(t.placements) == placements else t.redistribute(t.device_mesh, placements)
    return t.to_local(grad_placements=grads or placements)


def _experts_padded(w, E_pad: int):
    """A DTensor weight [E, ...] (E whole on every device) with zero experts
    appended up to E_pad (a multiple of the experts' owners), its layout
    kept; as it is where E_pad == E."""
    if w.shape[0] == E_pad:
        return w
    from torch.distributed.tensor import DTensor

    loc = w.to_local()
    zeros = DTensor.from_local(loc.new_zeros((E_pad - w.shape[0], *loc.shape[1:])),
                               w.device_mesh, w.placements, run_check=False)
    return torch.cat([w, zeros])


def _apply_sharded(p: MoEParams, flat, cfg, experts, with_aux: bool):
    """The routed experts' output [T, D] of DTensor tokens ``flat`` (laid
    out as it came), this rank's ``Routing`` and the aux losses: the
    expert-parallel layer of the module's docstring."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    m = cfg.moe
    E, k = m.n_experts, m.top_k
    D = flat.shape[-1]
    dt = flat.dtype
    pods = _pods()
    ranks = _ranks(flat, pods)
    mesh = ranks.mesh
    T = flat.shape[0] * (pods[1] if pods else 1)
    tok_pl = _placed(ranks, ranks.rows, None)
    flat_r = flat if list(flat.placements) == tok_pl else flat.redistribute(mesh, tok_pl)

    # ---- routing: each rank its own rows, the replicas before it counted
    logits = _local(flat_r.to(torch.float32) @ p.router.to(torch.float32), tok_pl,
                    ranks.grads(tok_pl))
    Tr = logits.shape[0]
    if experts is not None:
        experts = experts[ranks.row_rank * Tr:(ranks.row_rank + 1) * Tr]
    else:  # the top-k chosen once: the counts and the slots must see the same experts
        experts = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1, sorted=True).indices
    counts = _all_gather(expert_counts(experts.to(torch.long), E)[None], ranks.split)
    r = route_rank(logits, counts[:ranks.row_rank].sum(0), T, cfg, experts)

    # ---- dispatch: every rank's slots, weights and tokens (split over
    # "model"), this device's experts' slots filled from them, each
    # expert's slots padded to split over "model"
    n = -(-E // ranks.owners)  # experts a device (E padded to a multiple of the owners)
    C = r.capacity
    cols = ranks.columns[0][1] if ranks.columns else 1
    if D % cols:
        raise ValueError(f"d_model {D} does not split over {cols} model ranks")
    W = -(-C // cols) * cols
    slot = _all_gather(r.slot, ranks.split)
    gate_vals = _Gathered.apply(r.gate_vals, ranks.split)
    cols_pl = _placed(ranks, ranks.rows, 1)
    tokens = _Gathered.apply(_local(flat_r, cols_pl, ranks.grads(cols_pl)), ranks.split)
    tok_of_slot, dest = owned_slots(slot, ranks.owner * n, n, C, E, W)
    # each device weights its own columns of D, so a weight's gradient is
    # the sum of the "model" ranks' (Megatron's f: identity, its gradient
    # all-reduced)
    w_of_slot = _Summed.apply(owned_weights(dest, gate_vals, n * W), (), ranks.columns)

    # ---- the expert products: each "model" rank a 1 / m share of its
    # experts' slots with every column (an all-to-all each way), against
    # the experts' whole weights (gathered over "model", their gradients
    # partial sums over it); a pod's share of the experts over its ranks
    n_mesh = ranks.owners // (pods[1] if pods else 1)
    owned = [Shard(0) if i in ranks.dp else Replicate() for i in range(mesh.ndim)]
    we = []
    for w in (p.we_i, p.we_g, p.we_o):
        w = _experts_padded(w, n * ranks.owners)
        if pods is not None:
            w = w.narrow(0, pods[2] * n_mesh * n, n_mesh * n)
        w = w.redistribute(mesh, [o if o.is_shard() else pl
                                  for o, pl in zip(owned, w.placements)])
        we.append(_local(w, owned, grads=[Partial() if i == ranks.model else pl
                                          for i, pl in enumerate(owned)]))
    with common.span("moe.experts"):
        xe = _Rows.apply(dispatch_owned(tokens, tok_of_slot, dest).view(n, W, -1),
                         ranks.columns)
        up = torch.bmm(xe, we[0])
        gate = F.silu(torch.bmm(xe, we[1]))
        ye = _Columns.apply(torch.bmm(gate * up, we[2]), ranks.columns)

    # ---- combine: this device's experts' weighted outputs for every token,
    # summed over the owners onto the tokens' ranks
    out = combine_owned(ye.reshape(n * W, -1) * w_of_slot[:, None].to(dt), dest, tok_of_slot)
    out = _Scattered.apply(out, ranks.split)
    if ranks.spread:
        out = _Summed.apply(out, ranks.spread, ())
    out = DTensor.from_local(out, mesh, cols_pl, run_check=False, shape=flat.shape,
                             stride=flat.stride())
    out = out.redistribute(mesh, flat.placements)

    aux = {}
    if with_aux:  # the means over all T tokens: the rows' sums, summed over the ranks
        sums = torch.cat([F.one_hot(r.gate_idx[:, 0], E).to(torch.float32).sum(0),
                          r.probs.sum(0), (torch.logsumexp(r.logits, -1) ** 2).sum()[None]])
        if ranks.spread:  # every rank holds the rows' sums: one of them counts them
            sums = sums * float(all(rank == 0 for _, _, rank in ranks.spread))
        sums = _Summed.apply(sums, ranks.split + ranks.spread, (pods,) if pods else ())
        frac, mean_prob, z = sums[:E] / T, sums[E:2 * E] / T, sums[2 * E] / T
        aux = {name: DTensor.from_local(v, mesh, [Replicate()] * mesh.ndim, run_check=False)
               for name, v in (("lb_loss", m.aux_loss * E * torch.sum(frac * mean_prob)),
                               ("z_loss", m.router_z_loss * z))}
    return out, r, aux


def apply(p: MoEParams, x: torch.Tensor, cfg, with_aux: bool = True, routes=None,
          experts=None):
    """(x + the mixer's output, aux losses): ``{"lb_loss", "z_loss"}`` as
    the JAX package's where ``with_aux``, else an empty dict (serving
    reads none).  For the checks: ``routes``, a list, receives the
    dispatch (``Routing``; on DTensors this rank's rows of it);
    ``experts`` [T, k] sends each token to those experts instead of its
    top-k (a reference run routed as another).

    On DTensors (a sharded step) the expert-parallel layer of the module's
    docstring, inside ``routed_over`` over every pod's tokens; the shared
    experts' products laid out as their weights (``common.matmul``)."""
    m = cfg.moe
    B, S, D = x.shape
    E = m.n_experts
    dt = x.dtype
    flat = common.rms_norm(x, p.ln).reshape(-1, D)
    if common.is_dtensor(x):
        with common.span("moe.sharded"):
            out, r, aux = _apply_sharded(p, flat, cfg, experts, with_aux)
    else:
        with common.span("moe.dispatch"):
            r = _route(p, flat, cfg, experts)
            xe, w_of_slot = _dispatch(r, flat)
            EC = r.sentinel
        with common.span("moe.experts"):
            up = common.matmul(xe, p.we_i)
            gate = F.silu(common.matmul(xe, p.we_g))
            ye = common.matmul(gate * up, p.we_o)
        with common.span("moe.combine"):  # each token's kept slots in ascending (expert) order
            out = _combine(ye.view(EC, D) * w_of_slot[:EC, None].to(dt), r)
        aux = _aux(r, m, E) if with_aux else {}
    if routes is not None:
        routes.append(r)

    # ---- shared experts (dense)
    if p.ws_i.shape[-1]:
        su = common.matmul(flat, p.ws_i)
        sg = F.silu(common.matmul(flat, p.ws_g))
        out = out + common.matmul(sg * su, p.ws_o)
    return x + out.view(B, S, D), aux
