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

Aux losses (Switch load balance and router z-loss) are returned as the
JAX package returns them, for ``forward_train``.
"""
from __future__ import annotations

import contextlib
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
    the capacity C and was dropped)."""

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
    m = cfg.moe
    T = logits.shape[0]
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
    pos = torch.arange(T * k, device=logits.device) - grp_start[e_sorted]
    slot_sorted = torch.where(pos < C, e_sorted * C + pos, E * C)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)  # replica order
    return Routing(logits, probs, gate_idx, gate_vals, slot.view(T, k), C)


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


_PODS = []  # the pods' process group while ``routed_over`` is entered


@contextlib.contextmanager
def routed_over(group):
    """Inside, a sharded unit routes the tokens of every member of the
    process group ``group`` (the pods of a mesh, each running its own rows
    of the global batch, pod-major, over the mesh without "pod") as one
    batch: the router logits and the tokens gathered over the pods, the
    capacity cut over all of them, each pod running its share of the
    experts, and each pod given back its own rows of the combine.  This is
    what GSPMD computes where the JAX package leaves the pod axis to it.
    A step enters it around its forward and backward (remat recomputes
    the forward there).  ``None`` or a group of one: nothing changes."""
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


class _PodRows(torch.autograd.Function):
    """Every pod's rows (dim 0) of a tensor, pod-major; the gradient of a
    pod's rows is the sum of every pod's gradient of them."""

    @staticmethod
    def forward(ctx, t, group, n, rank):
        import torch.distributed as dist

        ctx.pods = group, n, rank
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        group, n, rank = ctx.pods
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=group)
        return g.chunk(n)[rank], None, None, None


def _all_pods(t, pods):
    return t if pods is None else _PodRows.apply(t, *pods)


def _routed(logits, flat, cfg, experts, pods):
    """The dispatch of every pod's tokens (whole tensors): (Routing, xe,
    the slots' weights)."""
    r = _route_logits(_all_pods(logits, pods), cfg, experts)
    return (r, *_dispatch(r, _all_pods(flat, pods)))


def _combined(ye, w_of_slot, r, pods):
    """Every pod's experts' slots ye [E * C / pods, D] weighted and combined
    into the tokens, this pod's rows of them (whole tensors)."""
    ye = _all_pods(ye, pods)
    out = _combine(ye * w_of_slot[:r.sentinel, None].to(ye.dtype), r)
    if pods is None:
        return out
    _, n, rank = pods
    return out.chunk(n)[rank]


def _over_experts(xe):
    """A DTensor xe [E, C, D] with its experts split over the mesh's
    data-parallel dims (a slice of the replicated whole: nothing moves),
    so that each device runs the products of its own experts."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = xe.device_mesh
    E, dp, out = xe.shape[0], 1, []
    for name, n in zip(mesh.mesh_dim_names, mesh.shape):
        if name != "model" and E % (dp * n) == 0:
            dp *= n
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return xe.redistribute(mesh, out)


def apply(p: MoEParams, x: torch.Tensor, cfg, with_aux: bool = True, routes=None,
          experts=None):
    """(x + the mixer's output, aux losses): ``{"lb_loss", "z_loss"}`` as
    the JAX package's where ``with_aux``, else an empty dict (serving
    reads none).  For the checks: ``routes``, a list, receives the
    dispatch (``Routing``); ``experts`` [T, k] sends each token to those
    experts instead of its top-k (a reference run routed as another).

    On DTensors (a sharded step) the router's product stays sharded; the
    routing (a global sort, a search and scatters, which have no DTensor
    rule), the dispatch and the combine run on the whole tensors gathered
    on every device (``common.on_whole``), as GSPMD gathers a sorted
    dim, and inside ``routed_over`` over every pod's tokens; the expert
    products run with the experts split over the data-parallel dims (and
    over the pods), each product laid out as its weight
    (``common.matmul``)."""
    m = cfg.moe
    B, S, D = x.shape
    E = m.n_experts
    dt = x.dtype
    flat = common.rms_norm(x, p.ln).reshape(-1, D)
    sharded = common.is_dtensor(x)
    pods = _pods() if sharded else None
    we = p.we_i, p.we_g, p.we_o
    with common.span("moe.dispatch"):
        if sharded:
            logits = flat.to(torch.float32) @ p.router.to(torch.float32)
            r, xe, w_of_slot = common.on_whole(_routed, logits, flat, cfg, experts, pods)
            if pods is not None:  # each pod its share of the experts
                if E % pods[1]:
                    raise ValueError(f"{E} experts do not split over {pods[1]} pods")
                n = E // pods[1]
                xe = xe[pods[2] * n:(pods[2] + 1) * n]
                we = tuple(w.narrow(0, pods[2] * n, n) for w in we)
            xe = _over_experts(xe)
        else:
            r = _route(p, flat, cfg, experts)
            xe, w_of_slot = _dispatch(r, flat)
        if routes is not None:
            routes.append(r)
        EC = r.sentinel

    with common.span("moe.experts"):
        up = common.matmul(xe, we[0])
        gate = F.silu(common.matmul(xe, we[1]))
        ye = common.matmul(gate * up, we[2])

    with common.span("moe.combine"):  # each token's kept slots in ascending (expert) order
        if sharded:  # the experts' dim whole where it does not split evenly (40 on 16)
            ye = common.merge_ready(common.split_ready(ye, 0, ye.shape[0]), 0, 1)
            out = common.on_whole(_combined, ye.reshape(-1, D), w_of_slot, r, pods)
        else:
            out = _combine(ye.view(EC, D) * w_of_slot[:EC, None].to(dt), r)

    # ---- shared experts (dense)
    if p.ws_i.shape[-1]:
        su = common.matmul(flat, p.ws_i)
        sg = F.silu(common.matmul(flat, p.ws_g))
        out = out + common.matmul(sg * su, p.ws_o)

    aux = {}
    if with_aux:
        aux = common.on_whole(_aux, r, m, E) if sharded else _aux(r, m, E)
    return x + out.view(B, S, D), aux
