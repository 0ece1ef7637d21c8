"""The port's model stack and serving engine against the JAX package's, on
the CPU: configs, the ported modules (common, mlp, attention, moe; the
recurrent units are in test_torch_recurrent.py), the model (forward_train,
loss_fn with the MoE aux, prefill, decode_step) and ServeEngine, at the
REDUCED configs of all ten architectures.

Weights come from ``repro_torch.models.weights.numpy_params``: the same
numpy arrays go through ``from_jax_params`` into the port and through
``jnp.asarray`` into the JAX package's own NamedTuples.  On CPU tensors
the port's attention runs the flash kernel's plain version.

Run as a script, it writes ``src/repro_torch/models/serve_reference.json``
(the JAX package serving chip_smoke.py phase 12's case: gemma2-2b at full
width, 4 layers, window 256; about 0.9 B float32 parameters, minutes on
8 cores) or ``families_reference.json`` (phase 14's: the moe, hybrid and
ssm architectures at full width, cut in depth, with the MoE routing of
each prefill layer, the float32 run fed each bfloat16 run's tokens, and
xlstm-1.3b's units fed one input; 14 minutes on 8 cores), and prints the
port's CPU differences against it (and, for the units, with a fault
planted):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_models.py --write-serve-reference
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_models.py --write-families-reference
"""
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as ja, common as jcommon, mlp as jmlp  # noqa: E402
from repro.models import model as jmodel, moe as jmoe, recurrent as jrec  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as ta, common as tcommon, mlp as tmlp  # noqa: E402
from repro_torch.models import moe as tmoe, recurrent as trec  # noqa: E402
from repro_torch.models import model as tmodel, transformer as tt, weights  # noqa: E402
from repro_torch.serve import compare, engine as tengine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "src" / "repro_torch" / "models" / "serve_reference.json"
FAMILIES_REFERENCE = ROOT / "src" / "repro_torch" / "models" / "families_reference.json"

# Tolerances of the port against the JAX package on the same inputs.
# float32: both compute in float32, the products summed in another order
# (logits of up to about 7 agree to 2e-6); a bfloat16 rounding anywhere
# on the way would break it.  bfloat16: each side rounds every product and
# activation to bfloat16 (8 significant bits), in other places (the JAX
# package rounds the attention scores and weights to bfloat16, the kernel
# and its plain version keep them in float32), so a value may land one or
# two bfloat16 steps apart, and the errors of a layer's outputs carry into
# the next: 2**-6 relative, plus 2**-4 absolute (logits of up to about 7,
# and of any size, agree to 0.035).
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2**-6, atol=2**-4)}
# The top-k of the MoE router is not continuous: where a token's k-th and
# (k+1)-th probabilities nearly tie, the last bit of its router input
# decides its experts and moves its output by a share of an expert; and a
# token sent elsewhere takes or frees a slot of a full expert, so that a
# later token of that expert is dropped or kept.  In float32 the two
# packages route every token alike.  In bfloat16 the router's input is
# rounded to 2**-9 and carries the earlier layers' bfloat16 differences,
# which moves a probability by up to about 2**-8; two programs of the JAX
# package (its forward_train and a prefill unit by unit) round otherwise
# too.  So the bfloat16 model comparison (at the config's own capacity
# factor) sends each token of forward_train and prefill to the experts
# of the JAX package's prefill unit by unit (``jax_moe_routing``,
# ``experts=``) and holds them against the logits that routing gives:
# everything after the choice (capacity, drops, combine) under TOL.  The
# port's own choice must be that one for every token whose gap is at
# least BF16_ROUTER_TIE.  A decode step's B tokens drop
# nothing: those at a near-tie are left out there.
BF16_ROUTER_TIE = 2**-8
# xLSTM in bfloat16 (7 mLSTM and 1 sLSTM layers at the REDUCED width) is
# noisier than TOL: the JAX package's own bfloat16 logits lie up to 0.66
# (mean 0.058) from its float32 ones, the port's 0.40 (0.041), so two
# right bfloat16 runs differ by more than 2**-4.  There the port's
# bfloat16 run is held to the JAX package's float32 run: its largest and
# its mean |error| no more than BF16_SPREAD_FACTOR times the JAX package's
# own bfloat16 run's (a wrong term or scale puts it at several times).
BF16_SPREAD = ("xlstm-1.3b",)
BF16_SPREAD_FACTOR = 1.5
DTYPES = tuple(TOL)
# every architecture: the dense, vlm, audio, moe, hybrid and ssm families
ARCHS = ("gemma2-2b", "qwen3-32b", "granite-3-8b", "nemotron-4-15b", "internvl2-26b",
         "whisper-large-v3", "deepseek-moe-16b", "granite-moe-3b-a800m", "recurrentgemma-9b",
         "xlstm-1.3b")
DENSE = ("gemma2-2b", "qwen3-32b", "granite-3-8b", "nemotron-4-15b")
MOE = ("deepseek-moe-16b", "granite-moe-3b-a800m")
RECURRENT = ("recurrentgemma-9b", "xlstm-1.3b")
# the JAX package's params NamedTuple of each unit kind
UNIT_TUPLES = {"attn": ja.AttnParams, "cross": ja.AttnParams, "mlp": jmlp.MLPParams,
               "moe": jmoe.MoEParams, "mlstm": jrec.MLSTMParams, "slstm": jrec.SLSTMParams,
               "rglru": jrec.RGLRUParams}


def configs(arch, dtype="float32", **kw):
    """The JAX package's and the port's REDUCED config, alike."""
    return (jreg.get_config(arch, reduced=True).replace(dtype=dtype, **kw),
            treg.get_config(arch, reduced=True).replace(dtype=dtype, **kw))


def unit_tuple(u, fields):
    return UNIT_TUPLES[u.kind](**{k: jnp.asarray(v) for k, v in fields.items()})


def to_jax(tree, jcfg):
    """A ``weights.numpy_params`` tree as the JAX package's own params."""
    prelude, sb, _, trailing = jt.block_program(jcfg)
    out = dict(tree, embed=jnp.asarray(tree["embed"]),
               final_norm=jnp.asarray(tree["final_norm"]),
               prelude=tuple(unit_tuple(u, f) for u, f in zip(prelude, tree["prelude"])),
               main=tuple(unit_tuple(u, f) for u, f in zip(sb, tree["main"])),
               trailing=tuple(unit_tuple(u, f) for u, f in zip(trailing, tree["trailing"])))
    if jcfg.is_encoder_decoder:
        eu, _ = jt.encoder_program(jcfg)
        out["encoder"] = tuple(unit_tuple(u, f) for u, f in zip(eu, tree["encoder"]))
        out["enc_norm"] = jnp.asarray(tree["enc_norm"])
    return out


def both_params(jcfg, tcfg, seed=0):
    tree = weights.numpy_params(tcfg, seed)
    return to_jax(tree, jcfg), weights.from_jax_params(tree, tcfg, device="cpu")


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def close(got, want, dtype, what=""):
    np.testing.assert_allclose(f32(got), f32(want), err_msg=what, **TOL[dtype])


def inputs(tcfg, B, S, seed=1):
    """numpy tokens [B, S + 1] and the model inputs of the first S."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, tcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
    if tcfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((B, tcfg.encoder_frames, tcfg.d_model),
                                              dtype=np.float32)
    if tcfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal((B, tcfg.n_vision_tokens, tcfg.d_model),
                                                     dtype=np.float32)
    return toks, ({k: jnp.asarray(v) for k, v in batch.items()},
                  {k: torch.as_tensor(v) for k, v in batch.items()})


# ------------------------------------------------------------------ configs
def test_configs_match_reference():
    assert treg.ARCHS == jreg.ARCHS
    for arch in jreg.ARCHS:
        for reduced in (False, True):
            assert dataclasses.asdict(treg.get_config(arch, reduced)) == \
                dataclasses.asdict(jreg.get_config(arch, reduced))
    assert [(a, s.name, ok, why) for a, s, ok, why in treg.list_cells(True)] == \
        [(a, s.name, ok, why) for a, s, ok, why in jreg.list_cells(True)]
    for arch in ("whisper-large-v3", "internvl2-26b", "gemma2-2b"):
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            want = jreg.input_specs(jreg.get_config(arch), jreg.get_shape(name),
                                    batch_override=2)
            got = treg.input_specs(treg.get_config(arch), treg.get_shape(name),
                                   batch_override=2)
            assert {k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()} == \
                {k: (shape, str(d).removeprefix("torch.")) for k, (shape, d) in got.items()}


# ------------------------------------------------------------------ common
@pytest.mark.parametrize("dtype", DTYPES)
def test_common_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 4, 16), dtype=np.float32) * 3
    scale = rng.standard_normal(16, dtype=np.float32) * 0.1
    pos = np.arange(600, 640)[None].repeat(2, 0)
    jx, tx = jnp.asarray(x, dtype), torch.as_tensor(x).to(getattr(torch, dtype))
    close(tcommon.rms_norm(tx, torch.as_tensor(scale)),
          jcommon.rms_norm(jx, jnp.asarray(scale)), dtype, "rms_norm")
    close(tcommon.rope(tx, torch.as_tensor(pos), 10000.0),
          jcommon.rope(jx, jnp.asarray(pos), 10000.0), dtype, "rope")
    close(tcommon.softcap(tx, 5.0), jcommon.softcap(jx, 5.0), dtype, "softcap")
    for kind in ("gated_silu", "gated_gelu", "squared_relu", "gelu"):
        close(tcommon.act_fn(kind)(tx), jcommon.act_fn(kind)(jx), dtype, kind)


def test_rope_rotates_the_two_halves():
    """Position p turns the pair (x[i], x[i + hd/2]) by p * theta**(-2i/hd)."""
    x = torch.zeros((1, 1, 1, 8))
    x[..., 1] = 1.0  # pair 1: (x[1], x[5])
    out = tcommon.rope(x, torch.tensor([[3]]), 10000.0)[0, 0, 0]
    ang = 3 * 10000.0 ** (-1 / 4)
    np.testing.assert_allclose(out[[1, 5]].numpy(), [np.cos(ang), np.sin(ang)], rtol=1e-6)
    assert float(out[[0, 2, 3, 4, 6, 7]].abs().max()) == 0.0


# ------------------------------------------------------------------ mlp
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-3-8b", "nemotron-4-15b",
                                  "whisper-large-v3"])
def test_mlp_matches_reference(arch, dtype):
    """gated GELU, gated SiLU, squared ReLU (ungated) and GELU (ungated)."""
    jcfg, tcfg = configs(arch, dtype)
    u = tt.Unit("mlp")
    fields = weights.numpy_params(tcfg, 3)["main"][-1]
    fields = {k: v[0] for k, v in fields.items()}
    x = np.random.default_rng(2).standard_normal((2, 12, tcfg.d_model), dtype=np.float32)
    got = tmlp.apply(tt.unit_params(tcfg, u, fields, getattr(torch, dtype)),
                     torch.as_tensor(x).to(getattr(torch, dtype)), tcfg)
    want = jmlp.apply(unit_tuple(u, fields), jnp.asarray(x, dtype), jcfg)
    close(got, want, dtype)


# ------------------------------------------------------------------ attention
def attn_pair(tcfg, dtype, seed=4):
    fields = weights.numpy_params(tcfg, seed)["main"][0]
    fields = {k: v[0] for k, v in fields.items()}
    return (unit_tuple(tt.Unit("attn"), fields),
            tt.unit_params(tcfg, tt.Unit("attn"), fields, getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0), (True, 8, 50.0),
                                                   (False, 0, 0.0)])
def test_attention_full_matches_reference(causal, window, softcap, dtype):
    jcfg, tcfg = configs("qwen3-32b", dtype, attn_softcap=softcap)  # with qk-norm
    jp, tp = attn_pair(tcfg, dtype)
    x = np.random.default_rng(5).standard_normal((2, 40, tcfg.d_model), dtype=np.float32)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = ta.apply_full(tp, tx, tcfg, window=window, is_causal=causal)
    want = ja.apply_full(jp, jnp.asarray(x, dtype), jcfg, window=window, is_causal=causal)
    close(got, want, dtype, "self-attention")
    # cross-attention (whisper's decoder): kv from an encoder output
    enc = np.random.default_rng(6).standard_normal((2, 24, tcfg.d_model), dtype=np.float32)
    tkv = ta.encode_kv(tp, torch.as_tensor(enc).to(getattr(torch, dtype)), tcfg)
    jkv = ja.encode_kv(jp, jnp.asarray(enc, dtype), jcfg)
    for t, j in zip(tkv, jkv):  # head-major in the port
        close(t, j.transpose(0, 2, 1, 3), dtype, "encode_kv")
    got = ta.apply_full(tp, tx, tcfg, is_causal=False, kv_override=tkv)
    want = ja.apply_full(jp, jnp.asarray(x, dtype), jcfg, is_causal=False, kv_override=jkv)
    close(got, want, dtype, "cross-attention")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,cache_len,window", [(20, 32, 0), (20, 32, 8),
                                                (37, 16, 8)])
def test_attention_prefill_and_decode_match_reference(S, cache_len, window, dtype):
    """Prefill into the cache (ring-rolled by S % Sc where S >= Sc), then
    decode steps that wrap the ring; outputs and caches as the JAX
    package's, with the softcap on."""
    jcfg, tcfg = configs("gemma2-2b", dtype)
    jp, tp = attn_pair(tcfg, dtype)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, S, tcfg.d_model), dtype=np.float32)
    jc = ja.init_cache(jcfg, 2, cache_len, jnp.dtype(dtype))
    tc = ta.init_cache(tcfg, 2, cache_len, dt)
    jy, jc = ja.apply_prefill(jp, jnp.asarray(x, dtype), jcfg, jc, window=window)
    ty, tc = ta.apply_prefill(tp, torch.as_tensor(x).to(dt), tcfg, tc, window=window)
    close(ty, jy, dtype, "prefill")
    close(tc.k, jc.k.transpose(0, 2, 1, 3), dtype, "prefill cache k")  # head-major
    close(tc.v, jc.v.transpose(0, 2, 1, 3), dtype, "prefill cache v")
    assert tc.pos == int(jc.pos) == S
    decode = jax.jit(lambda p, x, c: ja.apply_decode(p, x, jcfg, c, window=window))
    for step in range(12):  # past the ring's last slot in every case
        xt = rng.standard_normal((2, 1, tcfg.d_model), dtype=np.float32)
        jy, jc = decode(jp, jnp.asarray(xt, dtype), jc)
        ty, tc = ta.apply_decode(tp, torch.as_tensor(xt).to(dt), tcfg, tc, window=window)
        close(ty, jy, dtype, f"decode step {step}")
    close(tc.k, jc.k.transpose(0, 2, 1, 3), dtype, "decode cache k")
    close(tc.v, jc.v.transpose(0, 2, 1, 3), dtype, "decode cache v")
    assert tc.pos == int(jc.pos)


# ------------------------------------------------------------------ moe
def jax_dispatch(jp, x, jcfg):
    """``repro/models/moe.py:59-80`` as written, on the JAX side: each
    token's experts [T, k] and each replica's slot [T, k] (E * C where it
    was dropped), and C."""
    m = jcfg.moe
    D = x.shape[-1]
    E, k = m.n_experts, m.top_k
    flat = jcommon.rms_norm(x, jp.ln).reshape(-1, D)
    T = flat.shape[0]
    C = jmoe._capacity(T, E, k, m.capacity_factor)
    logits = jnp.einsum("td,de->te", flat.astype(jnp.float32), jp.router.astype(jnp.float32))
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    e_flat = gate_idx.reshape(-1)
    order = jnp.argsort(e_flat)
    e_sorted = e_flat[order]
    grp_start = jnp.searchsorted(e_sorted, jnp.arange(E))
    pos_in_grp = jnp.arange(T * k) - grp_start[e_sorted]
    slot = jnp.where(pos_in_grp < C, e_sorted * C + pos_in_grp, E * C)
    slot = jnp.zeros_like(slot).at[order].set(slot)  # back to replica order
    return gate_idx, slot.reshape(T, k), C


def jax_moe_routing(jp, jcfg, tokens):
    """The JAX package's prefill of ``tokens``, one unit at a time
    (``transformer.unit_apply``, jitted as its ``apply_stack`` compiles
    its scan: eager bfloat16 rounds otherwise), with each moe layer's
    dispatch: (experts [T, k], slots [T, k], C, the gap between each
    token's k-th and (k+1)-th router probability [T]) in layer order; and
    the logits of every position [B, S, V] (float32), which that routing
    gives."""
    B, S = tokens.shape
    k = jcfg.moe.top_k

    def walk(jp, tokens):
        x = jmodel.embed_tokens(jp, jcfg, tokens)
        prelude, sb, n_super, trailing = jt.block_program(jcfg)
        blocks = ([(prelude, jp["prelude"])]
                  + [(sb, jax.tree.map(lambda a: a[i], jp["main"])) for i in range(n_super)]
                  + [(trailing, jp["trailing"])])
        routes = []
        for units, ps in blocks:
            for u, p in zip(units, ps):
                if u.kind == "moe":
                    gate_idx, slot, C = jax_dispatch(p, x, jcfg)
                    flat = jcommon.rms_norm(x, p.ln).reshape(-1, x.shape[-1])
                    probs = jax.nn.softmax(flat.astype(jnp.float32) @ p.router, axis=-1)
                    top = jax.lax.top_k(probs, k + 1)[0]
                    routes.append((gate_idx, slot, top[:, k - 1] - top[:, k]))
                cache = jt.unit_cache_init(jcfg, u, B, S, x.dtype)
                x, _, _ = jt.unit_apply(u, p, x, jcfg, "prefill", cache, {})
        x = jcommon.rms_norm(x, jp["final_norm"])
        return routes, jmodel.logits_fn(jp, jcfg, x).astype(jnp.float32)

    C = jmoe._capacity(B * S, jcfg.moe.n_experts, k, jcfg.moe.capacity_factor)
    routes, logits = jax.jit(walk)(jp, tokens)
    return [(np.array(g), np.array(s), C, np.array(d)) for g, s, d in routes], \
        np.asarray(logits)


def router_gaps(routes) -> np.ndarray:
    """[T]: each token's smallest gap, over the moe layers, between its
    k-th and (k+1)-th router probability in the port's routing."""
    gaps = []
    for r in routes:
        k = r.gate_idx.shape[-1]
        top = r.probs.topk(k + 1, dim=-1).values.numpy()
        gaps.append(top[:, k - 1] - top[:, k])
    return np.min(gaps, axis=0)


def moe_pair(tcfg, dtype, seed=4):
    fields = weights.numpy_params(tcfg, seed)["main"][1]  # (attn, moe)
    fields = {k: v[0] for k, v in fields.items()}
    return (unit_tuple(tt.Unit("moe"), fields),
            tt.unit_params(tcfg, tt.Unit("moe"), fields, getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,cf", [("deepseek-moe-16b", 1.25), ("deepseek-moe-16b", 0.25),
                                     ("granite-moe-3b-a800m", 1.25),
                                     ("granite-moe-3b-a800m", 0.25)])
def test_moe_matches_reference(arch, cf, dtype):
    """moe.apply against the JAX package's: the output under TOL, the aux
    losses, and the routing, the kept slots and the dropped replicas
    exactly; at capacity factor 0.25 replicas are dropped, and granite has
    no shared experts (ws_* [D, 0])."""
    jcfg, tcfg = configs(arch, dtype)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    jp, tp = moe_pair(tcfg, dtype)
    assert tp.router.dtype == torch.float32 and tp.we_i.dtype == getattr(torch, dtype)
    x = np.random.default_rng(5).standard_normal((2, 40, tcfg.d_model), dtype=np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.as_tensor(x).to(getattr(torch, dtype))
    got, taux = tmoe.apply(tp, tx, tcfg)
    want, jaux = jmoe.apply(jp, jx, jcfg)
    close(got, want, dtype, "moe.apply")
    for name in ("lb_loss", "z_loss"):
        close(taux[name], jaux[name], "float32", name)
    gate_idx, slot, C = (np.asarray(a) for a in jax_dispatch(jp, jx, jcfg))
    r = tmoe.routing(tp, tx, tcfg)
    assert r.capacity == C
    np.testing.assert_array_equal(r.gate_idx.numpy(), gate_idx)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    dropped = int((slot == tcfg.moe.n_experts * C).sum())
    assert int(r.dropped) == dropped
    assert dropped > 0 or cf > 1.0


def ranks_routing(logits, tcfg, n: int, rank_capacity: bool = False) -> list:
    """``moe.route_rank`` on each of n simulated ranks' rows of ``logits``
    [T, E] (equal shares, in order), each given the replicas of every
    expert on the ranks before it, as the sharded layer's gather of the
    counts gives them.  ``rank_capacity``: the planted fault, each rank
    cutting the capacity over its own rows (``_route_logits`` of its
    share)."""
    rows = logits.chunk(n)
    if rank_capacity:
        return [tmoe._route_logits(part, tcfg) for part in rows]
    T, E = logits.shape
    counts = torch.stack([tmoe.expert_counts(tmoe.route_rank(part, None, T, tcfg).gate_idx, E)
                          for part in rows])
    return [tmoe.route_rank(part, counts[:i].sum(0), T, tcfg) for i, part in enumerate(rows)]


def ranks_apply(tp, x, tcfg, n: int, rank_capacity: bool = False):
    """The expert-parallel layer of ``moe.apply`` over n simulated ranks in
    one process: each rank's routing (``ranks_routing``), every rank's
    slots and weights gathered, each owner's share of the experts (the
    experts padded with empty ones to a multiple of n) filled
    (``owned_slots``, ``dispatch_owned``), run and combined
    (``combine_owned``), the owners' shares summed.  Returns (x + the mixer's output, the ranks' routings)."""
    B, S, D = x.shape
    E = tcfg.moe.n_experts
    flat = tcommon.rms_norm(x, tp.ln).reshape(-1, D)
    routes = ranks_routing(flat @ tp.router, tcfg, n, rank_capacity)
    slot = torch.cat([r.slot for r in routes])
    gate_vals = torch.cat([r.gate_vals for r in routes])
    m, C = -(-E // n), routes[0].capacity
    out = 0
    for owner in range(n):
        tok_of_slot, dest = tmoe.owned_slots(slot, owner * m, m, C, E, C)
        xe = tmoe.dispatch_owned(flat, tok_of_slot, dest).view(m, C, D)
        we = [torch.cat([w, w.new_zeros((n * m - E, *w.shape[1:]))])[owner * m:(owner + 1) * m]
              for w in (tp.we_i, tp.we_g, tp.we_o)]
        ye = (torch.nn.functional.silu(xe @ we[1]) * (xe @ we[0])) @ we[2]
        w = tmoe.owned_weights(dest, gate_vals, m * C)
        out = out + tmoe.combine_owned(ye.reshape(m * C, D) * w[:, None], dest, tok_of_slot)
    if tp.ws_i.shape[-1]:
        out = out + (torch.nn.functional.silu(flat @ tp.ws_g) * (flat @ tp.ws_i)) @ tp.ws_o
    return x + out.view(B, S, D), routes


def drops_by_expert(gate_idx, slot, E: int, C: int) -> np.ndarray:
    """[E]: each expert's dropped replicas."""
    gate_idx, slot = np.asarray(gate_idx), np.asarray(slot)
    return np.bincount(gate_idx[slot == E * C], minlength=E)


# (arch, capacity factor, router): "random" as drawn; "skewed" with experts
# 0 and 1 raised (the tokens given a common direction, the router's row of
# it raised), so that they overflow their capacity across the ranks'
# boundaries; "tied" with experts 2 and 3 given one column, raised far
# above the rest, so that every token takes both with equal probabilities
# (the order of torch.topk and of the JAX package's top_k between them may
# differ, the set may not), and two tokens equal across a boundary
RANK_ROUTING_CASES = (("deepseek-moe-16b", 1.25, "random"), ("deepseek-moe-16b", 0.25, "skewed"),
                      ("deepseek-moe-16b", 0.25, "tied"), ("granite-moe-3b-a800m", 0.25, "skewed"))


def rank_routing_case(arch, cf, router):
    """The JAX package's and the port's MoE unit of a RANK_ROUTING_CASES
    case (float32) and its input x [2, 48, D] (numpy)."""
    jcfg, tcfg = configs(arch)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=cf))
    fields = {k: v[0] for k, v in weights.numpy_params(tcfg, 4)["main"][1].items()}
    r = fields["router"].copy()
    x = np.random.default_rng(5).standard_normal((2, 48, tcfg.d_model), dtype=np.float32)
    if router != "random":  # every normed token about 7 along dim 0, which raises
        x[..., 0] += 20.0
    if router == "skewed":
        r[0, :2] += 0.3
    elif router == "tied":
        r[:, 3] = r[:, 2]
        r[0, 2:4] += 2.0
    fields["router"] = r
    x[1, 0] = x[0, -1]  # equal tokens either side of the middle
    return (jcfg, tcfg, unit_tuple(tt.Unit("moe"), fields),
            tt.unit_params(tcfg, tt.Unit("moe"), fields, torch.float32), x)


def rank_routing_errors(case, n: int, rank_capacity: bool = False) -> dict:
    """The readings of the sharded layer's routing over n simulated ranks:
    the replicas whose slot differs from ``_route_logits``' on the whole
    batch, the experts whose drops differ from the JAX package's dispatch,
    and the largest output error against the JAX package's apply over
    float32's TOL (at most 1 where within it)."""
    jcfg, tcfg, jp, tp, x = case
    got, routes = ranks_apply(tp, torch.as_tensor(x), tcfg, n, rank_capacity)
    whole = tmoe._route(tp, tcommon.rms_norm(torch.as_tensor(x), tp.ln).reshape(-1, x.shape[-1]),
                        tcfg)
    slot = torch.cat([r.slot for r in routes])
    gate_idx, jslot, C = jax_dispatch(jp, jnp.asarray(x), jcfg)
    E = tcfg.moe.n_experts
    want, _ = jmoe.apply(jp, jnp.asarray(x), jcfg)
    tol = TOL["float32"]
    err = np.abs(f32(got) - f32(want)) / (tol["atol"] + tol["rtol"] * np.abs(f32(want)))
    return {"slots_moved": int((slot != whole.slot).sum()),
            "drops_moved": int((drops_by_expert(torch.cat([r.gate_idx for r in routes]), slot,
                                                E, routes[0].capacity)
                                != drops_by_expert(gate_idx, jslot, E, C)).sum()),
            "dropped": int((slot == E * routes[0].capacity).sum()),
            "out_over_tol": float(err.max())}


@pytest.mark.parametrize("case", RANK_ROUTING_CASES, ids=lambda c: "-".join(map(str, c)))
def test_rank_routing_equals_the_whole_batch_routing(case):
    """The sharded layer's rank-local routing (``moe.route_rank``) over 2, 3
    and 4 simulated ranks, concatenated, equals ``_route_logits`` on the
    whole batch slot for slot, drops the JAX package's replicas of each
    expert, and its dispatch and combine (``owned_slots``,
    ``combine_owned``; 8 experts over 3 owners padded to 9) give the JAX
    package's ``moe.apply`` within float32's TOL.  The planted "rank-local
    capacity" (each rank cutting the capacity over its own rows) fails it
    where the case drops replicas."""
    c = rank_routing_case(*case)
    for n in (2, 3, 4):
        err = rank_routing_errors(c, n)
        print(case, n, err)
        assert err["slots_moved"] == 0 and err["drops_moved"] == 0, err
        assert err["out_over_tol"] <= 1.0, err
        assert err["dropped"] > 0 or case[1] > 1.0, err
        if err["dropped"]:
            planted = rank_routing_errors(c, n, rank_capacity=True)
            print("planted", planted)
            assert (planted["slots_moved"] and planted["drops_moved"]
                    and planted["out_over_tol"] > 1.0), planted


# ------------------------------------------------------------------ model
@contextlib.contextmanager
def planted(fault: str):
    """A fault planted in the port for the duration (a module function
    rebound): "mlstm_scaled_state" scales the carried state C0 by hd **
    -0.5 inside a chunk, as decode scales q; "slstm_no_r" drops the
    sLSTM's recurrent weights; "moe_keeps_latest" gives an expert's C
    slots to its latest tokens instead of its earliest."""
    chunk, cell, route = trec._mlstm_chunk, trec._slstm_cell, tmoe._route
    if fault == "mlstm_scaled_state":
        trec._mlstm_chunk = lambda C0, n0, q, k, v, i, logf, scale: chunk(
            C0 * scale, n0, q, k, v, i, logf, scale)
    elif fault == "slstm_no_r":
        trec._slstm_cell = lambda state, gx, r: cell(state, gx, torch.zeros_like(r))
    elif fault == "moe_keeps_latest":
        def latest_first(p, flat, cfg, experts=None):
            r = route(p, flat.flip(0), cfg, None if experts is None else experts.flip(0))
            return r._replace(**{f: getattr(r, f).flip(0) for f in
                                 ("logits", "probs", "gate_idx", "gate_vals", "slot")})
        tmoe._route = latest_first
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        trec._mlstm_chunk, trec._slstm_cell, tmoe._route = chunk, cell, route


def jax_run(jp, jcfg, jb, first, S, forced=None):
    """The JAX package's forward_train (logits, aux), prefill and two decode
    steps (jitted), the first fed ``first`` [B, 1], the second the greedy
    token, or both fed ``forced``: (forward, aux, [prefill, step 0, step
    1] logits, the decode tokens)."""
    fwd, aux = jax.jit(jmodel.forward_train, static_argnums=1)(jp, jcfg, jb)
    logits, cache = jax.jit(jmodel.prefill, static_argnums=(1, 3))(jp, jcfg, jb, S + 8)
    decode = jax.jit(jmodel.decode_step, static_argnums=1)
    out, toks = [logits], []
    for step in range(2):
        tok = first if step == 0 else np.asarray(jnp.argmax(logits, -1))[:, None]
        tok = (tok if forced is None else forced[step]).astype(np.int32)
        logits, cache = decode(jp, jcfg, jnp.asarray(tok), cache)
        out.append(logits)
        toks.append(tok)
    return fwd, aux, out, toks


def held(got, want, dtype, what, ref32=None):
    """``close``; or, given the JAX package's float32 run ``ref32``, the
    bfloat16 spread rule of BF16_SPREAD."""
    if ref32 is None:
        return close(got, want, dtype, what)
    mine, theirs = (np.abs(f32(a) - f32(ref32)) for a in (got, want))
    for stat in (np.max, np.mean):
        assert stat(mine) <= BF16_SPREAD_FACTOR * stat(theirs), \
            (what, stat.__name__, stat(mine), stat(theirs))
    print(what, "bfloat16 |error| against the JAX float32 run, max and mean: port",
          mine.max(), mine.mean(), "JAX", theirs.max(), theirs.mean())


def model_vs_reference(arch, dtype):
    """forward_train with its aux (the MoE load-balance and z-losses),
    loss_fn (against the JAX package's formula on its logits, plus its
    aux), prefill and two decode steps (the JAX side jitted), each under
    TOL or its rule (BF16_ROUTER_TIE, BF16_SPREAD); an AssertionError
    where one is broken."""
    jcfg, tcfg = configs(arch, dtype)
    jp, tp = both_params(jcfg, tcfg)
    B, S = 2, 24
    toks, (jb, tb) = inputs(tcfg, B, S)
    want, jaux, jlogits, jtoks = jax_run(jp, jcfg, jb, toks[:, S:], S)
    ref32 = [None] * 4  # the JAX package's float32 run, where BF16_SPREAD holds
    if arch in BF16_SPREAD and dtype == "bfloat16":
        r = jax_run(jp, jcfg.replace(dtype="float32"), jb, None, S, forced=jtoks)
        ref32 = [r[0]] + r[2]
    routed = arch in MOE and dtype == "bfloat16"
    got, taux = tmodel.forward_train(tp, tcfg, tb, routes=(own := []))
    kw = {}
    if routed:  # see BF16_ROUTER_TIE: the JAX package's experts, and its own where no bit decides
        jroutes, want = jax_moe_routing(jp, jcfg, jb["tokens"])
        for (g, _, _, gap), r in zip(jroutes, own):
            clear = gap >= BF16_ROUTER_TIE
            assert clear.mean() > 0.75
            np.testing.assert_array_equal(np.sort(r.gate_idx.numpy(), -1)[clear],
                                          np.sort(g, -1)[clear])
        kw["experts"] = [torch.as_tensor(g) for g, _, _, _ in jroutes]
        got, _ = tmodel.forward_train(tp, tcfg, tb, **kw)
        jlogits[0] = want[:, -1]
    held(got, want, dtype, "forward_train", ref32[0])
    close(taux, jaux, "float32", "aux")
    assert (float(jaux) > 0) == (arch in MOE)
    logits = f32(want)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    nll = lse - np.take_along_axis(logits, toks[:, 1:, None], -1)[..., 0]
    if not routed and ref32[0] is None:
        close(tmodel.loss_fn(tp, tcfg, tb)[0], nll.mean() + float(jaux), dtype, "loss")
    got, tcache = tmodel.prefill(tp, tcfg, tb, S + 8, **kw)
    held(got, jlogits[0], dtype, "prefill", ref32[1])
    for step in range(2):
        tok = torch.as_tensor(jtoks[step])
        routes = []
        got, tcache = tmodel.decode_step(tp, tcfg, tok, tcache, routes=routes)
        rows = np.ones(B, bool)
        if routed:  # B tokens, no replica dropped: leave out those at a near-tie
            assert not any(int(r.dropped) for r in routes)
            rows = router_gaps(routes) >= BF16_ROUTER_TIE
        ref = ref32[step + 2]
        held(f32(got)[rows], f32(jlogits[step + 1])[rows], dtype, f"decode step {step}",
             None if ref is None else f32(ref)[rows])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, dtype):
    """``model_vs_reference`` holds."""
    model_vs_reference(arch, dtype)


@pytest.mark.parametrize("arch,fault", [("deepseek-moe-16b", "moe_keeps_latest"),
                                        ("granite-moe-3b-a800m", "moe_keeps_latest"),
                                        ("xlstm-1.3b", "slstm_no_r")])
def test_bfloat16_rules_fail_a_planted_fault(arch, fault):
    """The bfloat16 rules of ``model_vs_reference`` (the JAX package's
    experts forced for MoE; BF16_SPREAD for xLSTM) fail a wrong unit: an
    expert's slots given to its latest tokens (the REDUCED configs drop
    replicas at their own capacity factor), the sLSTM's recurrent weights
    dropped."""
    with planted(fault), pytest.raises(AssertionError):
        model_vs_reference(arch, "bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_numpy_params_have_the_jax_layout(arch):
    """numpy_params draws the JAX package's init_params tree: the same
    structure (NamedTuple fields by name), shapes and dtypes."""
    jcfg, tcfg = configs(arch)
    want = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    got = to_jax(weights.numpy_params(tcfg, 0), jcfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(got)] == \
        [(a.shape, a.dtype) for a in jax.tree.leaves(want)]


def test_from_jax_params_takes_the_jax_tree():
    """A tree of the JAX package's NamedTuples of numpy arrays, leaves
    stacked on [n_super], carried across gives its logits."""
    jcfg, tcfg = configs("gemma2-2b")
    jp = to_jax(weights.numpy_params(tcfg, 5), jcfg)
    tp = weights.from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    _, (jb, tb) = inputs(tcfg, 2, 16)
    close(tmodel.forward_train(tp, tcfg, tb)[0], jmodel.forward_train(jp, jcfg, jb)[0],
          "float32")


@pytest.mark.parametrize("arch", DENSE + RECURRENT)
def test_decode_matches_full_forward(arch):
    """tests/test_models.py::test_decode_matches_full_forward on the port:
    prefill(S) + decode of token S equals the full forward at S + 1 (the
    KV cache and its ring, and the recurrent states, agree with the
    parallel path)."""
    _, cfg = configs(arch)
    params = tmodel.init_params(cfg, seed=1, device="cpu")
    B, S = 2, 32
    toks = torch.as_tensor(np.random.default_rng(2).integers(1, cfg.vocab, (B, S + 1)),
                           dtype=torch.int32)
    _, cache = tmodel.prefill(params, cfg, {"tokens": toks[:, :S]}, S + 8)
    dec_logits, _ = tmodel.decode_step(params, cfg, toks[:, S:S + 1], cache)
    full_logits, _ = tmodel.forward_train(params, cfg, {"tokens": toks})
    np.testing.assert_allclose(dec_logits.numpy(), full_logits[:, S].numpy(),
                               atol=2e-3, rtol=2e-3)


# ------------------------------------------------------------------ serve
@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_serve_engine_matches_reference(arch):
    """Ragged prompts, left-padded with token 1 (attended), greedy: the
    same tokens as the JAX package's ServeEngine; on gemma2 a stop token
    ends a request early in both."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg)
    rng = np.random.default_rng(8)
    lens = (13, 20, 7)
    prompts = [rng.integers(2, tcfg.vocab, n).astype(np.int32) for n in lens]
    runs = []
    for eng_mod, cfg, params, kw in ((jengine, jcfg, jp, {}),
                                     (tengine, tcfg, tp, {"device": "cpu"})):
        eng = eng_mod.ServeEngine(cfg, params, batch_size=4, max_len=40, **kw)
        eng.admit([eng_mod.Request(i, p, 12) for i, p in enumerate(prompts)])
        runs.append([r.out_tokens for r in eng.run()])
    assert runs[0] == runs[1]
    assert all(len(t) == 12 for t in runs[1])
    if arch != "gemma2-2b":
        return
    stop = runs[0][1][4]  # a token the second request emits
    out = []
    for eng_mod, cfg, params, kw in ((jengine, jcfg, jp, {}),
                                     (tengine, tcfg, tp, {"device": "cpu"})):
        eng = eng_mod.ServeEngine(cfg, params, batch_size=4, max_len=40, stop_token=stop,
                                  **kw)
        eng.admit([eng_mod.Request(i, p, 12) for i, p in enumerate(prompts)])
        out.append([r.out_tokens for r in eng.run()])
    assert out[0] == out[1] and len(out[1][1]) <= 5


def test_serve_steps_are_the_engines():
    """compare.serve_steps, greedy, gives ServeEngine's tokens; fed those
    tokens it gives the same logits (0 off by logit_agreement), with the
    plain attention asked for or not (the CPU runs it either way)."""
    _, tcfg = configs("gemma2-2b")
    tp = weights.from_jax_params(weights.numpy_params(tcfg, 0), tcfg, device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, tcfg.vocab, n).astype(np.int32) for n in (11, 19)]
    eng = tengine.ServeEngine(tcfg, tp, batch_size=2, max_len=30, device="cpu")
    eng.admit([tengine.Request(i, p, 8) for i, p in enumerate(prompts)])
    engine_tokens = [r.out_tokens for r in eng.run()]
    tokens, logits = compare.serve_steps(tp, tcfg, prompts, 30, 8)
    assert tokens.t().tolist() == engine_tokens
    for plain in (False, True):
        _, forced = compare.serve_steps(tp, tcfg, prompts, 30, 8, forced=tokens, plain=plain)
        err, rms = compare.logit_agreement(forced, logits, tokens, top=None)
        assert err == 0.0 and rms.shape == (8, 2)
        assert compare.logit_agreement(forced, logits, tokens)[0] == 0.0


def test_tokens_are_compared_up_to_the_first_near_tie():
    """A step whose margin is under NEAR_TIE * tol * RMS ends the
    comparison of its request; a request with none is compared throughout;
    logit_agreement reads only the top ids and the greedy token unless
    asked for the whole row."""
    tol, rms = 0.1, torch.ones(4, 3)
    margin = torch.tensor([[1.0, 1.0, 0.3], [0.39, 1.0, 1.0], [1.0, 0.41, 0.1], [0.0, 1.0, 1.0]])
    assert compare.tokens_before_near_tie(margin, rms, tol) == [1, 4, 0]
    ref = torch.tensor([[[5.0, 1.0, 0.0, -1.0]]])
    got = ref + torch.tensor([[[0.0, 0.0, 0.0, 2.0]]])
    tok = torch.tensor([[0]])
    assert compare.logit_agreement(got, ref, tok, top=2)[0] == 0.0
    err, _ = compare.logit_agreement(got, ref, tok, top=None)
    assert err == pytest.approx(2.0 / float(ref.norm() / 2.0))
    assert compare.margins(ref).tolist() == [[4.0]]


def test_serve_steps_probe_the_moe_dispatch():
    """serve_steps' ``routes`` record each step's moe dispatches (the
    prefill's T = B * S tokens, then B a step); ``route_as`` those routes
    gives the same logits bit for bit, and the experts of another run
    other logits."""
    _, tcfg = configs("deepseek-moe-16b")
    tp = weights.from_jax_params(weights.numpy_params(tcfg, 0), tcfg, device="cpu")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(2, tcfg.vocab, n).astype(np.int32) for n in (9, 14)]
    routes = []
    tokens, logits = compare.serve_steps(tp, tcfg, prompts, 24, 4, routes=routes)
    assert len(routes) == 4 and all(len(r) == tcfg.n_layers for r in routes)
    assert routes[0][0].gate_idx.shape == (2 * 14, tcfg.moe.top_k)
    assert routes[1][0].gate_idx.shape == (2, tcfg.moe.top_k)
    _, again = compare.serve_steps(tp, tcfg, prompts, 24, 4, forced=tokens, route_as=routes)
    assert torch.equal(again, logits)
    moved = [[r._replace(gate_idx=(r.gate_idx + 1) % tcfg.moe.n_experts) for r in step]
             for step in routes]
    _, other = compare.serve_steps(tp, tcfg, prompts, 24, 4, forced=tokens, route_as=moved)
    assert float((other - logits).abs().max()) > 1e-2


UNIT_FAULT = {"mlstm": "mlstm_scaled_state", "slstm": "slstm_no_r"}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_unit_rule_holds_and_fails_a_planted_fault(kind, dtype):
    """chip_smoke phase 14's rule for xlstm-1.3b's units at the REDUCED
    width: ``compare.unit_outputs`` (512 tokens from the empty cache, two
    mLSTM chunks, then 4 decode steps) within ``compare.UNIT_TOL`` of the
    JAX package's float32 unit fed the same input, and outside it with
    the unit's planted fault."""
    jcfg, tcfg = configs("xlstm-1.3b", dtype)
    _, sb, _, _ = tt.block_program(tcfg)
    j = [u.kind for u in sb].index(kind)
    fields = {k: v[0] for k, v in weights.numpy_params(tcfg, 0)["main"][j].items()}
    x, xd = compare.unit_inputs(7, 2, 512, 4, tcfg.d_model)
    want = jax_unit_outputs(kind, unit_tuple(sb[j], fields), jcfg.replace(dtype="float32"),
                            x, xd)
    rms = np.sqrt((want.astype(np.float64) ** 2).mean(-1))
    p = tt.unit_params(tcfg, sb[j], fields, getattr(torch, dtype))
    lim = compare.UNIT_TOL[dtype]

    def errors():
        return compare.unit_errors(compare.unit_outputs(kind, p, tcfg, x, xd).numpy(), want,
                                   rms)
    errs = errors()
    assert errs["max"] <= lim["max"] and errs["mean"] <= lim["mean"], errs
    with planted(UNIT_FAULT[kind]):
        errs = errors()
    assert errs["max"] > lim["max"] or errs["mean"] > lim["mean"], errs


# ------------------------------------------------------- the phase 12 reference
# chip_smoke.py phase 12: gemma2-2b at full width, cut to 4 layers (two
# local/global superblocks) and a 256-token window, so that the local
# caches (min(632, 2 * 256) = 512 slots) take the ring roll in prefill and
# wrap in decode
SERVE_CASE = {"arch": "gemma2-2b", "replace": {"n_layers": 4, "local_window": 256},
              "weights_seed": 0, "prompt_seed": 1, "prompt_lens": [384, 600],
              "max_new_tokens": 32, "max_len": 632, "top": 8}


def serve_case_prompts(case) -> list:
    rng = np.random.default_rng(case["prompt_seed"])
    vocab = treg.get_config(case["arch"]).vocab
    return [rng.integers(2, vocab, n).astype(np.int32) for n in case["prompt_lens"]]


def step_record(logits: np.ndarray, top: int) -> dict:
    """Per request: the greedy token, the top ids and values, the logit at
    the token, the row's norm and the top-1/top-2 margin."""
    ids = np.argsort(-logits, axis=-1, kind="stable")[:, :top]
    vals = np.take_along_axis(logits, ids, -1)
    tok = logits.argmax(-1)
    return {"token": tok.tolist(), "top_ids": ids.tolist(), "top_values": vals.tolist(),
            "chosen_logit": logits[np.arange(len(tok)), tok].tolist(),
            "norm": np.linalg.norm(logits, axis=-1).tolist(),
            "margin": (vals[:, 0] - vals[:, 1]).tolist()}


def jax_logits(jp, jcfg, case, prompts, forced=None) -> np.ndarray:
    """The JAX package's greedy serving of the case, step by step, as
    ServeEngine.admit and ServeEngine.step run it (eager prefill, jitted
    decode), or fed ``forced`` tokens [steps, B]: float32 logits [steps, B,
    V] on the host."""
    logits, cache = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(
        tengine.pad_prompts(prompts))}, case["max_len"])
    decode = jax.jit(lambda p, t, c: jmodel.decode_step(p, jcfg, t, c))
    out = []
    for s in range(case["max_new_tokens"]):
        out.append(np.asarray(jnp.asarray(logits, jnp.float32)))
        if s == case["max_new_tokens"] - 1:
            break
        tok = out[-1].argmax(-1) if forced is None else forced[s]
        logits, cache = decode(jp, jnp.asarray(tok, jnp.int32)[:, None], cache)
    return np.stack(out)


def jax_serve(jp, jcfg, case, prompts) -> list:
    """``jax_logits``' greedy run as ``step_record``s."""
    return [step_record(host, case["top"]) for host in jax_logits(jp, jcfg, case, prompts)]


def at_top(logits: np.ndarray, steps: list) -> tuple[np.ndarray, np.ndarray]:
    """``logits`` [steps, B, V] at each step's top ids [steps, B, top] and
    its greedy token [steps, B]."""
    ids = np.asarray([s["top_ids"] for s in steps])
    tok = np.asarray([s["token"] for s in steps])
    return (np.take_along_axis(logits, ids, -1),
            np.take_along_axis(logits, tok[..., None], -1)[..., 0])


def float32_run(jp, jcfg, case, prompts, steps) -> dict:
    """The JAX package's float32 run of a bfloat16 case, fed the bfloat16
    run's tokens, at that run's top ids and greedy token (``top_values``,
    ``chosen_logit``), and the bfloat16 run's largest distance from it over
    the row's RMS (``bfloat16_max_err_over_rms``): how far bfloat16
    rounding takes the JAX package's own run."""
    tokens = np.asarray([s["token"] for s in steps])
    rms = np.asarray([s["norm"] for s in steps]) / jcfg.vocab ** 0.5
    up = jax_logits(jp, jcfg.replace(dtype="float32"), case, prompts, forced=tokens)
    vals, at_tok = at_top(up, steps)
    err = max(float(np.max(np.abs(vals - np.asarray([s["top_values"] for s in steps]))
                           / rms[..., None])),
              float(np.max(np.abs(at_tok - np.asarray([s["chosen_logit"] for s in steps]))
                           / rms)))
    return {"top_values": vals.tolist(), "chosen_logit": at_tok.tolist(),
            "bfloat16_max_err_over_rms": err}


# chip_smoke.py phase 14: the moe, hybrid and ssm architectures at full
# width, cut in depth (listed in "replace"): two layers of each MoE
# config; one (R, R, A) superblock of recurrentgemma-9b with a 256-token
# window, so that its local cache (512 slots) takes the ring roll in
# prefill and wraps in decode; one 7:1 superblock of xlstm-1.3b, whose
# prompts pad to 512 so that the mLSTM carries its state across two
# chunks.  The shorter prompt of each case is left-padded (token 1): 216
# identical pad tokens send their replicas to the same experts, past
# capacity, so the MoE cases drop replicas in the JAX package's run.
#
# Their bfloat16 runs are held to the JAX package's float32 run
# ("float32_run"): the JAX package's own bfloat16 runs lie 0.13-0.20 of a
# row's RMS from it, so two right bfloat16 runs may differ by more than
# SERVE_TOL.  xlstm-1.3b's whole bfloat16 runs are noise (the JAX
# package's lies 1.8 of a row's RMS from its float32 run): its first mLSTM
# and its sLSTM are held unit by unit instead ("units": 512 tokens from
# the empty cache, two mLSTM chunks, then 4 decode steps; sampled at the
# first 8 tokens of each chunk, where the carried state weighs most, 16
# other tokens and every decode step, and 32 columns).
FAMILIES_CASES = [
    dict(SERVE_CASE, arch="deepseek-moe-16b", replace={"n_layers": 2}, float32_run=True),
    dict(SERVE_CASE, arch="granite-moe-3b-a800m", replace={"n_layers": 2}, float32_run=True),
    dict(SERVE_CASE, arch="recurrentgemma-9b", replace={"n_layers": 3, "local_window": 256},
         float32_run=True),
    dict(SERVE_CASE, arch="xlstm-1.3b", replace={"n_layers": 8}, prompt_lens=[384, 512],
         max_len=544, units={"layers": [0, 7], "input_seed": 7, "batch": 2, "seq": 512,
                             "decode_steps": 4, "sample_seed": 8, "chunk_head": 8,
                             "other_rows": 16, "cols": 32}),
]
# a JAX router gap (k-th minus (k+1)-th probability) under this is a
# near-tie, where float32 sums in another order may route otherwise
ROUTER_NEAR_TIE = 1e-5


def moe_record(routes, n_experts: int) -> list:
    """Per moe layer of a prefill: the replicas dropped, each token's
    experts (by falling probability) and the tokens at a near-tie."""
    return [{"dropped": int((slot == n_experts * C).sum()), "experts": gate_idx.tolist(),
             "near_ties": np.nonzero(gap < ROUTER_NEAR_TIE)[0].tolist(),
             "min_gap": float(gap.min())} for gate_idx, slot, C, gap in routes]


def serve_case(case) -> dict:
    """The JAX package serving ``case`` in float32 and bfloat16 (its
    ServeEngine's tokens checked equal to the step-by-step run), with the
    MoE routing of its prefill, and the port on the CPU against it
    (printed, for PERF.md).  Where ``case["float32_run"]``, the bfloat16
    run's float32 counterpart (``float32_run``) too; where
    ``case["units"]``, its units fed one input (``units_reference``)."""
    prompts = serve_case_prompts(case)
    out = {"case": case, "prompts": [p.tolist() for p in prompts], "runs": {}}
    for dtype in DTYPES:
        jcfg = jreg.get_config(case["arch"]).replace(dtype=dtype, **case["replace"])
        tcfg = treg.get_config(case["arch"]).replace(dtype=dtype, **case["replace"])
        tree = weights.numpy_params(tcfg, case["weights_seed"])
        jp = to_jax(tree, jcfg)
        t0 = time.time()
        steps = jax_serve(jp, jcfg, case, prompts)
        eng = jengine.ServeEngine(jcfg, jp, batch_size=len(prompts), max_len=case["max_len"])
        eng.admit([jengine.Request(i, p, case["max_new_tokens"]) for i, p in enumerate(prompts)])
        engine_tokens = [r.out_tokens for r in eng.run()]
        tokens = [s["token"] for s in steps]
        same = engine_tokens == [list(t) for t in zip(*tokens)]
        print(f"{case['arch']} {dtype}: JAX {time.time() - t0:.0f} s, ServeEngine's tokens "
              f"equal: {same}", flush=True)
        assert same, "the step-by-step run is not the JAX package's ServeEngine"
        out["runs"][dtype] = steps
        del eng
        toks = tengine.pad_prompts(prompts)
        if tcfg.family == "moe":
            out.setdefault("moe", {})[dtype] = moe_record(
                jax_moe_routing(jp, jcfg, jnp.asarray(toks))[0], jcfg.moe.n_experts)
            print(f"  JAX dropped per layer {[r['dropped'] for r in out['moe'][dtype]]}, "
                  f"near-ties {[len(r['near_ties']) for r in out['moe'][dtype]]}", flush=True)
            assert all(r["dropped"] > 0 for r in out["moe"][dtype])
        ref = {"top_values": [s["top_values"] for s in steps],
               "chosen_logit": [s["chosen_logit"] for s in steps]}
        if dtype == "bfloat16" and case.get("float32_run"):
            ref = out["float32_run"] = float32_run(jp, jcfg, case, prompts, steps)
            print(f"  the JAX bfloat16 run lies {ref['bfloat16_max_err_over_rms']:.3e} of the "
                  f"row's RMS from its float32 run", flush=True)
        del jp
        # the port on the CPU against it (recorded in PERF.md)
        tp = weights.from_jax_params(tree, tcfg, device="cpu")
        routes = []
        _, got = compare.serve_steps(tp, tcfg, prompts, case["max_len"], len(tokens),
                                     forced=torch.as_tensor(np.asarray(tokens, np.int32)),
                                     routes=routes)
        vals, at_tok = at_top(got.numpy(), steps)
        rms = np.asarray([s["norm"] for s in steps]) / tcfg.vocab ** 0.5
        err = max(float(np.max(np.abs(vals - np.asarray(ref["top_values"])) / rms[..., None])),
                  float(np.max(np.abs(at_tok - np.asarray(ref["chosen_logit"])) / rms)))
        margin = min(min(s["margin"]) for s in steps)
        print(f"  port on the CPU, teacher-forced, largest |error| / row RMS over the "
              f"top-{case['top']} logits and the greedy token {err:.3e} against the JAX "
              f"{'float32' if ref is out.get('float32_run') else dtype} run (tolerance "
              f"{compare.SERVE_TOL[dtype]}); smallest JAX margin {margin:.3e}", flush=True)
        if tcfg.family == "moe":
            for layer, (rec, r) in enumerate(zip(out["moe"][dtype], routes[0])):
                moved = (np.sort(rec["experts"], -1) != np.sort(r.gate_idx.numpy(), -1)).any(-1)
                print(f"  layer {layer}: dropped {int(r.dropped)} (JAX {rec['dropped']}), "
                      f"tokens routed otherwise {int(moved.sum())}, of which at a JAX "
                      f"near-tie {len(set(np.nonzero(moved)[0]) & set(rec['near_ties']))}",
                      flush=True)
        del tp, routes
    if case.get("units"):
        out["units"] = units_reference(case, tree)
    return out


def jax_unit_outputs(kind: str, jp, jcfg, x, xd) -> np.ndarray:
    """``compare.unit_outputs`` on the JAX package's unit (jitted)."""
    apply = {"mlstm": jrec.mlstm_apply, "slstm": jrec.slstm_apply}[kind]
    dt = jnp.dtype(jcfg.dtype)
    y, cache = jax.jit(lambda p, x: apply(p, x, jcfg))(jp, jnp.asarray(x, dt))
    out = [np.asarray(y.astype(jnp.float32)) - x]
    step = jax.jit(lambda p, x, c: apply(p, x, jcfg, c, decode=True))
    for xt in xd:
        y, cache = step(jp, jnp.asarray(xt, dt), cache)
        out.append(np.asarray(y.astype(jnp.float32)) - xt)
    return np.concatenate([o.reshape(-1, x.shape[-1]) for o in out])


def units_reference(case, tree) -> dict:
    """``case["units"]``: the units of ``tree`` at ``layers`` (of the main
    superblock) fed ``compare.unit_inputs`` (a prefill from the empty
    cache, then decode steps), in the JAX package: its float32 outputs less
    the input at the sampled rows and columns, each row's RMS over all
    columns, its own bfloat16 run's errors against them
    (``compare.unit_errors``); and the port's on the CPU, without and with
    the fault planted for the unit (``planted``)."""
    u = case["units"]
    jcfg = jreg.get_config(case["arch"]).replace(**case["replace"])
    tcfg = treg.get_config(case["arch"]).replace(**case["replace"])
    _, sb, _, _ = tt.block_program(tcfg)
    B, S, steps, D = u["batch"], u["seq"], u["decode_steps"], tcfg.d_model
    x, xd = compare.unit_inputs(u["input_seed"], B, S, steps, D)
    rng = np.random.default_rng(u["sample_seed"])
    heads = [s for c in range(0, S, trec.MLSTM_CHUNK) for s in range(c, c + u["chunk_head"])]
    others = rng.choice(sorted(set(range(S)) - set(heads)), u["other_rows"], replace=False)
    pos = sorted(heads + others.tolist())
    rows = [b * S + s for b in range(B) for s in pos] + list(range(B * S, B * S + steps * B))
    cols = sorted(rng.choice(D, u["cols"], replace=False).tolist())
    out = {"rows": rows, "cols": cols, "layers": []}
    for j in u["layers"]:
        unit = sb[j]
        fields = {k: v[0] for k, v in tree["main"][j].items()}
        jax_runs = {dtype: jax_unit_outputs(unit.kind, unit_tuple(unit, fields),
                                            jcfg.replace(dtype=dtype), x, xd)[rows]
                    for dtype in DTYPES}
        want = jax_runs["float32"]
        rms = np.sqrt((want.astype(np.float64) ** 2).mean(-1))
        want = want[:, cols]
        rec = {"kind": unit.kind, "layer": j, "float32": want.tolist(), "rms": rms.tolist(),
               "jax_bfloat16": compare.unit_errors(jax_runs["bfloat16"][:, cols], want, rms),
               "port_cpu": {}, "planted_cpu": {}}
        fault = UNIT_FAULT[unit.kind]
        for dtype in DTYPES:
            cfg = tcfg.replace(dtype=dtype)
            p = tt.unit_params(cfg, unit, fields, getattr(torch, dtype))

            def port():
                got = compare.unit_outputs(unit.kind, p, cfg, x, xd)[rows][:, cols]
                return compare.unit_errors(got.numpy(), want, rms)
            rec["port_cpu"][dtype] = port()
            with planted(fault):
                rec["planted_cpu"][dtype] = {"fault": fault, **port()}
        print(f"  {unit.kind} (layer {j}): JAX bfloat16 {rec['jax_bfloat16']}, port on the "
              f"CPU {rec['port_cpu']}, with {fault} {rec['planted_cpu']} (limits "
              f"{compare.UNIT_TOL})", flush=True)
        out["layers"].append(rec)
    return out


def commit() -> str:
    return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                          text=True).stdout.strip()


def write_serve_reference() -> None:
    t_start = time.time()
    run = serve_case(SERVE_CASE)
    REFERENCE.write_text(json.dumps({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_models.py "
                   "--write-serve-reference",
        "source": "repro.models.model.prefill / decode_step as repro.serve.engine."
                  "ServeEngine runs them (greedy; its tokens checked equal), JAX package "
                  "on the CPU, weights repro_torch.models.weights.numpy_params",
        "commit": commit(), "backend": "cpu", **run, "wall_s": time.time() - t_start}) + "\n")


def write_families_reference() -> None:
    t_start = time.time()
    cases = [serve_case(case) for case in FAMILIES_CASES]
    FAMILIES_REFERENCE.write_text(json.dumps({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_models.py "
                   "--write-families-reference",
        "source": "repro.models.model.prefill / decode_step as repro.serve.engine."
                  "ServeEngine runs them (greedy; its tokens checked equal), JAX package "
                  "on the CPU, weights repro_torch.models.weights.numpy_params; moe: each "
                  "prefill layer's dispatch (repro/models/moe.py:59-80) as "
                  "tests/test_torch_models.py::jax_moe_routing walks it: replicas dropped, "
                  "each token's experts, the tokens whose k-th and (k+1)-th router "
                  f"probabilities lie under {ROUTER_NEAR_TIE} apart",
        "commit": commit(), "backend": "cpu", "cases": cases,
        "wall_s": time.time() - t_start}) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-serve-reference"]:
        write_serve_reference()
    elif sys.argv[1:] == ["--write-families-reference"]:
        write_families_reference()
    else:
        sys.exit("usage: test_torch_models.py --write-serve-reference | "
                 "--write-families-reference")
