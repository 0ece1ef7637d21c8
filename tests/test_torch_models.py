"""The port's model stack and serving engine against the JAX package's, on
the CPU: configs, the ported modules (common, mlp, attention), the model
(forward_train, loss_fn, prefill, decode_step) and ServeEngine, at the
REDUCED configs of the dense, vlm and audio families.

Weights come from ``repro_torch.models.weights.numpy_params``: the same
numpy arrays go through ``from_jax_params`` into the port and through
``jnp.asarray`` into the JAX package's own NamedTuples.  On CPU tensors
the port's attention runs the flash kernel's plain version.

Run as a script, it writes ``src/repro_torch/models/serve_reference.json``
(the JAX package serving chip_smoke.py phase 12's case: gemma2-2b at full
width, 4 layers, window 256; about 0.9 B float32 parameters, minutes on
8 cores) and prints the port's CPU differences against it:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_models.py --write-serve-reference
"""
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
from repro.models import model as jmodel, transformer as jt  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as ta, common as tcommon, mlp as tmlp  # noqa: E402
from repro_torch.models import model as tmodel, transformer as tt, weights  # noqa: E402
from repro_torch.serve import compare, engine as tengine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "src" / "repro_torch" / "models" / "serve_reference.json"

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
DTYPES = tuple(TOL)
# the dense, vlm and audio families (moe, ssm and hybrid wait: ROADMAP.md)
ARCHS = ("gemma2-2b", "qwen3-32b", "granite-3-8b", "nemotron-4-15b", "internvl2-26b",
         "whisper-large-v3")
DENSE = ("gemma2-2b", "qwen3-32b", "granite-3-8b", "nemotron-4-15b")
NOT_PORTED = ("deepseek-moe-16b", "granite-moe-3b-a800m", "xlstm-1.3b", "recurrentgemma-9b")


def configs(arch, dtype="float32", **kw):
    """The JAX package's and the port's REDUCED config, alike."""
    return (jreg.get_config(arch, reduced=True).replace(dtype=dtype, **kw),
            treg.get_config(arch, reduced=True).replace(dtype=dtype, **kw))


def unit_tuple(u, fields):
    cls = ja.AttnParams if u.kind in ("attn", "cross") else jmlp.MLPParams
    return cls(**{k: jnp.asarray(v) for k, v in fields.items()})


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


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, dtype):
    """forward_train (and loss_fn, against the JAX package's formula on its
    logits), prefill and two decode steps (the JAX side jitted)."""
    jcfg, tcfg = configs(arch, dtype)
    jp, tp = both_params(jcfg, tcfg)
    B, S = 2, 24
    toks, (jb, tb) = inputs(tcfg, B, S)
    got, _ = tmodel.forward_train(tp, tcfg, tb)
    want, _ = jax.jit(jmodel.forward_train, static_argnums=1)(jp, jcfg, jb)
    close(got, want, dtype, "forward_train")
    logits = f32(want)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    nll = lse - np.take_along_axis(logits, toks[:, 1:, None], -1)[..., 0]
    close(tmodel.loss_fn(tp, tcfg, tb)[0], nll.mean(), dtype, "loss")
    got, tcache = tmodel.prefill(tp, tcfg, tb, S + 8)
    want, jcache = jax.jit(jmodel.prefill, static_argnums=(1, 3))(jp, jcfg, jb, S + 8)
    close(got, want, dtype, "prefill")
    decode = jax.jit(jmodel.decode_step, static_argnums=1)
    for step in range(2):
        tok = toks[:, S:] if step == 0 else np.asarray(jnp.argmax(want, -1))[:, None]
        tok = tok.astype(np.int32)
        got, tcache = tmodel.decode_step(tp, tcfg, torch.as_tensor(tok), tcache)
        want, jcache = decode(jp, jcfg, jnp.asarray(tok), jcache)
        close(got, want, dtype, f"decode step {step}")


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


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_full_forward(arch):
    """tests/test_models.py::test_decode_matches_full_forward on the port:
    prefill(S) + decode of token S equals the full forward at S + 1 (the
    KV cache and its ring agree with the parallel path)."""
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
@pytest.mark.parametrize("arch", DENSE)
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


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_families_raise(arch):
    _, cfg = configs(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        weights.numpy_params(cfg, 0)


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


def jax_serve(jp, jcfg, case, prompts) -> list:
    """The JAX package's greedy serving of the case, step by step: as
    ServeEngine.admit and ServeEngine.step (eager prefill, jitted decode)."""
    logits, cache = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(
        tengine.pad_prompts(prompts))}, case["max_len"])
    decode = jax.jit(lambda p, t, c: jmodel.decode_step(p, jcfg, t, c))
    steps = []
    for _ in range(case["max_new_tokens"]):
        host = np.asarray(jnp.asarray(logits, jnp.float32))
        steps.append(step_record(host, case["top"]))
        if len(steps) == case["max_new_tokens"]:
            break
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, cache = decode(jp, tok, cache)
    return steps


def write_serve_reference() -> None:
    case = SERVE_CASE
    prompts = serve_case_prompts(case)
    runs, t_start = {}, time.time()
    for dtype in DTYPES:
        jcfg = jreg.get_config(case["arch"]).replace(dtype=dtype, **case["replace"])
        tcfg = treg.get_config(case["arch"]).replace(dtype=dtype, **case["replace"])
        tree = weights.numpy_params(tcfg, case["weights_seed"])
        jp = to_jax(tree, jcfg)
        del tree
        t0 = time.time()
        steps = jax_serve(jp, jcfg, case, prompts)
        eng = jengine.ServeEngine(jcfg, jp, batch_size=len(prompts), max_len=case["max_len"])
        eng.admit([jengine.Request(i, p, case["max_new_tokens"]) for i, p in enumerate(prompts)])
        engine_tokens = [r.out_tokens for r in eng.run()]
        tokens = [s["token"] for s in steps]
        same = engine_tokens == [list(t) for t in zip(*tokens)]
        print(f"{dtype}: JAX {time.time() - t0:.0f} s, ServeEngine's tokens equal: {same}",
              flush=True)
        assert same, "the step-by-step run is not the JAX package's ServeEngine"
        runs[dtype] = steps
        del jp, eng
        # the port on the CPU against it (recorded in PERF.md)
        tp = weights.from_jax_params(weights.numpy_params(tcfg, case["weights_seed"]), tcfg,
                                     device="cpu")
        _, got = compare.serve_steps(tp, tcfg, prompts, case["max_len"], len(tokens),
                                     forced=torch.as_tensor(np.asarray(tokens, np.int32)))
        got = got.numpy()
        err = max(float(np.max(np.abs(
            g[np.arange(len(prompts))[:, None], np.asarray(s["top_ids"])]
            - np.asarray(s["top_values"])) / np.asarray(s["norm"])[:, None]))
            for g, s in zip(got, steps))
        margin = min(min(s["margin"]) for s in steps)
        print(f"{dtype}: port on the CPU, teacher-forced, largest |error| / row norm "
              f"over the top-{case['top']} logits {err:.3e}; smallest JAX margin "
              f"{margin:.3e}; row norms {min(min(s['norm']) for s in steps):.1f}-"
              f"{max(max(s['norm']) for s in steps):.1f}", flush=True)
        del tp
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip()
    REFERENCE.write_text(json.dumps({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_models.py "
                   "--write-serve-reference",
        "source": "repro.models.model.prefill / decode_step as repro.serve.engine."
                  "ServeEngine runs them (greedy; its tokens checked equal), JAX package "
                  "on the CPU, weights repro_torch.models.weights.numpy_params",
        "commit": commit, "backend": "cpu", "case": case,
        "prompts": [p.tolist() for p in prompts], "runs": runs,
        "wall_s": time.time() - t_start}) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-serve-reference"]:
        write_serve_reference()
    else:
        sys.exit("usage: test_torch_models.py --write-serve-reference")
