"""The port's models under autograd against the JAX package's, on the CPU:
loss and gradients of every architecture's REDUCED config in float32
against ``jax.value_and_grad(model.loss_fn)`` (the MoE aux losses
included), remat against none, the chunked attention above ``Q_CHUNK``
against the JAX package's ``_sdpa_chunked``, trainable masters, and the
flash kernel's refusal of inputs that autograd records.

Weights come from ``weights.numpy_params`` through ``from_jax_params(...,
trainable=True)`` into the port and through ``test_torch_models.to_jax``
into the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ja, model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.kernels import flash_attention as fa, ops  # noqa: E402
from repro_torch.models import attention as ta, model as tmodel, weights  # noqa: E402
from test_torch_models import ARCHS, configs, f32, inputs, to_jax  # noqa: E402

# Gradients of the two packages in float32, each leaf held by the norm of
# the difference over the norm of the JAX package's gradient: the sums run
# in another order (the REDUCED models read 6e-7 to 1.1e-6, xlstm-1.3b's
# conv_w 7.8e-5: its exponential gates amplify rounding); a wrong term or
# a missing path moves a leaf by its whole size.
GRAD_REL = 3e-4
LOSS_REL = 1e-5


def jax_grads(jcfg, jp, jb):
    """(loss, aux metrics, leaf id -> gradient) of the JAX package."""
    (loss, aux), g = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))(jp, jb)
    flat = {jckpt._leaf_id(path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(g)[0]}
    return float(loss), {k: float(v) for k, v in aux.items()}, flat


def port_grads(tcfg, tp, tb):
    """(loss, metrics, leaf name -> gradient in the JAX layout) of the port;
    a leaf the loss does not read has a zero gradient, as in JAX."""
    loss, metrics = tmodel.loss_fn(tp, tcfg, tb)
    loss.backward()
    grads = weights.stacked(
        (name, i, (torch.zeros_like(p) if p.grad is None else p.grad).numpy())
        for name, i, p in weights.leaves(tp))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg = configs(arch)
    tree = weights.numpy_params(tcfg, 0)
    _, (jb, tb) = inputs(tcfg, 2, 16)
    jl, jm, jg = jax_grads(jcfg, to_jax(tree, jcfg), jb)
    tl, tm, tg = port_grads(tcfg, weights.from_jax_params(tree, tcfg, "cpu", trainable=True),
                            tb)
    assert abs(tl - jl) <= LOSS_REL * abs(jl)
    for k in ("nll", "aux"):
        assert abs(tm[k] - jm[k]) <= LOSS_REL * max(abs(jm[k]), 1e-3), (k, tm[k], jm[k])
    if tcfg.family == "moe":
        assert jm["aux"] > 0  # the load-balance and z-losses take part
    assert set(tg) == set(jg)
    errs = {k: rel(tg[k], jg[k]) for k in jg}
    assert max(errs.values()) <= GRAD_REL, max(errs.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("remat", ("full", "dots"))
@pytest.mark.parametrize("arch", ("gemma2-2b", "deepseek-moe-16b", "recurrentgemma-9b",
                                  "whisper-large-v3"))
def test_remat_is_bit_identical(arch, remat):
    _, tcfg = configs(arch)
    tree = weights.numpy_params(tcfg, 0)
    _, (_, tb) = inputs(tcfg, 2, 16)
    runs = [port_grads(c, weights.from_jax_params(tree, c, "cpu", trainable=True), tb)
            for c in (tcfg, tcfg.replace(remat=remat))]
    (l0, m0, g0), (l1, m1, g1) = runs
    assert l0 == l1 and m0 == m1
    assert all(np.array_equal(g0[k], g1[k]) for k in g0)


def test_remat_recomputes_in_the_backward_pass():
    """"full" keeps only each superblock's input: the backward pass runs
    the superblock's forward again (counted at its MLP)."""
    from repro_torch.models import mlp

    _, tcfg = configs("granite-3-8b")
    tree = weights.numpy_params(tcfg, 0)
    _, (_, tb) = inputs(tcfg, 1, 8)
    calls = []
    orig = mlp.apply

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    for remat, want in (("none", tcfg.n_layers), ("full", 2 * tcfg.n_layers)):
        calls.clear()
        c = tcfg.replace(remat=remat)
        mlp.apply = counted
        try:
            port_grads(c, weights.from_jax_params(tree, c, "cpu", trainable=True), tb)
        finally:
            mlp.apply = orig
        assert len(calls) == want, (remat, len(calls))


def attn_case(S, window, seed=3):
    """A causal self-attention unit above Q_CHUNK (D 32, 4 query heads and
    2 KV heads of 16, q_chunk 128): the JAX params, the port's trainable
    ones, x and a cotangent."""
    jcfg, tcfg = configs("gemma2-2b", d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
                         q_chunk=128)
    rng = np.random.default_rng(seed)
    fields = {name: rng.standard_normal(f.shape, dtype=np.float32)
              * np.float32((1.0 / max(f.fan_in, 1)) ** 0.5 if f.init == "dense" else 0.1)
              for name, f in ta.shapes(tcfg).items()}
    x = rng.standard_normal((2, S, 32), dtype=np.float32)
    ct = rng.standard_normal((2, S, 32), dtype=np.float32)
    jp = ja.AttnParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = ta.AttnParams(ta.shapes(tcfg), torch.float32, "cpu", master=torch.float32,
                       **{k: torch.from_numpy(v) for k, v in fields.items()})
    return jcfg, tcfg, jp, tp, x, ct


@pytest.mark.parametrize("window", (0, 200))
def test_apply_full_above_q_chunk_matches_reference(window):
    """S = 1,152 > Q_CHUNK: the JAX package's apply_full takes
    _sdpa_chunked in chunks of q_chunk = 128, and so does the port's under
    autograd; values and the gradients of x and every field."""
    S = 1152
    jcfg, tcfg, jp, tp, x, ct = attn_case(S, window)

    def jf(p, xx):
        return jnp.sum(ja.apply_full(p, xx, jcfg, window=window) * ct)

    jv, (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tv = torch.sum(ta.apply_full(tp, tx, tcfg, window=window) * torch.from_numpy(ct))
    tv.backward()
    assert abs(float(tv) - float(jv)) <= 1e-5 * abs(float(jv))
    assert rel(tx.grad.numpy(), np.asarray(jgx)) <= GRAD_REL
    for name in ta.AttnParams.FIELDS:
        got = tp._parameters[name].grad
        want = np.asarray(getattr(jgp, name))
        if not np.any(want):  # q_norm / k_norm: no qk-norm here
            assert got is None or not torch.any(got)
            continue
        assert rel(got.numpy(), want) <= GRAD_REL, name


def test_chunked_attention_equals_the_whole_score_matrix():
    """_sdpa_chunked's rows are _sdpa's under the same causal window."""
    _, tcfg = configs("gemma2-2b", d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
                      q_chunk=64)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 256, 4, 16, generator=g)
    k = torch.randn(2, 2, 256, 16, generator=g)
    v = torch.randn(2, 2, 256, 16, generator=g)
    for window in (0, 100):
        got = ta._sdpa_chunked(q, k, v, tcfg, window)
        want = ta._sdpa(q, k, v, ta.causal_mask(256, window), tcfg)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="query chunks"):
        ta._sdpa_chunked(q[:, :200], k[:, :, :200], v[:, :, :200], tcfg, 0)


def test_flash_attention_refuses_inputs_that_require_grad():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 32, 2, 16, generator=g)
    k = torch.randn(1, 32, 1, 16, generator=g)
    v = torch.randn(1, 32, 1, 16, generator=g)
    for arg in range(3):
        args = [t.clone() for t in (q, k, v)]
        args[arg].requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(*args)
        with pytest.raises(RuntimeError, match="no backward"):
            fa.flash_attention(*args)
        with torch.no_grad():  # autograd records nothing: the kernel route
            ops.flash_attention(*args)
    ops.flash_attention(q, k, v)


@pytest.mark.parametrize("causal", (True, False))
def test_apply_full_under_autograd_gives_the_plain_grads(causal):
    """Under autograd apply_full does not reach the kernel, and its
    output and gradients are the plain attention's (the kernel's plain
    version, differentiable, on the same projections); with frozen weights
    it keeps the kernel route."""
    _, tcfg, _, tp, x, ct = attn_case(64, 0)
    tx = torch.from_numpy(x).requires_grad_()
    got = ta.apply_full(tp, tx, tcfg, is_causal=causal)
    assert got.requires_grad
    (got * torch.from_numpy(ct)).sum().backward()
    gx, gp = tx.grad.clone(), {n: tp._parameters[n].grad.clone() for n in ("wq", "wk", "wv")}
    tx.grad = None
    for p in tp.parameters():
        p.grad = None

    h = ta.common.rms_norm(tx, tp.ln)
    q, k, v = ta._qkv(tp, h, torch.arange(64)[None], tcfg)
    out = fa.flash_attention_torch(q, k, v, causal=causal, softcap=tcfg.attn_softcap)
    (ta._out(tx, out, tp.wo) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), gx.numpy(), rtol=1e-4, atol=1e-5)
    for n, g in gp.items():
        assert rel(tp._parameters[n].grad.numpy(), g.numpy()) <= GRAD_REL, n

    frozen = ta.AttnParams(ta.shapes(tcfg), torch.float32, "cpu",
                           **{n: t.detach() for n, t in tp._parameters.items()})
    called = []
    real = ta.ops.flash_attention

    def spy(*a, **k):
        called.append(1)
        return real(*a, **k)

    ta.ops.flash_attention = spy
    try:
        ta.apply_full(frozen, torch.from_numpy(x), tcfg, is_causal=causal)
        ta.apply_full(tp, tx, tcfg, is_causal=causal)
    finally:
        ta.ops.flash_attention = real
    assert len(called) == 1  # the frozen weights' pass only


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_trainable_params_are_float32_masters_read_in_the_compute_dtype(dtype):
    _, tcfg = configs("deepseek-moe-16b", dtype=dtype)
    tree = weights.numpy_params(tcfg, 0)
    frozen = weights.from_jax_params(tree, tcfg, "cpu")
    train = weights.from_jax_params(tree, tcfg, "cpu", trainable=True)
    dt = getattr(torch, dtype)
    for (n, i, f), (_, _, t) in zip(weights.leaves(frozen), weights.leaves(train)):
        assert not f.requires_grad and t.requires_grad and t.dtype == torch.float32, n
    unit = train.main[0][1]  # a moe unit
    assert unit.we_i.dtype == dt and unit.router.dtype == torch.float32
    assert frozen.main[0][1].we_i is frozen.main[0][1]._parameters["we_i"]  # no copy
    back = weights.to_numpy_params(train, tcfg)
    same = jax.tree_util.tree_map(lambda a, b: np.array_equal(a, b), back, tree)
    assert all(jax.tree_util.tree_leaves(same))
    if dtype == "bfloat16":  # serving's weights hold the compute dtype, as before
        assert frozen.embed.dtype == dt and unit.we_i.requires_grad


def test_leaves_carry_the_jax_leaf_names():
    jcfg, tcfg = configs("recurrentgemma-9b", n_layers=4)  # one superblock + a trailing unit
    tree = weights.numpy_params(tcfg, 0)
    want = {jckpt._leaf_id(path): np.shape(v)
            for path, v in jax.tree_util.tree_flatten_with_path(to_jax(tree, jcfg))[0]}
    got = weights.stacked((n, i, t.detach().numpy())
                          for n, i, t in weights.leaves(
                              weights.from_jax_params(tree, tcfg, "cpu")))
    assert {k: v.shape for k, v in got.items()} == want
    assert f32(got["trailing.0.w_in"]).shape == tree["trailing"][0]["w_in"].shape
